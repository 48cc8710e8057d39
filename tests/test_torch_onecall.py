"""The ported one-call slice as a whole vs the JAX package on the CPU: the
same committed PP-OCRv5 checkpoints, the same pages, the same kwargs.

The recognition dictionary (ppocrv5_dict.txt) is not in the repository, so
both sides read a stand-in with 18383 unique placeholder entries (blank +
18383 + space = the head's 18385 classes); the trained-support sidecar is
found by the dictionary's file name. Both then decode the same strings from
the same indices. Tolerances are those of tests/test_onecall.py."""
import numpy as np
import pytest
import torch

from onnxocr_tpu import ONNXPaddleOcr as JaxOcr
from onnxocr_tpu.ops import resize_dev as jresize

from onnxocr_tpu_torch import ONNXPaddleOcr, config
from onnxocr_tpu_torch.utils.png import read_bgr

HELDOUT = config.ASSETS.parent / "test_images_heldout"
BASE = dict(use_angle_cls=False, drop_score=0.0, tpu_pipeline="onecall",
            tpu_warp_stage="off", det_limit_side_len=320)
# no trained classifier is committed: both sides run the seeded untrained one
CLS = dict(use_angle_cls=True, tpu_allow_untrained=True)
# its probabilities stay near 0.5, so no crop passes cls_thresh 0.9; with
# the "180" label first and the threshold at 0.5 the class it prefers
# turns crops, and the 180° homographies are really selected
CLS_FLIP = dict(label_list=["180", "0"], cls_thresh=0.5)
# the shear-staged crop warp, both packages' default (BASE pins the gather)
SHEAR = dict(tpu_warp_stage="shear")


@pytest.fixture(scope="module")
def dict_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("dict") / "ppocrv5_dict.txt"
    path.write_text("".join(f"<{i}>\n" for i in range(18383)))
    return str(path)


@pytest.fixture(scope="module")
def pages():
    return {n: read_bgr(str(HELDOUT / f"{n}.png"))
            for n in ("synth_00_doc", "synth_08_table")}


@pytest.fixture(scope="module")
def pair(dict_path):
    """(port on the CPU, JAX reference) built with the same kwargs, one
    pair per distinct kwargs for the module."""
    models = {}

    def get(**extra):
        key = tuple(sorted((k, str(v)) for k, v in extra.items()))
        if key not in models:
            kw = dict(BASE, rec_char_dict_path=dict_path, **extra)
            models[key] = (ONNXPaddleOcr(device="cpu", **kw), JaxOcr(**kw))
        return models[key]

    return get


def _assert_same(got, ref):
    assert [l[1][0] for l in got] == [l[1][0] for l in ref]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert np.abs(np.asarray(g[0], np.float64) -
                      np.asarray(r[0], np.float64)).max() <= 2.0
        assert abs(float(g[1][1]) - float(r[1][1])) < 2e-3


@pytest.mark.parametrize("page,extra", [
    ("synth_00_doc", {}),
    ("synth_08_table", {}),
    ("synth_00_doc", {"tpu_onecall_max_boxes": 4}),      # overflow path
    ("synth_08_table", {"tpu_onecall_rec_width": 160}),  # wide-line path
    ("synth_00_doc", {"tpu_db_reduce": "pallas"}),       # slot-keyed sums
    ("synth_08_table", {"tpu_db_reduce": "scatter",
                        "tpu_det_score_scale": "1x2",
                        "tpu_det_axis_snap": 0.06}),
    # the untrained angle classifier (same seeded weights on both sides);
    # CLS_FLIP makes its verdicts turn crops
    ("synth_00_doc", dict(CLS, tpu_db_reduce="pallas")),
    ("synth_08_table", dict(CLS, **CLS_FLIP)),
    ("synth_00_doc", dict(CLS, **CLS_FLIP, tpu_onecall_max_boxes=4,
                          tpu_onecall_rec_width=160)),   # fused remainders
    # the shear-staged warp on both sides, every crop of the slice (on
    # synth_00_doc in the step and in both remainders)
    ("synth_08_table", SHEAR),
    ("synth_00_doc", dict(SHEAR, tpu_onecall_max_boxes=4,
                          tpu_onecall_rec_width=160)),
    ("synth_08_table", dict(SHEAR, **CLS, **CLS_FLIP)),
    ("synth_00_doc", {"tpu_warp_interp": "bicubic"}),
])
def test_slice_matches_jax(pair, pages, page, extra):
    port, ref = pair(**extra)
    cls = bool(extra.get("use_angle_cls"))
    got = port.ocr(pages[page], cls=cls)[0]
    want = ref.ocr(pages[page], cls=cls)[0]
    assert len(want) > 4
    _assert_same(got, want)
    if "tpu_onecall_max_boxes" in extra:
        assert len(got) > extra["tpu_onecall_max_boxes"]
    if "tpu_onecall_rec_width" in extra:
        packed, _ = port._onecall.run_packed(pages[page])
        k = port._onecall.k_rec
        assert (packed[:k, 11] > 160).any()
    if "label_list" in extra:
        # the flipped verdicts changed what is read
        plain, _ = pair(**{k: v for k, v in extra.items()
                           if k not in CLS_FLIP})
        other = plain.ocr(pages[page], cls=True)[0]
        assert [l[1][0] for l in other] != [l[1][0] for l in got]
    form = port._fused.warp_form
    assert (form["staged"], form["interp"]) == (ref._fused.stage,
                                                ref._fused.interp)


# settings whose defaults the two packages do not share: the crop writer's
# directory, each package's own output directory
DEFAULT_EXCEPTIONS = {"crop_res_save_dir"}


def test_defaults_match_jax():
    """Every setting the port reads defaults to the JAX package's value,
    the pipeline included; the crop writer writes into the port's own
    package, as the JAX one writes into its own."""
    from pathlib import Path
    from onnxocr_tpu import config as jconfig
    assert config.DEFAULTS["tpu_pipeline"] == "staged"
    port_dir = Path(config.DEFAULTS["crop_res_save_dir"])
    jax_dir = Path(jconfig.DEFAULTS["crop_res_save_dir"])
    assert (port_dir.parent.name, port_dir.name) == ("onnxocr_tpu_torch",
                                                     jax_dir.name)
    assert port_dir.parent.parent == jax_dir.parent.parent
    for key, value in config.DEFAULTS.items():
        assert key in jconfig.DEFAULTS, key
        want = jconfig.DEFAULTS[key]
        if isinstance(value, (tuple, list)):
            value, want = tuple(value), tuple(want)
        if key not in DEFAULT_EXCEPTIONS:
            assert value == want, (key, value, want)


@pytest.fixture(scope="module")
def default_pair(dict_path):
    """(port on the CPU, JAX reference), each at its own defaults but the
    pipeline, set to one-call on both (the default staged pipeline is held
    in tests/test_torch_host_det.py)."""
    return (ONNXPaddleOcr(device="cpu", rec_char_dict_path=dict_path,
                          tpu_pipeline="onecall"),
            JaxOcr(rec_char_dict_path=dict_path, tpu_pipeline="onecall"))


@pytest.mark.parametrize("page", ["synth_00_doc", "synth_08_table"])
def test_defaults_slice_matches_jax(default_pair, pages, page):
    """ONNXPaddleOcr at each package's own defaults (the 960 det limit, the
    shear-staged bilinear warp, drop_score 0.5) on the one-call pipeline:
    the same texts, boxes and scores."""
    port, ref = default_pair
    assert port._fused.warp_form["staged"] == ref._fused.stage == "shear"
    got = port.ocr(pages[page])[0]
    want = ref.ocr(pages[page])[0]
    assert len(want) > 4
    _assert_same(got, want)


def test_blank_page(pair):
    port, ref = pair()
    blank = np.full((320, 320, 3), 250, np.uint8)
    assert port.ocr(blank, cls=False) == [[]]
    assert ref.ocr(blank, cls=False)[0] == []


def test_packed_buffer_matches_jax(pair, pages):
    """The single-page program's download: same n_valid, same argmax on
    every valid time step of every valid row."""
    port, ref = pair()
    img = pages["synth_00_doc"]
    oc = port._onecall
    packed, _ = oc.run_packed(img)
    src, h, w = jresize.pad_src_bucket(img)
    (rh, rw), (hb, wb), (eh, ew) = oc.canvas(h, w)
    jpacked = ref._onecall._run_single(False, src, h, w, rh, rw, hb, wb,
                                       eh, ew)
    assert packed.shape == jpacked.shape
    k = oc.k_rec
    assert packed[k, 0] == jpacked[k, 0] > 0
    np.testing.assert_array_equal(packed[:k, 9], jpacked[:k, 9])
    T = (packed.shape[1] - 12) // 2
    stride = oc.rec_w // T
    for row, jrow in zip(packed[:k], jpacked[:k]):
        if row[9] > 0.5:
            vt = min(T, -(-int(row[10]) // stride))
            np.testing.assert_array_equal(row[12:12 + vt],
                                          jrow[12:12 + vt])


def test_tiny_image_is_not_ported(pair, pages):
    """A page with h + w < 64 skips the one-call program, as in the JAX
    package, and takes the host det input (the name is from before that
    input was ported): the same results as the JAX package's, a blank tiny
    page none."""
    port, ref = pair()
    assert port.ocr(np.full((20, 30, 3), 255, np.uint8), cls=False) == [[]]
    tiny = np.ascontiguousarray(pages["synth_00_doc"][37:65, 225:259])
    got = port.ocr(tiny, cls=False)[0]
    want = ref.ocr(tiny, cls=False)[0]
    assert len(want) >= 1
    _assert_same(got, want)


def test_default_device_is_cuda_and_never_falls_back(dict_path,
                                                     monkeypatch):
    import inspect
    sig = inspect.signature(ONNXPaddleOcr.__init__)
    assert sig.parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ONNXPaddleOcr(rec_char_dict_path=dict_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        ONNXPaddleOcr(device="cuda:0", rec_char_dict_path=dict_path)
    assert ONNXPaddleOcr(device="cpu",
                         rec_char_dict_path=dict_path).device.type == "cpu"


def test_unported_settings_raise(dict_path):
    """Nothing waits any more: the text panel of sav2Img draws (an 8 px
    page resized to 600 beside one 600 px panel), save_crop_res builds and
    takes the host crops, and the settings that waited for the host image
    operations and the wave coalescer build."""
    from onnxocr_tpu_torch.utils.draw import draw_ocr
    shown = draw_ocr(np.zeros((8, 8, 3), np.uint8), [], txts=[])
    assert shown.shape == (600, 1200, 3)
    model = ONNXPaddleOcr(device="cpu", rec_char_dict_path=dict_path,
                          save_crop_res=True)
    assert model.route == "host_crops"
    model.close()
    for extra in ({"tpu_det_wire": "map", "tpu_det_input": "host"},
                  {"tpu_crop_backend": "host"},
                  {"tpu_pipeline": "onecall",
                   "tpu_onecall_fixed_canvas": False},
                  {"tpu_pipeline": "onecall", "tpu_onecall_wave": True},
                  {"tpu_det_microbatch": True, "tpu_det_wire": "map"}):
        model = ONNXPaddleOcr(device="cpu", rec_char_dict_path=dict_path,
                              **extra)
        model.close()


def test_classifier_needs_weights_or_the_opt_in(dict_path, tmp_path,
                                                monkeypatch):
    """No trained classifier is committed: use_angle_cls=True fails loudly
    as the reference does, runs untrained only under the explicit opt-in
    (kwarg or environment), and fails on an empty cls.onnx as the JAX
    package does (its lift and then its graph reader raise ValueError)."""
    kw = dict(device="cpu", rec_char_dict_path=dict_path, use_angle_cls=True)
    monkeypatch.delenv("ONNXOCR_TPU_ALLOW_UNTRAINED", raising=False)
    with pytest.raises(FileNotFoundError, match="tpu_allow_untrained"):
        ONNXPaddleOcr(**kw)
    with pytest.raises(FileNotFoundError, match="tpu_allow_untrained"):
        JaxOcr(**{k: v for k, v in kw.items() if k != "device"})
    with pytest.warns(UserWarning, match="randomly initialized"):
        port = ONNXPaddleOcr(tpu_allow_untrained=True, **kw)
    assert port.use_angle_cls and port._fused.idx180 == 1
    monkeypatch.setenv("ONNXOCR_TPU_ALLOW_UNTRAINED", "1")
    with pytest.warns(UserWarning, match="randomly initialized"):
        ONNXPaddleOcr(**kw)
    onnx = tmp_path / "cls.onnx"
    onnx.write_bytes(b"")
    with pytest.raises(ValueError, match="no graph in model"):
        ONNXPaddleOcr(cls_model_dir=str(onnx), **kw)
    with pytest.raises(ValueError, match="no graph in model"):
        JaxOcr(cls_model_dir=str(onnx),
               **{k: v for k, v in kw.items() if k != "device"})
    # a native checkpoint beside cls_model_dir is loaded without the opt-in
    monkeypatch.delenv("ONNXOCR_TPU_ALLOW_UNTRAINED")
    from onnxocr_tpu_torch.models import cls as cls_model
    from onnxocr_tpu_torch.models import convert
    flat = convert.flatten(cls_model.init_tree(5))
    np.savez(tmp_path / "native_params.npz", **flat)
    port = ONNXPaddleOcr(cls_model_dir=str(tmp_path / "absent.onnx"), **kw)
    w = port.text_classifier.forward.model.fc.weight.numpy()
    np.testing.assert_array_equal(w, flat["fc/w"].T)

"""The staged device-det path of the port as a whole vs the JAX package on
the CPU: det → device DB boxes (slot-keyed reductions) → host filter and
sort → fused cls + rec per width bucket, with the same committed PP-OCRv5
det / rec checkpoints, the same seeded untrained classifier, the same pages
and the same kwargs on both sides.

The recognition dictionary is not in the repository: both sides read the
stand-in of tests/test_torch_onecall.py. Off the TPU the JAX package takes
its scan lowering for tpu_db_reduce='pallas'; the port runs the plain
versions of its slot-keyed kernels. Tolerances are those of
tests/test_onecall.py: texts equal, boxes within 2 px, scores within 2e-3.
"""
import numpy as np
import pytest

from onnxocr_tpu import ONNXPaddleOcr as JaxOcr
from onnxocr_tpu.ops import resize_dev as jresize

from onnxocr_tpu_torch import ONNXPaddleOcr, config
from onnxocr_tpu_torch.ops import resize_dev
from onnxocr_tpu_torch.pipeline import system
from onnxocr_tpu_torch.utils.png import read_bgr

HELDOUT = config.ASSETS.parent / "test_images_heldout"
BASE = dict(tpu_pipeline="staged", tpu_det_postprocess="device",
            tpu_db_reduce="pallas", use_angle_cls=True,
            tpu_allow_untrained=True, tpu_warp_stage="off",
            det_limit_side_len=320, drop_score=0.0)
# the untrained classifier's probabilities stay near 0.5; with the "180"
# label first and the threshold at 0.5 its preferred class turns crops
FLIP = dict(label_list=["180", "0"], cls_thresh=0.5)


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
    models = {}

    def get(**extra):
        key = tuple(sorted((k, str(v)) for k, v in extra.items()))
        if key not in models:
            kw = dict(BASE, rec_char_dict_path=dict_path, **extra)
            with pytest.warns(UserWarning, match="randomly initialized"):
                models[key] = (ONNXPaddleOcr(device="cpu", **kw),
                               JaxOcr(**kw))
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
    ("synth_08_table", FLIP),
    ("synth_00_doc", {"tpu_db_reduce": "pallas2"}),
    ("synth_00_doc", {"tpu_db_reduce": "scatter",
                      "tpu_det_score_scale": "1x2",
                      "tpu_det_axis_snap": 0.06}),
    ("synth_08_table", {"tpu_det_max_boxes": 128,
                        "tpu_rec_width_buckets": (160, 320),
                        "tpu_batch_buckets": (4,)}),    # several chunks
    ("synth_00_doc", dict(FLIP, tpu_fused_cls_rec=False)),  # cls, then rec
    # the shear-staged warp (both packages' default) on every crop
    ("synth_00_doc", dict(FLIP, tpu_warp_stage="shear")),
    ("synth_08_table", dict(FLIP, tpu_fused_cls_rec=False,
                            tpu_warp_stage="shear")),
])
def test_staged_device_matches_jax(pair, pages, page, extra):
    port, ref = pair(**extra)
    assert port._onecall is None and ref._onecall is None
    got = port.ocr(pages[page], cls=True)[0]
    want = ref.ocr(pages[page], cls=True)[0]
    assert len(want) > 4
    _assert_same(got, want)
    # the staged path hands out integer boxes, as the reference does
    assert all(isinstance(v, int) for v in got[0][0][0])


def test_cls_false_skips_the_classifier(pair, pages):
    port, ref = pair(**FLIP)
    img = pages["synth_00_doc"]
    got = port.ocr(img, cls=False)[0]
    _assert_same(got, ref.ocr(img, cls=False)[0])
    turned = port.ocr(img, cls=True)[0]
    assert [l[1][0] for l in turned] != [l[1][0] for l in got]


class _Spy:
    """Stands in for a FusedClsRec and keeps each call's packed buffer."""

    def __init__(self, fused):
        self._fused = fused
        self.packed = []

    def __getattr__(self, name):
        return getattr(self._fused, name)

    def __call__(self, *args, **kw):
        out = self._fused(*args, **kw)
        self.packed.append(np.asarray(out.cpu() if hasattr(out, "cpu")
                                      else out))
        return out


@pytest.mark.parametrize("extra", [{}, FLIP])
def test_turned_page_same_rot_verdicts(pair, pages, extra, monkeypatch):
    """A page turned by 180°: both sides download the same packed
    (N, 2T + 3) buffers — same argmax over each row's valid steps, cls
    probabilities within 1e-4 and the same rot verdict in the last column."""
    port, ref = pair(**extra)
    img = np.ascontiguousarray(pages["synth_00_doc"][::-1, ::-1])
    spies = []
    for model in (port, ref):
        spy = _Spy(model._fused)
        monkeypatch.setattr(model, "_fused", spy)
        spies.append(spy)
    got = port.ocr(img, cls=True)[0]
    want = ref.ocr(img, cls=True)[0]
    _assert_same(got, want)
    assert len(spies[0].packed) == len(spies[1].packed) >= 1
    n_rot = 0
    for a, b in zip(*(s.packed for s in spies)):
        assert a.shape == b.shape and (a.shape[1] - 3) % 2 == 0
        T = (a.shape[1] - 3) // 2
        np.testing.assert_array_equal(a[:, -1], b[:, -1])        # rot
        np.testing.assert_allclose(a[:, 2 * T:2 * T + 2],
                                   b[:, 2 * T:2 * T + 2], atol=1e-4)
        n_rot += int(a[:, -1].sum())
    if extra:
        assert n_rot > 0
    else:
        assert n_rot == 0      # near-0.5 probabilities never pass 0.9


def test_infer_boxes_device_matches_jax(pair, pages):
    """The det step alone: the same integer boxes in source coordinates
    (as corner sets: a component whose xy moment is 0 up to sum order may
    take its axis with either sign, which turns the corner order by 180°
    until the host filter reorders it), and the same boxes after the host
    filter and sort."""
    port, ref = pair()
    img = pages["synth_08_table"]
    padded, h, w = resize_dev.pad_src_bucket(img)
    image_dev, h2, w2 = resize_dev.put_src_bucket(img, port.device)
    assert (h, w) == (h2, w2)
    got = port.text_detector.infer_boxes_device(image_dev, h, w)
    jpadded, jh, jw = jresize.pad_src_bucket(img)
    want = ref.text_detector.infer_boxes_device(jpadded, jh, jw)
    assert got.dtype == np.int32 and got.shape == want.shape

    def corners(q):
        return np.stack([b[np.lexsort((b[:, 1], b[:, 0]))] for b in q])

    assert np.abs(corners(got) - corners(want)).max() <= 2
    a = system.sorted_boxes(port.text_detector.filter_tag_det_res(
        got, img.shape))
    b = ref.text_detector.filter_tag_det_res(want, img.shape)
    from onnxocr_tpu.pipeline.system import sorted_boxes as jsorted
    b = jsorted(b)
    assert len(a) == len(b) > 4
    assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 2


def test_classifier_run_boxes_matches_jax(pair, pages):
    port, ref = pair(**FLIP)
    img = pages["synth_00_doc"]
    image_dev, h, w = resize_dev.put_src_bucket(img, port.device)
    boxes = np.asarray(system.sorted_boxes(
        port.text_detector.filter_tag_det_res(
            port.text_detector.infer_boxes_device(image_dev, h, w),
            img.shape)), np.float32)
    rot, res = port.text_classifier.run_boxes(image_dev, boxes)
    jrot, jres = ref.text_classifier.run_boxes(
        jresize.pad_src_bucket(img)[0], boxes)
    np.testing.assert_array_equal(rot, jrot)
    assert rot.any()
    assert [r[0] for r in res] == [r[0] for r in jres]
    np.testing.assert_allclose([r[1] for r in res], [r[1] for r in jres],
                               atol=1e-4)


def test_blank_page_staged(pair):
    port, ref = pair()
    blank = np.full((320, 320, 3), 250, np.uint8)
    assert port.ocr(blank, cls=True) == [[]]
    assert ref.ocr(blank, cls=True)[0] == []

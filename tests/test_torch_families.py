"""The two other model families of the JAX package's registry in the port,
vs the JAX package on the CPU: ch_ppocr_server_v2.0 (ResNet18-vd DBNet,
CRNN with two BiLSTMs) and PP-OCRv4 (the mbv3 DBNet, SVTR with 2 mixer
blocks), from their committed checkpoints.

From the bottom up: the ResNet DBNet, the CRNN, its BiLSTM alone and the
v4 SVTR with the CTC head's plain version against the JAX models; every
leaf of the four trees loaded; the routing of crops to width buckets; the
weight resolution's fallbacks; and the slice, `ONNXPaddleOcr(device='cpu',
det_model_dir=..., rec_model_dir=..., rec_char_dict_path=...)` against the
JAX package's on the staged bitmap wire (C, the default), the staged
device-det path (A), the one-call path (B) and its multi-page step (W), C
behind both cross-request batchers from 3 threads (Q) and the host forms
(H). The dictionaries are
not in the repository: the server pair reads a stand-in of 6623 unique
entries named ppocr_keys_v1.txt (blank + 6623 + space = its head's 6625),
PP-OCRv4 the v5 stand-in, as the JAX registry pairs them. Slice
tolerances are those of tests/test_onecall.py: texts equal, boxes within
2 px, scores within 2e-3.
"""
import threading
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from onnxocr_tpu import ONNXPaddleOcr as JaxOcr
from onnxocr_tpu.models import crnn as jcrnn
from onnxocr_tpu.models import dbnet as jdbnet
from onnxocr_tpu.models import svtr as jsvtr
from onnxocr_tpu.ops.pallas import ctc_head as jctc
from onnxocr_tpu.pipeline import batching as jbatching
from onnxocr_tpu.utils.params_io import load_tree as jload_tree

from onnxocr_tpu_torch import ONNXPaddleOcr, config
from onnxocr_tpu_torch.models import convert
from onnxocr_tpu_torch.ops import resize_dev
from onnxocr_tpu_torch.ops.kernels import ctc_head
from onnxocr_tpu_torch.pipeline import backends, batching
from onnxocr_tpu_torch.utils.params_io import load_tree
from onnxocr_tpu_torch.utils.png import read_bgr

ASSETS = config.ASSETS
HELDOUT = ASSETS.parent / "test_images_heldout"
SERVER = dict(det_model_dir=str(ASSETS / "ch_ppocr_server_v2.0/det/det.onnx"),
              rec_model_dir=str(ASSETS / "ch_ppocr_server_v2.0/rec/rec.onnx"))
V4 = dict(det_model_dir=str(ASSETS / "ppocrv4/det/det.onnx"),
          rec_model_dir=str(ASSETS / "ppocrv4/rec/rec.onnx"))
STAGED_A = dict(tpu_pipeline="staged", tpu_det_postprocess="device",
                tpu_db_reduce="pallas")
ONECALL = dict(tpu_pipeline="onecall")
BATCHERS = dict(tpu_det_microbatch=True, tpu_rec_microbatch=True)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Test processes run side by side on the machine's cores: two torch
    threads keep this module from oversubscribing them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _tree(rel):
    return load_tree(str(ASSETS / rel / "native_params.npz"))


@pytest.fixture(scope="module")
def trees():
    return {k: _tree(k) for k in ("ch_ppocr_server_v2.0/det",
                                  "ch_ppocr_server_v2.0/rec",
                                  "ppocrv4/det", "ppocrv4/rec")}


# --------------------------------------------------------------- models
@pytest.mark.parametrize("hw,valid_hw", [((320, 320), None),
                                         ((320, 640), (256, 448))],
                         ids=["320x320", "320x640_valid_hw_ignored"])
def test_resnet_dbnet_matches_jax(trees, hw, valid_hw):
    """The server DBNet on its committed checkpoint. A valid_hw passes
    through both packages unused: the ResNet masks nothing."""
    tree = trees["ch_ppocr_server_v2.0/det"]
    x = np.random.default_rng(sum(hw)).normal(
        size=(1, *hw, 3)).astype(np.float32)
    jvalid = None if valid_hw is None else \
        tuple(jnp.asarray([v]) for v in valid_hw)
    ref = np.asarray(jax.jit(lambda p, x: jdbnet.apply(
        p, x, backbone_arch="resnet18", valid_hw=jvalid))(
            jload_tree(str(ASSETS / "ch_ppocr_server_v2.0/det/"
                           "native_params.npz")), x))
    model = convert.build_dbnet(tree, arch="resnet18")
    with torch.no_grad():
        got = model(_nchw(x), valid_hw).numpy()
        plain = model(_nchw(x)).numpy()
    assert got.shape == (1, *hw)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got, plain)
    assert 0.0 < got.mean() < 1.0


@pytest.mark.parametrize("shape", [(3, 48, 320, 3), (2, 48, 640, 3)],
                         ids=["3x320", "2x640"])
def test_crnn_matches_jax(trees, shape):
    """The server CRNN's logits on its committed checkpoint; the crops'
    right quarters are zero padding, as a bucket's are."""
    tree = trees["ch_ppocr_server_v2.0/rec"]
    x = np.random.default_rng(shape[2]).uniform(
        -1, 1, size=shape).astype(np.float32)
    x[1:, :, shape[2] * 3 // 4:] = 0.0
    ref = np.asarray(jax.jit(jcrnn.apply)(tree, x))
    model = convert.build_crnn(tree)
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    assert got.shape == (shape[0], shape[2] // 4, 6625) == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_bilstm_matches_jax():
    """One BiLSTM as the CRNN converts it (biases nonzero, so their place
    is checked) against crnn._bilstm: batch 3, rows zero-padded past their
    length, the reverse direction over the whole padded sequence."""
    rng = np.random.default_rng(7)
    H, D, T = jcrnn._HIDDEN, 96, 24
    p = {"wi": rng.normal(0, 0.1, (2, 4 * H, D)).astype(np.float32),
         "wh": rng.normal(0, 0.1, (2, 4 * H, H)).astype(np.float32),
         "b": rng.normal(0, 0.5, (2, 4 * H)).astype(np.float32)}
    x = rng.normal(size=(3, T, D)).astype(np.float32)
    x[1, 17:] = 0.0
    x[2, 5:] = 0.0
    ref = np.asarray(jax.jit(jcrnn._bilstm)(x, p))
    lstm = torch.nn.LSTM(D, H, batch_first=True, bidirectional=True)
    lstm.load_state_dict({k: torch.from_numpy(v) for k, v in
                          convert._lstm_leaves(p).items()})
    with torch.no_grad():
        got = lstm(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_v4_svtr_and_head_match_jax(trees):
    """The v4 SVTR (2 mixer blocks, head 192 × 18385): features with a
    width mask, then the CTC head's plain version on the port's features
    against the Pallas head (interpret mode) on the JAX package's."""
    tree = trees["ppocrv4/rec"]
    assert len(tree["mixer"]) == 2 and tree["head"]["w"].shape == \
        (192, 18385)
    x = np.random.default_rng(4).uniform(
        -1, 1, size=(2, 48, 320, 3)).astype(np.float32)
    valid_t = np.array([40, 23], np.int32)
    ref_f = jax.jit(jsvtr.apply_features)(tree, x, jnp.asarray(valid_t))
    ref_idx, ref_prob = jctc.ctc_head_reduce_batched(
        ref_f, jnp.asarray(tree["head"]["w"]), jnp.asarray(tree["head"]["b"]),
        interpret=True)
    model = convert.build_svtr(tree)
    head = model.head
    with torch.no_grad():
        feats = model.features(_nchw(x), torch.from_numpy(valid_t))
        idx, prob = ctc_head.ctc_head_reduce_batched(feats, head.w_split,
                                                     head.b)
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref_f), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(prob.numpy(), np.asarray(ref_prob), rtol=0,
                               atol=1e-4)


# --------------------------------------------------------------- weights
@pytest.mark.parametrize("rel,build", [
    ("ch_ppocr_server_v2.0/det",
     lambda t: convert.build_dbnet(t, arch="resnet18")),
    ("ch_ppocr_server_v2.0/rec", convert.build_crnn),
    ("ppocrv4/det", convert.build_dbnet),
    ("ppocrv4/rec", convert.build_svtr),
], ids=["server_det", "server_rec", "v4_det", "v4_rec"])
def test_builds_load_every_leaf(trees, rel, build):
    """Every leaf of the committed tree lands in the model with its values,
    and every tensor of the model is filled (strict load; the CRNN's zero
    bias_hh aside, which the JAX LSTM does not have)."""
    tree = trees[rel]
    flat = convert.flatten(tree)
    model = build(tree)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    extra = {k for k in sd if k.endswith(("bias_hh_l0",
                                          "bias_hh_l0_reverse"))}
    assert all((sd[k] == 0).all() for k in extra)
    lstm = {k for k in flat if k.startswith("lstm")}
    assert len(sd) - len(extra) == len(flat) + len(lstm)
    for k, v in flat.items():
        if k.startswith("lstm"):
            name, leaf = k.split("/")
            torch_leaf = {"wi": "weight_ih_l0", "wh": "weight_hh_l0",
                          "b": "bias_ih_l0"}[leaf]
            for d, sfx in enumerate(("", "_reverse")):
                np.testing.assert_array_equal(
                    sd[f"{name}.{torch_leaf}{sfx}"], v[d].astype(np.float32))
    if rel.endswith("det"):
        assert model.arch == ("resnet18" if "server" in rel else "mbv3")


@pytest.mark.parametrize("desired", [
    [320, 321, 700, 960, 961, 1500, 3300, 640],
    [100, 2000, 640, 641, 1280, 1281],
])
def test_group_by_bucket_matches_jax(desired):
    ladder = (640, 960, 1280)
    assert batching.group_by_bucket(desired, ladder) == \
        jbatching.group_by_bucket(desired, ladder)


# ---------------------------------------------------- weight resolution
def _server_dirs(tmp_path):
    det = tmp_path / "my_server" / "det"
    det.mkdir(parents=True)
    return str(det / "det.onnx")


def test_server_det_without_checkpoint_takes_mbv3(tmp_path, dict_paths):
    """A `server` det directory with no npz: both packages warn and load
    the ppocrv5 mbv3 detector, its calibration sidecar with it."""
    det_dir = _server_dirs(tmp_path)
    kw = dict(det_model_dir=det_dir, rec_char_dict_path=dict_paths["v5"])
    with pytest.warns(UserWarning, match="falling back to the trained mbv3"):
        port = ONNXPaddleOcr(device="cpu", **kw)
    with pytest.warns(UserWarning, match="falling back to the trained mbv3"):
        ref = JaxOcr(**kw)
    assert port.text_detector.arch == ref.text_detector.forward.arch == "mbv3"
    fb = config.find_asset("ppocrv5/det/native_params.npz")
    tree, path, arch = backends.load_native_params("det", det_dir,
                                                   "resnet18")
    assert (path, arch) == (fb, "mbv3")
    assert port.args.det_db_box_thresh == ref.args.det_db_box_thresh


@pytest.mark.parametrize("kind,arch", [("det", "mbv3"), ("rec", "svtr")])
def test_missing_mobile_checkpoint_takes_v5(tmp_path, kind, arch):
    """An mbv3 / svtr stage without a checkpoint of its own loads the
    ppocrv5 family's, with a warning, as the JAX package does."""
    d = tmp_path / "ppocrv9" / kind
    d.mkdir(parents=True)
    with pytest.warns(UserWarning, match="ppocrv5 family checkpoint"):
        tree, path, got = backends.load_native_params(
            kind, str(d / f"{kind}.onnx"), arch)
    assert got == arch and path == config.find_asset(
        f"ppocrv5/{kind}/native_params.npz")


def test_missing_crnn_checkpoint_raises(tmp_path, monkeypatch):
    """No CRNN checkpoint: FileNotFoundError; under the opt-in the seeded
    untrained CRNN, with the JAX package's warning and its tree leaf for
    leaf."""
    monkeypatch.delenv("ONNXOCR_TPU_ALLOW_UNTRAINED", raising=False)
    d = tmp_path / "server" / "rec"
    d.mkdir(parents=True)
    path = str(d / "rec.onnx")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(FileNotFoundError):
            backends.load_native_params("rec", path, "crnn")
    with pytest.warns(UserWarning, match="randomly initialized"):
        tree, ckpt, arch = backends.load_native_params(
            "rec", path, "crnn", allow_untrained=True, vocab_size=6625)
    assert (ckpt, arch) == ("", "crnn")
    got, want = convert.flatten(tree), convert.flatten(jcrnn.init(0, 6625))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


# ------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def dict_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("dicts")
    server = d / "ppocr_keys_v1.txt"
    server.write_text("".join(f"<{i}>\n" for i in range(6623)))
    v5 = d / "ppocrv5_dict.txt"
    v5.write_text("".join(f"<{i}>\n" for i in range(18383)))
    return {"server": str(server), "v5": str(v5)}


@pytest.fixture(scope="module")
def pages():
    return {n: read_bgr(str(HELDOUT / f"{n}.png"))
            for n in ("synth_00_doc", "synth_08_table")}


@pytest.fixture(scope="module")
def pair(dict_paths):
    """(port on the CPU, JAX reference) of a family with the same kwargs,
    one pair per distinct kwargs for the module."""
    models = {}

    def get(family, **extra):
        key = (family,) + tuple(sorted((k, str(v)) for k, v in extra.items()))
        if key not in models:
            base = dict(SERVER, rec_char_dict_path=dict_paths["server"]) \
                if family == "server" else \
                dict(V4, rec_char_dict_path=dict_paths["v5"])
            kw = dict(base, **extra)
            models[key] = (ONNXPaddleOcr(device="cpu", **kw), JaxOcr(**kw))
        return models[key]

    yield get
    for port, ref in models.values():
        port.close()


def _assert_same(got, ref):
    assert [l[1][0] for l in got] == [l[1][0] for l in ref]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert np.abs(np.asarray(g[0], np.float64) -
                      np.asarray(r[0], np.float64)).max() <= 2.0
        assert abs(float(g[1][1]) - float(r[1][1])) < 2e-3


@pytest.mark.parametrize("family,extra,page,route", [
    ("server", {}, "synth_00_doc", "bitmap"),
    ("server", {}, "synth_08_table", "bitmap"),
    ("server", STAGED_A, "synth_00_doc", "device"),
    ("server", ONECALL, "synth_00_doc", "onecall"),
    ("v4", {}, "synth_00_doc", "bitmap"),
    ("v4", ONECALL, "synth_00_doc", "onecall"),
], ids=["server_C_doc", "server_C_table", "server_A", "server_B", "v4_C",
        "v4_B"])
def test_family_matches_jax(pair, pages, family, extra, page, route):
    """A family on one route of the JAX package, on a held-out page: the
    server pair on C (the defaults: the ResNet on the page's own det
    canvas, CRNN crops in their own width buckets), A and B (the fixed
    960² det canvas, the CRNN at the one-call rec width); PP-OCRv4 on C
    and B, on the SVTR branches with the fused head."""
    port, ref = pair(family, **extra)
    assert port.route == route
    det, rec = port.text_detector, port.text_recognizer
    server = family == "server"
    assert det.arch == ref.text_detector.forward.arch == \
        ("resnet18" if server else "mbv3")
    assert rec.forward.arch == ref.text_recognizer.forward.arch == \
        ("crnn" if server else "svtr")
    assert rec.forward.masks_width == ref.text_recognizer.forward.masks_width
    got = port.ocr(pages[page])[0]
    want = ref.ocr(pages[page])[0]
    assert len(want) > 4
    _assert_same(got, want)


def test_server_batchers_match_jax(pair, pages):
    """Q: the server pair behind both cross-request batchers, three pages
    from 3 threads. The det batcher keeps each page on its own bucket
    canvas (no fixed canvas for the ResNet, pages resized on the host) and
    every CRNN chunk runs alone at its own width. Each threaded result
    equals the same page run serially, and that the JAX package's batched
    model's."""
    port, ref = pair("server", **BATCHERS)
    assert port.text_detector._page_batcher.canvas is None
    assert ref.text_detector._page_batcher.canvas is None
    names = ["synth_00_doc", "synth_08_table", "synth_00_doc"]
    groups = []
    rb = port.text_recognizer._crop_batcher
    real = rb._run_group
    rb._run_group = lambda works: groups.append(
        [w.item["promote"] for w in works]) or real(works)
    try:
        serial = {n: port.ocr(pages[n])[0] for n in set(names)}
        out = [None] * len(names)

        def run(i):
            out[i] = port.ocr(pages[names[i]])[0]

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(names))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    finally:
        del rb._run_group
    assert groups and all(g == [False] for g in groups)
    for name, res in zip(names, out):
        assert res is not None
        _assert_same(res, serial[name])
    for name, res in serial.items():
        want = ref.ocr(pages[name])[0]
        assert len(want) > 4
        _assert_same(res, want)


def test_server_host_forms_match_jax(pair, pages):
    """H: the server pair with host crops (the host det input on the
    page's bucket canvas, crops cut on the host, the CRNN on the crop list
    with no width mask), the rec-only form on those crops, and a tiny page
    (h + w < 64, zero-padded by the host det input) at the defaults."""
    port, ref = pair("server", tpu_crop_backend="host")
    img = pages["synth_00_doc"]
    got = port.ocr(img)[0]
    want = ref.ocr(img)[0]
    assert len(want) > 4
    _assert_same(got, want)
    crops = [img[int(min(p[1] for p in l[0])):int(max(p[1] for p in l[0])),
                 int(min(p[0] for p in l[0])):int(max(p[0] for p in l[0]))]
             for l in want[:6]]
    got = port.ocr(crops, det=False)[0]
    want = ref.ocr(crops, det=False)[0]
    assert [r[0] for r in got] == [r[0] for r in want]
    assert np.abs(np.array([r[1] for r in got]) -
                  np.array([r[1] for r in want])).max() < 2e-3
    tiny = np.ascontiguousarray(img[100:128, 60:94])
    port_c, ref_c = pair("server")
    got, want = port_c.ocr(tiny)[0], ref_c.ocr(tiny)[0]
    assert len(got) == len(want)
    if want:
        _assert_same(got, want)


def test_server_wave_matches_jax(dict_paths, pages):
    """W: the server pair's multi-page one-call step (one ResNet forward
    over both pages' canvases, the DB extraction per page, one CRNN pass
    over both pages' crops at the one-call width, no width mask) against
    the JAX package's batch program on the same uploads, page by page: the
    same valid rows, quads within 1e-3 px, texts equal, scores within
    2e-3. Two 320 × 640 parts of the held-out pages, det limit 640."""
    kw = dict(SERVER, rec_char_dict_path=dict_paths["server"],
              det_limit_side_len=640, drop_score=0.0,
              tpu_pipeline="onecall", tpu_onecall_max_boxes=16)
    port, ref = ONNXPaddleOcr(device="cpu", **kw), JaxOcr(**kw)
    oc, joc = port._onecall, ref._onecall
    parts = [pages["synth_00_doc"][0:320, 0:640],
             pages["synth_08_table"][100:420, 100:740]]
    ups = [resize_dev.put_src_bucket(np.ascontiguousarray(p), "cpu")
           for p in parts]
    canv = [oc.canvas(h, w) for _, h, w in ups]
    (hb, wb), (eh, ew) = canv[0][1:]
    assert canv[1][1:] == canv[0][1:]
    images = torch.stack([u[0] for u in ups])
    sh, sw = [u[1] for u in ups], [u[2] for u in ups]
    rh, rw = [c[0][0] for c in canv], [c[0][1] for c in canv]
    out = oc.step_wave(images, sh, sw, rh, rw, hb, wb, eh, ew,
                       False).numpy()
    i32 = jnp.int32
    jout = np.asarray(joc._get_batched(False, 2, hb, wb, eh, ew)(
        *joc._params(False), jnp.asarray(images.numpy()), jnp.array(sh, i32),
        jnp.array(sw, i32), jnp.array(rh, i32), jnp.array(rw, i32)))
    assert out.shape == jout.shape
    k = oc.k_rec
    assert (out.shape[-1] - 12) // 2 == oc.rec_w // 4      # T = W/4
    for b in range(2):
        valid = out[b, :k, 9] > 0.5
        assert out[b, k, 0] == jout[b, k, 0] >= 4
        np.testing.assert_array_equal(valid, jout[b, :k, 9] > 0.5)
        np.testing.assert_allclose(out[b, :k, :8][valid],
                                   jout[b, :k, :8][valid], rtol=0, atol=1e-3)
        _, got = oc.decode_packed(out[b], images[b], False)
        _, want = joc._decode_packed(jout[b], None, False)
        assert [r[0] for r in got] == [r[0] for r in want]
        assert np.abs(np.array([r[1] for r in got]) -
                      np.array([r[1] for r in want])).max() < 2e-3

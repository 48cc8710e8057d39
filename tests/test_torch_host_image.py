"""The port's cv2-exact host image operations and the host forms of ocr() vs
cv2 and the JAX package on the CPU.

The numpy twins of utils/cv_ops.py against cv2 itself (importable here,
never in the port): cv2.resize INTER_LINEAR in the det resize of every
held-out page, on seeded shapes (tiny zero-padded pages, 2–4× upscales,
odd widths, one channel) and in resize_img's fx form; the host crops
(cv2.warpPerspective, bicubic, edge replicated) on two pages' boxes; the
classifier's and recognizer's crop resizes; cv2.rotate. The target is
cv2's pixels; a twin may differ by one quantum on at most 0.1 % of the
values, and the count is asserted and printed.

Then the forms of `ocr()` that take the host operations, port on the CPU
vs the JAX package, at the 320 det limit: det only, rec only and cls only
on crop lists, a tiny page (h + w < 64) at the defaults and behind both
batchers, tpu_det_input='host', tpu_crop_backend='host', and the det
batcher's maps wire, boxes mode and host batch input. Slice tolerances:
texts equal, boxes within 2 px, scores within 2e-3. The recognition
dictionary is a stand-in (tests/test_torch_host_det.py).
"""
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from onnxocr_tpu import ONNXPaddleOcr as JaxOcr
from onnxocr_tpu.ops import det_pre as jdet_pre
from onnxocr_tpu.pipeline.classifier import TextClassifier as JaxCls
from onnxocr_tpu.pipeline.recognizer import TextRecognizer as JaxRec
from onnxocr_tpu.utils import image as jimage

from onnxocr_tpu_torch import ONNXPaddleOcr, config
from onnxocr_tpu_torch.ops import det_pre
from onnxocr_tpu_torch.utils import cv_ops, image
from onnxocr_tpu_torch.utils.png import read_bgr

HELDOUT = config.ASSETS.parent / "test_images_heldout"
PAGE_NAMES = sorted(p.stem for p in HELDOUT.glob("*.png"))
SMALL = dict(det_limit_side_len=320, drop_score=0.0)
FLIP = dict(use_angle_cls=True, tpu_allow_untrained=True,
            label_list=["180", "0"], cls_thresh=0.5)
# a part of synth_00_doc with one word, h + w = 62 < 64
TINY = (slice(37, 65), slice(225, 259))
# one quantum on at most 0.1 % of the values
MAX_SHARE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Test processes run side by side on the machine's cores: two torch
    threads keep this module from oversubscribing them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _hold_pixels(got, want, what):
    """Equal pixels, or one quantum off on at most 0.1 % of them; the count
    is printed."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    n = int((diff > 0).sum())
    print(f"{what}: {n} of {diff.size} values differ, max {diff.max()}")
    assert diff.max() <= 1 and n <= MAX_SHARE * diff.size, (what, n)
    return n


# --------------------------------------------------------------- twins
@pytest.fixture(scope="module")
def pages():
    return {n: read_bgr(str(HELDOUT / f"{n}.png")) for n in PAGE_NAMES}


@pytest.mark.parametrize("name", PAGE_NAMES)
def test_det_resize_matches_cv2(pages, name):
    """The det input of every held-out page at the default limit (680 × 900
    → 672 × 896) and at 320: the port's prepare_det_input against the JAX
    package's (cv2), canvas and shape_info."""
    img = pages[name]
    for limit in (960, 320):
        got, info, rhw = det_pre.prepare_det_input(img, limit)
        want, jinfo, jrhw = jdet_pre.prepare_det_input(img, limit)
        assert rhw == jrhw
        np.testing.assert_array_equal(info, jinfo)
        _hold_pixels(got, want, f"{name} det input at {limit}")


def _seeded_cases():
    rng = np.random.default_rng(8)
    cases = []
    for i in range(24):
        kind = ("tiny", "up", "odd", "gray")[i % 4]
        if kind == "tiny":
            h, w = (int(v) for v in rng.integers(4, 30, 2))
            size = None
        elif kind == "up":
            h, w = (int(v) for v in rng.integers(6, 90, 2))
            f = float(rng.uniform(2.0, 4.0))
            size = (int(w * f) | 1, int(h * float(rng.uniform(2.0, 4.0))))
        else:
            h, w = (int(v) for v in rng.integers(20, 300, 2))
            size = (int(rng.integers(3, 400)) | 1, int(rng.integers(3, 200)))
        shape = (h, w) if kind == "gray" else (h, w, 3)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        cases.append((kind, img, size))
    return cases


SEEDED = _seeded_cases()


@pytest.mark.parametrize("case", range(len(SEEDED)),
                         ids=[f"{c[0]}{i}" for i, c in enumerate(SEEDED)])
def test_resize_matches_cv2_on_seeded_shapes(case):
    """cv2.resize INTER_LINEAR: tiny pages through the det input (zero pad
    to 32, then the resize), 2–4× upscales with odd widths, downscales to
    odd widths, one channel."""
    kind, img, size = SEEDED[case]
    if size is None:
        got, info, rhw = det_pre.prepare_det_input(img, 960)
        want, jinfo, jrhw = jdet_pre.prepare_det_input(img, 960)
        assert rhw == jrhw and img.shape[0] + img.shape[1] < 64
        np.testing.assert_array_equal(info, jinfo)
    else:
        got = cv_ops.resize_linear(img, size)
        want = cv2.resize(img, size)
    _hold_pixels(got, want, f"{kind} {img.shape} → {size}")


@pytest.mark.parametrize("shape,size", [((680, 900, 3), 600),
                                        ((37, 451, 3), 97),
                                        ((123, 45), 320)])
def test_resize_img_matches_jax(shape, size):
    """resize_img's fx form (the size from round(W · fx), the scale 1/fx)
    against the JAX package's (cv2)."""
    img = np.random.default_rng(shape[0]).integers(0, 256, shape, np.uint8)
    _hold_pixels(image.resize_img(img, size), jimage.resize_img(img, size),
                 f"resize_img {shape} to {size}")


def test_rotate_180_matches_cv2():
    img = np.random.default_rng(1).integers(0, 256, (7, 11, 3), np.uint8)
    for x in (img, img[..., 0]):
        np.testing.assert_array_equal(cv_ops.rotate_180(x), cv2.rotate(x, 1))


@pytest.fixture(scope="module")
def dict_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("dict") / "ppocrv5_dict.txt"
    path.write_text("".join(f"<{i}>\n" for i in range(18383)))
    return str(path)


@pytest.fixture(scope="module")
def pair(dict_path):
    """(port on the CPU, JAX reference) built with the same kwargs, one
    pair per distinct kwargs for the module; batcher threads stopped at
    the end."""
    models = {}

    def get(**extra):
        key = tuple(sorted((k, str(v)) for k, v in extra.items()))
        if key not in models:
            kw = dict(SMALL, rec_char_dict_path=dict_path, **extra)
            models[key] = (ONNXPaddleOcr(device="cpu", **kw), JaxOcr(**kw))
        return models[key]

    yield get
    for port, ref in models.values():
        port.close()
        for b in (ref.text_detector._page_batcher,
                  ref.text_recognizer._crop_batcher):
            if b is not None:
                b.close()


@pytest.fixture(scope="module")
def crops(pair, pages):
    """The host crops of two pages' det boxes, port and JAX package
    (cv2): each page's first 10 boxes and one tall quad (the first box's
    corners with x and y swapped about its corner, three times as high as
    wide), whose crop is taken through the 90° turn (h / w >= 1.5)."""
    _, ref = pair()
    out = []
    for name in ("synth_00_doc", "synth_08_table"):
        img = pages[name]
        boxes = [np.asarray(b, np.float32) for b in
                 ref.text_detector(img)][:10]
        assert len(boxes) >= 6
        b0 = boxes[0]
        corner = b0.min(0)
        tall = (b0 - corner)[[3, 0, 1, 2]][:, ::-1] * [1.0, 3.0] / \
            [3.0, 1.0] + corner
        for b in boxes + [tall.astype(np.float32)]:
            out.append((image.get_rotate_crop_image(img, b),
                        jimage.get_rotate_crop_image(img, b)))
    return out


def test_rotate_crops_match_cv2(crops):
    """get_rotate_crop_image (cv2.warpPerspective, bicubic, edge replicated,
    the int(max(norm)) sizes, np.rot90 at h / w >= 1.5) on two pages'
    boxes, the tall quads crossing the 90° turn."""
    n_off = total = 0
    for got, want in crops:
        assert got.shape == want.shape
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert diff.max() <= 1
        n_off += int((diff > 0).sum())
        total += diff.size
    print(f"host crops: {n_off} of {total} values differ by one")
    assert n_off <= MAX_SHARE * total
    # the tall quads' crops came back turned: wider than high
    for got, _ in (crops[10], crops[-1]):
        assert got.shape[1] > got.shape[0]


def test_crop_resizes_match_jax(crops):
    """The classifier's and the recognizer's resize of host crops (48 ×
    192; 48 × the bucket width, a gray crop too) against the JAX
    package's, in uint8 quanta of the normalized values."""
    from onnxocr_tpu_torch.pipeline.classifier import TextClassifier
    from onnxocr_tpu_torch.pipeline.recognizer import TextRecognizer
    cls_self = SimpleNamespace(cls_image_shape=(3, 48, 192))
    rec_self = SimpleNamespace(rec_image_shape=(3, 48, 320))
    n_off = total = 0
    for crop, _ in crops:
        gray = crop[..., 0].copy()
        (got, w), (want, jw) = (
            TextRecognizer.resize_norm_img(rec_self, gray, 640),
            JaxRec.resize_norm_img(rec_self, gray, 640))
        assert w == jw
        outs = [(got, want)]
        for c in (crop, np.ascontiguousarray(crop[:, ::-1])):
            (got, w), (want, jw) = (
                TextRecognizer.resize_norm_img(rec_self, c, 960),
                JaxRec.resize_norm_img(rec_self, c, 960))
            assert w == jw
            outs += [(got, want), (TextClassifier.resize_norm_img(
                cls_self, c), JaxCls.resize_norm_img(cls_self, c))]
        for got, want in outs:
            assert got.shape == want.shape
            q = np.rint(np.abs(got - want) * 127.5)
            assert q.max() <= 1
            n_off += int((q > 0).sum())
            total += q.size
    print(f"crop resizes: {n_off} of {total} values differ by one")
    assert n_off <= MAX_SHARE * total


def test_warp_crops_host_matches_jax(pair, pages):
    """warp_crops_host (tpu_crop_backend's crop form in the JAX package:
    cv2's bicubic warp of each crop matrix, normalized, zero past the valid
    width) on a page's rec and cls crop matrices, in uint8 quanta."""
    from onnxocr_tpu.ops import warp as jwarp
    from onnxocr_tpu_torch.ops import warp
    _, ref = pair()
    img = pages["synth_08_table"]
    boxes = np.asarray(ref.text_detector(img), np.float32)[:12]
    n_off = total = 0
    for out_h, out_w in ((48, 320), (48, 192)):
        mats, valid = zip(*(warp.build_crop_matrix(b, out_h, out_w)
                            for b in boxes))
        mats, valid = np.stack(mats), np.asarray(valid, np.int32)
        got = warp.warp_crops_host(img, mats, valid, out_h, out_w)
        want = jwarp.warp_crops_host(img, mats, valid, out_h, out_w)
        q = np.rint(np.abs(got - want) * 127.5)
        assert q.max() <= 1
        n_off += int((q > 0).sum())
        total += q.size
    print(f"warp_crops_host: {n_off} of {total} values differ by one")
    assert n_off <= MAX_SHARE * total


# -------------------------------------------------------- forms of ocr()
def _assert_same(got, ref):
    assert [l[1][0] for l in got] == [l[1][0] for l in ref]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert np.abs(np.asarray(g[0], np.float64) -
                      np.asarray(r[0], np.float64)).max() <= 2.0
        assert abs(float(g[1][1]) - float(r[1][1])) < 2e-3


def _form_crops(crops):
    """The port's host crops the crop-list forms read: five of each page's,
    its tall (turned) one among them."""
    return [c for c, _ in crops[6:11] + crops[17:]]


def test_det_only_matches_jax(pair, pages):
    """ocr(det=True, rec=False): the host det input's boxes, unfiltered by
    drop_score, in the reference's nesting."""
    port, ref = pair()
    img = pages["synth_00_doc"]
    got = port.ocr(img, rec=False, cls=False)
    want = ref.ocr(img, rec=False, cls=False)
    assert len(got) == 1 and len(got[0]) == len(want[0]) > 4
    assert np.abs(np.asarray(got[0], np.float64) -
                  np.asarray(want[0], np.float64)).max() <= 2.0


def test_rec_only_matches_jax(pair, crops):
    """ocr(crops, det=False) on a list of host crops and on one crop."""
    port, ref = pair()
    crop_list = _form_crops(crops)
    got = port.ocr(crop_list, det=False, cls=False)
    want = ref.ocr(crop_list, det=False, cls=False)
    assert len(got) == 1 and len(got[0]) == len(crop_list)
    assert [t for t, _ in got[0]] == [t for t, _ in want[0]]
    assert max(abs(a[1] - b[1]) for a, b in zip(got[0], want[0])) < 2e-3
    one = port.ocr(crop_list[0], det=False, cls=False)
    assert one[0][0][0] == got[0][0][0] == \
        ref.ocr(crop_list[0], det=False, cls=False)[0][0][0]
    # rec=False without the classifier: the reference's empty result
    assert port.ocr(crop_list, det=False, rec=False) == \
        ref.ocr(crop_list, det=False, rec=False) == []


def test_cls_forms_match_jax(pair, crops):
    """The cls-only form (labels and scores of the untrained classifier,
    its verdicts turning crops) and cls + rec on a crop list, where the
    turned crops are read turned."""
    port, ref = pair(**FLIP)
    crop_list = _form_crops(crops)
    got = port.ocr(crop_list, det=False, rec=False)
    want = ref.ocr(crop_list, det=False, rec=False)
    assert [l for l, _ in got[0]] == [l for l, _ in want[0]]
    assert max(abs(a[1] - b[1]) for a, b in zip(got[0], want[0])) < 2e-3
    assert any(l == "180" and s > 0.5 for l, s in got[0])
    got = port.ocr(list(crop_list), det=False)
    want = ref.ocr(list(crop_list), det=False)
    assert [t for t, _ in got[0]] == [t for t, _ in want[0]]
    plain = port.ocr(list(crop_list), det=False, cls=False)
    assert [t for t, _ in plain[0]] != [t for t, _ in got[0]]


CASES = {
    "det_input_host": dict(tpu_det_input="host", tpu_det_wire="map"),
    "crop_backend_host": dict(FLIP, tpu_crop_backend="host"),
    "batcher_maps_wire": dict(tpu_det_microbatch=True, tpu_det_wire="map"),
    "batcher_boxes_mode": dict(tpu_det_microbatch=True,
                               tpu_det_postprocess="device",
                               tpu_db_reduce="pallas"),
    "batcher_host_input": dict(tpu_det_microbatch=True,
                               tpu_rec_microbatch=True,
                               tpu_det_batch_input="host"),
}
ROUTES = {"det_input_host": "host", "crop_backend_host": "host_crops",
          "batcher_maps_wire": "map",
          "batcher_boxes_mode": "device", "batcher_host_input": "bitmap"}


@pytest.mark.parametrize("case", list(CASES))
def test_host_routes_match_jax(pair, pages, case, monkeypatch):
    """Each route that takes the host det resize or the host crops, on
    synth_08_table, port vs JAX: the texts, boxes and scores. The det
    batcher's modes run from the host resize (`_prepare`)."""
    port, ref = pair(**CASES[case])
    assert port.route == ROUTES[case]
    batcher = port.text_detector._page_batcher
    prepared = []
    if batcher is not None:
        monkeypatch.setattr(batcher, "_prepare", lambda img, f=batcher.
                            _prepare: prepared.append(1) or f(img))
    img = pages["synth_08_table"]
    cls = "use_angle_cls" in CASES[case]
    got = port.ocr(img, cls=cls)[0]
    want = ref.ocr(img, cls=cls)[0]
    assert len(want) > 4
    _assert_same(got, want)
    assert bool(prepared) == (batcher is not None)


@pytest.mark.parametrize("extra", [{}, CASES["batcher_host_input"]],
                         ids=["defaults", "both_batchers"])
def test_tiny_page_matches_jax(pair, pages, extra):
    """A page with h + w < 64 takes the host det input, zero-padded as the
    reference pads it, at the defaults (the bitmap wire's model) and
    behind both batchers (the det batcher's host submit_bits)."""
    port, ref = pair(**extra)
    img = np.ascontiguousarray(pages["synth_00_doc"][TINY])
    assert img.shape[0] + img.shape[1] < 64
    got = port.ocr(img, cls=False)[0]
    want = ref.ocr(img, cls=False)[0]
    assert len(want) >= 1
    _assert_same(got, want)
    assert port.ocr(img, rec=False, cls=False)[0] == \
        [np.asarray(b).tolist() for b in ref.text_detector(img)]

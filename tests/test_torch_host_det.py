"""The port's staged pipeline with the host DB postprocess — the default of
both packages — vs the JAX package on the CPU.

From the bottom up: the numpy geometry (1e-6), the port's build of the C++
host library against the JAX package's build of its own copy (contours,
min-area rects, offsets and box scores equal on seeded bitmaps and point
sets) and both against the numpy twins, the DB postprocess on seeded
synthetic maps (equal int boxes, scores at 1e-6; quad, poly, dilation, the
slow score, the score-deferred candidates), the bitmap wire's bitpacking
(exact) and device scorer (1e-5), and the slice: `ONNXPaddleOcr` with only
the stand-in dictionary passed on both sides, and the other staged routes
at the 320 det limit. Slice tolerances are those of tests/test_onecall.py:
texts equal, boxes within 2 px, scores within 2e-3.
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from onnxocr_tpu import ONNXPaddleOcr as JaxOcr
from onnxocr_tpu.ops import db_device as jdb_device
from onnxocr_tpu.ops import db_post as jdb_post
from onnxocr_tpu.ops import det_pre as jdet_pre
from onnxocr_tpu.ops import geometry as jgeometry
from onnxocr_tpu.ops import resize_dev as jresize
from onnxocr_tpu.pipeline.system import sorted_boxes as jsorted_boxes
from onnxocr_tpu.runtime import native as jnative
from onnxocr_tpu.utils.image import minarea_quad as jminarea_quad

from onnxocr_tpu_torch import ONNXPaddleOcr, config
from onnxocr_tpu_torch.ops import db_device, db_post, det_pre, geometry
from onnxocr_tpu_torch.ops import native
from onnxocr_tpu_torch.pipeline import system
from onnxocr_tpu_torch.utils.image import minarea_quad
from onnxocr_tpu_torch.utils.png import read_bgr

HELDOUT = config.ASSETS.parent / "test_images_heldout"
SMALL = dict(det_limit_side_len=320, drop_score=0.0)
# the untrained classifier (same seeded weights on both sides); its
# probabilities stay near 0.5, so with the "180" label first and the
# threshold at 0.5 its verdicts really turn crops
FLIP = dict(use_angle_cls=True, tpu_allow_untrained=True,
            label_list=["180", "0"], cls_thresh=0.5)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Test processes run side by side on the machine's cores: two torch
    threads keep this module from oversubscribing them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# --------------------------------------------------------------- inputs
def synth_map(seed, h=96, w=160, bars=7):
    """A seeded float32 shrink-prob map: tilted bars of text-like
    probability over a low background, and speckle above the threshold."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    m = rng.uniform(0.0, 0.25, (h, w))
    for _ in range(bars):
        cx, cy = rng.uniform(12, w - 12), rng.uniform(8, h - 8)
        length, thick = rng.uniform(8, 60), rng.uniform(3, 10)
        a = rng.uniform(-0.5, 0.5)
        u = (xx - cx) * math.cos(a) + (yy - cy) * math.sin(a)
        v = -(xx - cx) * math.sin(a) + (yy - cy) * math.cos(a)
        inside = (np.abs(u) < length / 2) & (np.abs(v) < thick / 2)
        peak = rng.uniform(0.45, 0.98)
        m = np.where(inside, np.maximum(m, peak * (1 - 0.4 * np.abs(v) /
                                                   thick)), m)
    m[rng.random((h, w)) < 0.01] = 0.5
    return m.astype(np.float32)


def synth_bitmap(seed, h=80, w=112):
    """Seeded 0/255 uint8 bitmaps: filled rectangles, holes, 1 px strokes
    and isolated pixels."""
    rng = np.random.default_rng(seed)
    bm = np.zeros((h, w), np.uint8)
    for _ in range(6):
        y, x = rng.integers(0, h - 4), rng.integers(0, w - 4)
        bm[y:y + rng.integers(2, 20), x:x + rng.integers(2, 30)] = 255
    for _ in range(3):
        y, x = rng.integers(2, h - 2), rng.integers(2, w - 2)
        bm[y:y + 3, x:x + 3] = 0
    bm[rng.integers(0, h), :] = 255
    bm[:, rng.integers(0, w)] = 255
    bm[rng.random((h, w)) < 0.01] = 255
    return bm


def point_sets(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(1, 24))
        pts = rng.uniform(0, 200, (k, 2))
        if i % 4 == 0:
            pts = np.round(pts)          # integer contours
        if i % 7 == 0:
            pts[:, 1] = pts[0, 1]        # collinear
        out.append(pts.astype(np.float32))
    return out


def quads(seed, n=30, h=96, w=160):
    """Seeded rotated quads (DB corner order), some past the map's edges."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c = rng.uniform([-10, -10], [w + 10, h + 10])
        hw, hh, a = rng.uniform(1, 40), rng.uniform(1, 12), rng.uniform(-1, 1)
        u = np.array([math.cos(a), math.sin(a)]) * hw
        v = np.array([-math.sin(a), math.cos(a)]) * hh
        out.append(np.stack([c - u - v, c + u - v, c + u + v, c - u + v]))
    return np.asarray(out, np.float32)


# ------------------------------------------------------------- geometry
def _polys(seed):
    rng = np.random.default_rng(seed)
    for k in (3, 4, 5, 8, 13):
        ang = np.sort(rng.uniform(0, 2 * math.pi, k))
        r = rng.uniform(5, 40, k)
        yield np.stack([50 + r * np.cos(ang), 40 + r * np.sin(ang)], -1)


GEOMETRY_CASES = {
    "polygon_area": lambda g, p: g.polygon_area(p),
    "polygon_perimeter": lambda g, p: g.polygon_perimeter(p),
    "convex_hull": lambda g, p: g.convex_hull(p),
    "min_area_rect": lambda g, p: np.hstack([np.ravel(v) for v in
                                             g.min_area_rect(p)]),
    "box_points": lambda g, p: g.box_points(g.min_area_rect(p)),
    "offset_polygon_round": lambda g, p: g.offset_polygon_round(p, 3.5),
    "unclip": lambda g, p: g.unclip(p, 1.5),
    "arc_length": lambda g, p: g.arc_length(p, closed=False),
    "approx_poly_dp": lambda g, p: g.approx_poly_dp(np.round(p), 2.0),
    "order_points_clockwise": lambda g, p: g.order_points_clockwise(
        np.vstack([p, p])[:4]),
    "fill_poly_mask": lambda g, p: g.fill_poly_mask(
        (90, 100), p.astype(np.int32)),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY_CASES))
def test_geometry_matches_jax(name):
    fn = GEOMETRY_CASES[name]
    n = 0
    for seed in range(4):
        for p in _polys(seed):
            np.testing.assert_allclose(fn(geometry, p), fn(jgeometry, p),
                                       rtol=1e-6, atol=1e-6)
            n += 1
    assert n == 20


def test_dilate2x2_matches_jax():
    for seed in range(3):
        bm = (synth_bitmap(seed) > 0).astype(np.uint8)
        np.testing.assert_array_equal(geometry.dilate2x2(bm),
                                      jgeometry.dilate2x2(bm))


# --------------------------------------------------------- host library
def test_host_library_builds_from_the_repo():
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith(
        "libocrhost-") and path.exists()
    assert native.lib() is native.lib()


@pytest.mark.parametrize("seed", range(4))
def test_contours_match_jax_library(seed):
    bm = synth_bitmap(seed)
    got = native.find_contours(bm)
    want = jnative.find_contours(bm)
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for min_sq, max_index in ((9.0, 1000), (0.0, 5), (30.0, 7)):
        got = native.find_contours_filtered(bm, min_sq, max_index)
        want = jnative.find_contours_filtered(bm, min_sq, max_index)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        # the prefilter keeps, in raster order, what the plain slice keeps
        plain = [c for c in native.find_contours(bm)[:max_index]
                 if float(np.ptp(c[:, 0])) * float(np.ptp(c[:, 1])) >=
                 min_sq]
        assert [c.tolist() for c in got] == [c.tolist() for c in plain]


def test_min_area_rect_and_offset_match_jax_library():
    for pts in point_sets(0):
        got = native.min_area_rect(pts)
        assert got == jnative.min_area_rect(pts)
        # the numpy twin: the same rectangle up to the library's float32
        ref = geometry.min_area_rect(pts)
        if got[1][0] * got[1][1] > 1.0:
            np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-3)
            assert abs(got[1][0] * got[1][1] - ref[1][0] * ref[1][1]) <= \
                1e-4 * ref[1][0] * ref[1][1]
    for p in _polys(5):
        got = native.offset_polygon(p, 4.25)
        np.testing.assert_array_equal(got, jnative.offset_polygon(p, 4.25))
        np.testing.assert_allclose(got, geometry.offset_polygon_round(
            p, 4.25), rtol=0, atol=1e-9)


def test_box_score_matches_jax_library():
    prob = synth_map(3)
    n = 0
    for q in quads(4):
        got = native.box_score(prob, q)
        assert got == jnative.box_score(prob, q)
        assert got == pytest.approx(db_post.box_score_plain(prob, q),
                                    abs=1e-6)
        n += got > 0
    assert n > 10


# ----------------------------------------------------- DB postprocess
@pytest.fixture(scope="module")
def maps():
    return [synth_map(seed) for seed in range(6)]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(box_type="poly"),
    dict(use_dilation=True),
    dict(score_mode="slow"),
    dict(box_thresh=0.3, unclip_ratio=2.0),
], ids=["quad", "poly", "dilation", "slow", "low_thresh"])
def test_db_postprocess_matches_jax(maps, kw):
    args = {**dict(thresh=0.3, box_thresh=0.6, max_candidates=1000,
                   unclip_ratio=1.5), **kw}
    port, ref = db_post.DBPostProcess(**args), jdb_post.DBPostProcess(**args)
    n = 0
    for pred in maps:
        shape = np.array([[300, 500, 96 / 300, 160 / 500]])
        got = port({"maps": pred[None, None]}, shape)[0]["points"]
        want = ref({"maps": pred[None, None]}, shape)[0]["points"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        bitmap = pred > 0.3
        if kw.get("use_dilation"):
            bitmap = geometry.dilate2x2(bitmap.astype(np.uint8))
        fn = "polygons_from_bitmap" if kw.get("box_type") == "poly" else \
            "boxes_from_bitmap"
        gb, gs = getattr(port, fn)(pred, bitmap, 500, 300)
        wb, ws = getattr(ref, fn)(pred, bitmap, 500, 300)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
        n += len(got)
    assert n >= 3


def test_candidates_from_bitmap_matches_jax(maps):
    port = db_post.DBPostProcess(thresh=0.3, box_thresh=0.6,
                                 unclip_ratio=1.5)
    ref = jdb_post.DBPostProcess(thresh=0.3, box_thresh=0.6,
                                 unclip_ratio=1.5)
    for pred in maps:
        bitmap = (pred > 0.3).astype(np.uint8)
        pre, boxes = port.candidates_from_bitmap(bitmap, 500, 300)
        jpre, jboxes = ref.candidates_from_bitmap(bitmap, 500, 300)
        assert pre.dtype == np.float32 and boxes.dtype == np.int32
        np.testing.assert_array_equal(pre, jpre)
        np.testing.assert_array_equal(boxes, jboxes)
        # scored and filtered, the candidates are the boxes of the
        # reference flow
        keep = [db_post.box_score_fast(pred, q) >= 0.6 for q in pre]
        want, _ = port.boxes_from_bitmap(pred, bitmap, 500, 300)
        np.testing.assert_array_equal(boxes[keep].reshape(-1, 4, 2),
                                      want.reshape(-1, 4, 2))


def test_minarea_quad_matches_jax():
    for pts in point_sets(1):
        if len(pts) >= 3:
            np.testing.assert_allclose(minarea_quad(pts), jminarea_quad(pts),
                                       rtol=0, atol=1e-5)


# ------------------------------------------------------- bitmap wire
def test_det_resize_target_matches_jax():
    rng = np.random.default_rng(0)
    for h, w in rng.integers(8, 2000, (30, 2)):
        for limit_type in ("max", "min", "resize_long"):
            for side in (320, 960.0):
                assert det_pre.det_resize_target(h, w, side, limit_type) == \
                    jdet_pre.det_resize_target(h, w, side, limit_type)
    with pytest.raises(ValueError):
        det_pre.det_resize_target(100, 100, 960, "square")


def test_bitpack_map_exact(maps):
    for i, pred in enumerate(maps):
        H, W = pred.shape
        vh, vw = H - 8 * i, W - 16 * i - 8
        got = det_pre.bitpack_map(torch.from_numpy(pred), vh, vw, 0.3)
        want = np.asarray(jdet_pre.bitpack_map(jnp.asarray(pred), vh, vw,
                                               jnp.float32(0.3)))
        assert got.dtype == torch.uint8 and got.shape == (H, W // 8)
        np.testing.assert_array_equal(got.numpy(), want)
        bm = det_pre.unpack_bitmap(got.numpy()[:vh, :-(-vw // 8)], vw)
        np.testing.assert_array_equal(bm, (pred[:vh, :vw] > 0.3))


def test_quad_mask_mean_matches_jax(maps):
    pred = maps[0]
    H, W = pred.shape
    q = quads(5, n=40)
    q[-4:] = 0.0                         # padding rows score 0
    for rh, rw in ((H, W), (H - 16, W - 40)):
        valid = (np.arange(H)[:, None] < rh) & (np.arange(W)[None, :] < rw)
        got = db_device.quad_mask_mean(torch.from_numpy(pred),
                                       torch.from_numpy(q),
                                       torch.from_numpy(valid))
        want = np.asarray(jdb_device._quad_mask_mean(
            jnp.asarray(pred), jnp.asarray(q), jnp.asarray(valid)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        assert (got.numpy()[-4:] == 0).all() and (got.numpy() > 0).sum() > 10


# ------------------------------------------------------------- the slice
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
            kw = dict(rec_char_dict_path=dict_path, **extra)
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


def _recording(fn, out: list):
    """`fn`, appending each return value to `out` on the way through."""
    def call(*a, **kw):
        ret = fn(*a, **kw)
        out.append(ret)
        return ret
    return call


@pytest.fixture(scope="module")
def default_runs(pair, pages):
    """Both pages through each package at its defaults, once: the results,
    and the scored passes' downloads and the det bitmaps and maps recorded
    on the way through."""
    port, ref = pair()
    runs = {}
    for name, img in pages.items():
        rec = {"scored": [], "jscored": [], "det": [], "jdet": []}
        hooks = [(port._fused, "call_scored", rec["scored"]),
                 (ref._fused, "call_scored", rec["jscored"]),
                 (port.text_detector, "bitmap_forward", rec["det"]),
                 (ref.text_detector.forward, "call_normalized_bits",
                  rec["jdet"])]
        for obj, attr, out in hooks:
            setattr(obj, attr, _recording(getattr(obj, attr), out))
        try:
            rec["got"] = port.ocr(img)[0]
            rec["want"] = ref.ocr(img)[0]
        finally:
            for obj, attr, _ in hooks:
                delattr(obj, attr)
        runs[name] = rec
    return runs


@pytest.mark.parametrize("page", ["synth_00_doc", "synth_08_table"])
def test_defaults_match_jax_defaults(pair, default_runs, page):
    """ONNXPaddleOcr with only the dictionary passed, on both sides: the
    bitmap wire, 960 det limit, shear-staged warp, drop_score 0.5. The
    texts, boxes and scores agree, and so do the box scores of the scored
    passes' downloads (within 1e-5; padding rows 0 on both sides)."""
    port, ref = pair()
    assert port.route == "bitmap" and ref._onecall is None
    assert port._fused.warp_form["staged"] == ref._fused.stage == "shear"
    run = default_runs[page]
    assert len(run["want"]) > 4
    _assert_same(run["got"], run["want"])
    assert len(run["scored"]) == len(run["jscored"]) >= 1
    for x, y in zip(run["scored"], run["jscored"]):
        x, y = x.cpu().numpy(), np.asarray(y)
        assert x.shape == y.shape
        T = (x.shape[1] - 1) // 2
        np.testing.assert_allclose(x[:, 2 * T], y[:, 2 * T], rtol=0,
                                   atol=1e-5)


def test_bitmaps_match_jax(pair, default_runs):
    """The DB bitmaps themselves, on both pages, as each det forward of the
    default runs produced them. A map that differs from the JAX package's
    by float rounding may flip a pixel whose probability lies within
    float32 rounding of det_db_thresh: every pixel that differs must be
    such a tie (|p − thresh| < 1e-5 in the JAX map); their count is
    reported."""
    thresh = pair()[0].text_detector.postprocess_op.thresh
    for run in default_runs.values():
        (bits, prob, (rh, rw)), = run["det"]
        (jbits, jprob), = run["jdet"]
        assert bits.shape == np.asarray(jbits).shape
        got = det_pre.unpack_bitmap(bits.numpy()[:rh, :rw // 8], rw)
        want = det_pre.unpack_bitmap(np.asarray(jbits)[:rh, :rw // 8], rw)
        diff = got != want
        print(f"bitmap {rh}x{rw}: {int(diff.sum())} of {diff.size} pixels "
              f"differ, {int(want.sum())} set")
        jp = np.asarray(jprob)[:rh, :rw]
        assert (np.abs(jp[diff] - thresh) < 1e-5).all()
        assert diff.sum() <= 1e-4 * diff.size
        np.testing.assert_allclose(prob.numpy()[:rh, :rw], jp, rtol=0,
                                   atol=1e-4)


OVERFLOW = dict(tpu_batch_buckets=(2,))     # > 4 × 2 candidates


@pytest.mark.parametrize("extra,route", [
    (dict(tpu_det_wire="map", det_db_score_mode="slow",
          tpu_fused_cls_rec=False, det_image_shape=(256, 352)), "map"),
    (dict(FLIP, use_dilation=True, tpu_det_fixed_canvas="always"),
     "bitmap"),
    (OVERFLOW, "bitmap"),
], ids=["map_slow_unfused_image_shape", "cls_flip_dilation_fixed_canvas",
        "overflow"])
def test_staged_routes_match_jax(pair, pages, extra, route, monkeypatch):
    """The other staged routes at the 320 det limit, on synth_00_doc: the
    map route (uint8 wire, host scores) with the slow score, cls and rec
    unfused and a fixed det resize (det_image_shape); the bitmap wire with
    dilation, the fixed square det canvas and the classifier turning crops;
    and the bitmap wire's overflow branch (more candidates than 4 × the top
    batch size of 2: the map comes down, the host scores). The fused map
    route is test_poly_boxes_match_jax's."""
    port, ref = pair(**SMALL, **extra)
    assert port.route == route and ref._onecall is None
    img = pages["synth_00_doc"]
    cls = bool(extra.get("use_angle_cls"))
    scored = []
    monkeypatch.setattr(port.text_recognizer, "run_candidates_scored",
                        _recording(port.text_recognizer.run_candidates_scored,
                                   scored))
    got = port.ocr(img, cls=cls)[0]
    want = ref.ocr(img, cls=cls)[0]
    assert len(want) > 4
    _assert_same(got, want)
    assert (len(scored) > 0) == (route == "bitmap" and extra is not OVERFLOW)
    if "label_list" in extra:
        # the turned crops read differently from the upright ones
        plain = port.ocr(img, cls=False)[0]
        assert [l[1][0] for l in plain] != [l[1][0] for l in got]


def test_poly_boxes_match_jax(pair, pages):
    """det_box_type='poly' takes the map route and crops through each
    polygon's min-area quad. The JAX package's route stacks the ragged
    polygons with np.array, which numpy ≥ 1.24 refuses, so its pieces are
    composed here as its route composes them, with a list in place of the
    array."""
    port, ref = pair(**SMALL, det_box_type="poly")
    assert port.route == "map"
    img = pages["synth_00_doc"]
    got = port.ocr(img, cls=False)[0]
    jdet = ref.text_detector
    src, h, w = jresize.pad_src_bucket(img)
    prob, info = jdet.infer_prob_map_device(src, h, w)
    polys = jdet.postprocess_op({"maps": prob[None, None]},
                                info[None])[0]["points"]
    polys = jsorted_boxes([jdet.clip_det_res(np.array(p), h, w)
                           for p in polys])
    crop = np.stack([jminarea_quad(np.asarray(p)) for p in polys])
    res = ref.text_recognizer.run_boxes_fused(
        src, crop.astype(np.float32), ref._fused,
        (ref._fused.cls_h, ref._fused.cls_w), use_cls=False)
    want = [[np.asarray(p).tolist(), r] for p, r in zip(polys, res)]
    assert len(want) > 4 and len({len(p) for p, _ in want}) > 1
    assert [l[1][0] for l in got] == [l[1][0] for l in want]
    for g, r in zip(got, want):
        assert np.asarray(g[0]).shape == np.asarray(r[0]).shape
        assert np.abs(np.asarray(g[0]) - np.asarray(r[0])).max() <= 2.0
        assert abs(g[1][1] - r[1][1]) < 2e-3


def test_blank_page_host_det(pair):
    port, ref = pair(**SMALL, **OVERFLOW)
    blank = np.full((320, 320, 3), 250, np.uint8)
    assert port.ocr(blank, cls=False) == [[]]
    assert ref.ocr(blank, cls=False)[0] == []


def test_routes_follow_the_jax_conditions(dict_path):
    """One-call only under the JAX package's conditions, else the staged
    routes in its order; host crops before all of them; the host det input
    builds."""
    def route(**kw):
        return system.route_of(SimpleNamespace(**dict(config.DEFAULTS, **kw)))

    assert route() == "bitmap"
    assert route(tpu_pipeline="onecall") == "onecall"
    assert route(tpu_pipeline="onecall", use_dilation=True) == "bitmap"
    assert route(tpu_pipeline="onecall", det_box_type="poly") == "map"
    assert route(tpu_pipeline="onecall", det_limit_type="min") == "map"
    assert route(tpu_det_postprocess="device") == "device"
    assert route(tpu_det_postprocess="device",
                 det_image_shape=(320, 320)) == "map"
    assert route(tpu_fused_cls_rec=False) == "map"
    assert route(tpu_det_wire="map", tpu_det_input="host") == "host"
    assert route(tpu_crop_backend="host", tpu_pipeline="onecall") == \
        "host_crops"
    assert ONNXPaddleOcr(device="cpu", rec_char_dict_path=dict_path,
                         tpu_det_wire="map",
                         tpu_det_input="host").route == "host"

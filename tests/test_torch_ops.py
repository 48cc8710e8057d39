"""PyTorch port ops vs the JAX reference on the CPU: det input resize, crop
matrices and the gather warp, the labelling scans and device DB box
extraction. Inputs are made with numpy from a seed and fed to both."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from onnxocr_tpu.ops import db_device as jdb
from onnxocr_tpu.ops import det_pre as jdet_pre
from onnxocr_tpu.ops import resize_dev as jresize
from onnxocr_tpu.ops import warp as jwarp
from onnxocr_tpu.ops import warp_dev as jwarp_dev

from onnxocr_tpu_torch import config
from onnxocr_tpu_torch.ops import db_device, det_pre, resize_dev, warp, \
    warp_dev
from onnxocr_tpu_torch.utils.png import read_bgr

PAGE = str(config.ASSETS.parent / "test_images_heldout" / "synth_00_doc.png")


@pytest.mark.parametrize("h,w,limit", [(680, 900, 960), (680, 900, 320),
                                       (2000, 300, 960), (20, 45, 960),
                                       (1000, 1000, 960)])
def test_det_resize_target_matches(h, w, limit):
    assert det_pre.det_resize_target(h, w, limit) == \
        jdet_pre.det_resize_target(h, w, limit)


def test_resize_normalize_det_matches():
    """700×500 page into a 960² canvas. Rounding to uint8 happens before
    normalizing, so an element may differ by one uint8 quantum (≤ 0.1% of
    them); all others agree to 1e-5."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(700, 500, 3), dtype=np.uint8)
    padded, h, w = resize_dev.pad_src_bucket(img)
    jpadded, jh, jw = jresize.pad_src_bucket(img)
    np.testing.assert_array_equal(padded, jpadded)
    rh, rw = 672, 480
    ref = np.asarray(jresize.resize_normalize_det(
        jnp.asarray(padded), jnp.int32(h), jnp.int32(w), jnp.int32(rh),
        jnp.int32(rw), 960, 960))
    got = resize_dev.resize_normalize_det(torch.from_numpy(padded), h, w,
                                          rh, rw, 960, 960).numpy()
    diff = np.abs(got - ref)
    quantum = 1.0 / 255.0 / 0.224 + 1e-5
    off = diff > 1e-5
    assert off.mean() <= 1e-3
    assert diff[off].max(initial=0.0) <= quantum
    assert (got[rh:] == 0).all() and (got[:, rw:] == 0).all()


def _quads(rng, n):
    """Random convex-ish text quads (some tall, some tilted, some tiny)."""
    out = []
    for _ in range(n):
        cx, cy = rng.uniform(20, 600), rng.uniform(20, 400)
        w, h = rng.uniform(2, 200), rng.uniform(2, 60)
        if rng.random() < 0.2:
            w, h = h, w
        a = rng.uniform(-0.3, 0.3)
        c, s = np.cos(a), np.sin(a)
        pts = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
        pts = pts @ np.array([[c, s], [-s, c]]) + [cx, cy]
        pts += rng.normal(0, 0.7, size=pts.shape)
        out.append(pts)
    return np.round(np.asarray(out, np.float32))


def test_order_clip_filter_match():
    rng = np.random.default_rng(1)
    q = _quads(rng, 64)[:, rng.permutation(4)]
    ref = np.asarray(jwarp_dev.order_points_clockwise(jnp.asarray(q)))
    got = warp_dev.order_points_clockwise(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, ref)
    rq, rk = jwarp_dev.clip_filter_boxes(jnp.asarray(ref), jnp.int32(380),
                                         jnp.int32(560))
    gq, gk = warp_dev.clip_filter_boxes(torch.from_numpy(got), 380, 560)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))


def test_crop_matrices_and_warp_crops_match():
    rng = np.random.default_rng(2)
    q = _quads(rng, 24)
    q = np.asarray(jwarp_dev.order_points_clockwise(jnp.asarray(q)))
    valid = rng.random(24) < 0.85
    ref = jwarp_dev.crop_matrices(jnp.asarray(q), jnp.asarray(valid), 48,
                                  320)
    got = warp_dev.crop_matrices(torch.from_numpy(q),
                                 torch.from_numpy(valid), 48, 320)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-3)
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # the host matrix (ops/warp.py) agrees with the device one
    for i in np.nonzero(valid)[0][:4]:
        m, vw = warp.build_crop_matrix(q[i], 48, 320)
        jm, jvw = jwarp.build_crop_matrix(q[i], 48, 320)
        np.testing.assert_array_equal(m, jm)
        assert vw == jvw == int(got[2][i])

    img = resize_dev.pad_src_bucket(read_bgr(PAGE))[0]
    mats = np.asarray(ref[0])
    vw = np.where(valid, np.asarray(ref[2]), 0).astype(np.int32)
    rc = np.asarray(jwarp.warp_crops(jnp.asarray(img), jnp.asarray(mats),
                                     jnp.asarray(vw), 48, 320, "bilinear",
                                     False))
    gc = warp.warp_crops(torch.from_numpy(img), torch.from_numpy(mats),
                         torch.from_numpy(vw), 48, 320).numpy()
    np.testing.assert_allclose(gc, rc, atol=1e-4)


def _rot_box(cx, cy, cw, ch, angle_deg):
    th = np.deg2rad(angle_deg)
    ct, st = np.cos(th), np.sin(th)
    box = np.array([[-cw / 2, -ch / 2], [cw / 2, -ch / 2],
                    [cw / 2, ch / 2], [-cw / 2, ch / 2]], np.float64)
    return box @ np.array([[ct, st], [-st, ct]]) + [cx, cy]


# the quads of tests/test_warp.py: upright, small tilts, steep, rot90-composed,
# rounding-deformed (bowed) and integer-parallelogram; the last row of every
# batch is an identity with a valid width of 0
_JIT = np.array([[0.5, 0.5], [0, 0], [0, 0], [0, -0.5]])
WARP_QUADS = {
    "upright_a": [[10, 12], [210, 12], [210, 60], [10, 60]],
    "upright_b": [[40, 80], [360, 80], [360, 118], [40, 118]],
    "tilt_1.2": _rot_box(160, 60, 200, 24, 1.2),
    "tilt_-2.4": _rot_box(200, 120, 260, 30, -2.4),
    "tilt_3.0": _rot_box(120, 90, 90, 14, 3.0),
    "steep_25": _rot_box(160, 100, 180, 30, 25.0),
    "steep_-30": _rot_box(260, 320, 150, 22, -30.0),
    "rot90": [[150, 20], [190, 20], [190, 170], [150, 170]],
    "bowed_a": np.round(_rot_box(160, 60, 200, 24, 1.0)) + _JIT,
    "bowed_b": np.round(_rot_box(200, 120, 260, 30, -1.7)) + _JIT,
    "int_parallelogram": np.round(_rot_box(160, 60, 200, 24, 1.0)),
}
# which of them the shear form takes (the JAX package's tests/test_warp.py)
SHEAR_ELIGIBLE = ("upright_a", "upright_b", "tilt_1.2", "tilt_-2.4",
                  "tilt_3.0", "int_parallelogram")


@pytest.fixture(scope="module")
def warp_image():
    """The seeded 400 × 600 image of tests/test_warp.py."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:400, 0:600]
    smooth = np.stack([xx % 256, yy % 256, (xx + yy) // 4 % 256], -1)
    noise = rng.integers(0, 30, smooth.shape)
    return np.clip(smooth + noise, 0, 255).astype(np.uint8)


def _warp_batch(out_h, out_w, names=tuple(WARP_QUADS)):
    mats, widths = [], []
    for name in names:
        m, vw = jwarp.build_crop_matrix(
            np.asarray(WARP_QUADS[name], np.float32), out_h, out_w)
        mats.append(m)
        widths.append(vw)
    mats.append(np.eye(3, dtype=np.float32))
    widths.append(0)
    return np.stack(mats).astype(np.float32), np.array(widths, np.int32)


def _both_warps(img, mats, vw, out_h, out_w, interp, staged, slow_k=16):
    """(the port's crops, the JAX package's at `slow_k`)."""
    ref = np.asarray(jwarp.warp_crops(
        jnp.asarray(img), jnp.asarray(mats), jnp.asarray(vw), out_h, out_w,
        interp, staged, 0.35, slow_k))
    got = warp.warp_crops(torch.from_numpy(img), torch.from_numpy(mats),
                          torch.from_numpy(vw), out_h, out_w, interp, staged,
                          0.35).numpy()
    return got, ref


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
@pytest.mark.parametrize("staged", [False, True, "shear"])
@pytest.mark.parametrize("shape", [(48, 320), (48, 192)])
def test_warp_forms_match_jax(warp_image, shape, staged, interp):
    """Every warp form (gather, upright, shear) × interpolation on the rec
    and cls crop shapes vs the JAX package: within 1e-4 in normalized units
    (a 255-level step is 2.0). The float32 homography puts a sample up to
    ~1e-4 px off the JAX package's; the largest difference measured on these
    crops is 8.8e-5."""
    got, ref = _both_warps(warp_image, *_warp_batch(*shape), *shape, interp,
                           staged)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert (got[-1] == 0).all()


@pytest.mark.parametrize("shape", [(48, 320), (48, 192)])
def test_shear_affine_matches_jax(shape):
    """The LS affine's six coefficients within rtol 1e-6 and the shear
    eligibility exactly the JAX package's, which is what test_warp.py
    expects of each quad."""
    mats, vw = _warp_batch(*shape)
    ref = jwarp._shear_affine(jnp.asarray(mats), jnp.asarray(vw), shape[0])
    got = warp._shear_affine(torch.from_numpy(mats), torch.from_numpy(vw),
                             shape[0])
    for g, r in zip(got[:6], ref[:6]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=0)
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(ref[6]))
    want = [name in SHEAR_ELIGIBLE for name in WARP_QUADS]
    assert list(got[6].numpy()[:-1]) == want


@pytest.mark.parametrize("names,slow_k", [
    (tuple(WARP_QUADS), 0),        # the JAX package gathers every crop
    (tuple(WARP_QUADS), 2),        # 5 ineligible > slow_k: every crop
    (tuple(WARP_QUADS), 4),
    (tuple(WARP_QUADS), 8),        # the 5 ineligible crops, compacted
    (tuple(WARP_QUADS), 16),       # slow_k >= K: every crop
    (SHEAR_ELIGIBLE, 4),           # nothing to gather
])
def test_shear_tiers_give_the_same_crops(warp_image, names, slow_k):
    """The JAX package's three tiers of the shear form (nothing gathered,
    the ineligible crops compacted into slow_k static slots, every crop
    gathered) all give the port's one form, which gathers every crop and
    keeps the shear form's crop where it may: within 1e-4. The port stores
    tpu_warp_slow_k and warps the same at every value."""
    mats, vw = _warp_batch(48, 320, names)
    got, ref = _both_warps(warp_image, mats, vw, 48, 320, "bilinear",
                           "shear", slow_k)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    args = config.make_params()
    form = warp.form_of(args)
    args.tpu_warp_slow_k = slow_k
    assert warp.form_of(args) == form


@pytest.fixture(scope="module")
def page_rec_crops(tmp_path_factory):
    """Path B (one-call) at the port's other defaults on synth_00_doc: the
    uploaded page and the (K_rec = 48) crop matrices and valid widths its
    rec warp gets."""
    from onnxocr_tpu_torch import ONNXPaddleOcr
    path = tmp_path_factory.mktemp("dict") / "ppocrv5_dict.txt"
    path.write_text("".join(f"<{i}>\n" for i in range(18383)))
    ocr = ONNXPaddleOcr(device="cpu", rec_char_dict_path=str(path),
                        tpu_pipeline="onecall")
    seen, real = [], warp.warp_crops
    warp.warp_crops = lambda *a, **kw: seen.append((a, kw)) or real(*a, **kw)
    try:
        ocr.ocr(read_bgr(PAGE), cls=False)
    finally:
        warp.warp_crops = real
    ((image, mats, vw, out_h, out_w), form), = seen
    assert form["staged"] == "shear" and mats.shape[0] == 48
    return image.numpy(), mats.numpy(), vw.numpy(), out_h, out_w


def test_shear_on_page_quads_matches_jax(page_rec_crops):
    """Path B's 48 device quads of synth_00_doc (rounded to whole pixels,
    so some bow): the six coefficients within rtol 1e-6 and the eligibility
    exactly the JAX package's. The rec crops: XLA's fusion of the JAX
    package's shear passes rounds otherwise than the same code run op by op
    (measured: up to 1.16e-4 apart on this page, where the port is 2.4e-7
    from the op-by-op form); 969 of the 4,423,680 values are more than 1e-4
    from the jitted JAX crops, none more than 1.2e-4 (0.015 of a level);
    the test allows 0.05 % of them past 1e-4, none past 1.2e-4."""
    img, mats, vw, out_h, out_w = page_rec_crops
    ref = jwarp._shear_affine(jnp.asarray(mats), jnp.asarray(vw), out_h)
    got = warp._shear_affine(torch.from_numpy(mats), torch.from_numpy(vw),
                             out_h)
    live = vw > 0
    for g, r in zip(got[:6], ref[:6]):
        np.testing.assert_allclose(g.numpy()[live], np.asarray(r)[live],
                                   rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(ref[6]))
    assert got[6].numpy()[live].sum() >= 8
    gc, rc = _both_warps(img, mats, vw, out_h, out_w, "bilinear", "shear")
    diff = np.abs(gc - rc)
    assert diff.max() <= 1.2e-4 and (diff > 1e-4).mean() <= 5e-4


def test_stage_mode():
    def staged(setting):
        args = config.make_params()
        args.tpu_warp_stage = setting
        return warp.form_of(args)["staged"]

    assert [staged(s) for s in ("off", "", None, False)] == [False] * 4
    assert staged("shear") == "shear"
    assert staged(True) is True
    with pytest.raises(ValueError, match="tpu_warp_interp"):
        warp.warp_crops(torch.zeros((4, 4, 3), dtype=torch.uint8),
                        torch.eye(3)[None], torch.ones(1, dtype=torch.int32),
                        4, 4, "nearest")


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_segmented_scan_matches(axis, reverse):
    rng = np.random.default_rng(3)
    # labels are raster seeds: 0 <= label <= number of cells
    vals = rng.integers(0, 37 * 53 + 1, size=(37, 53)).astype(np.int32)
    resets = rng.random((37, 53)) < 0.2
    scan = jax.jit(lambda v, r: jdb._seg_scan(v, r, axis=axis,
                                              reverse=reverse))
    ref = np.asarray(scan(vals, resets))
    got = db_device._seg_scan(torch.from_numpy(vals),
                              torch.from_numpy(resets), axis, reverse)
    np.testing.assert_array_equal(got.numpy(), ref)


def _blocks(rng, H, W):
    prob = (rng.random((H, W)) * 0.25).astype(np.float32)
    prob[12:22, 10:70] = 0.85
    prob[40:52, 30:110] = 0.75
    prob[70:78, 5:40] = 0.9
    prob[60:64, 100:104] = 0.95       # too small after min_size
    return prob


def _staircase(rng, H, W):
    """Dashes (3 rows × 8 px) that touch only diagonally, corner to corner:
    no row or column run joins two of them, so the axis scans leave one
    label per dash and the 3×3 dilation to fixpoint has to join them."""
    prob = (rng.random((H, W)) * 0.2).astype(np.float32)
    for k in range(12):
        prob[10 + 3 * k:13 + 3 * k, 12 + 8 * k:20 + 8 * k] = 0.95
    return prob


def _spiral(rng, H, W):
    """One 2 px wide rectangular spiral, 6 px between turns: the 3 sweeps
    of axis scans carry a label around only the first turns, and the
    dilation that joins the rest runs into its 256-pool cap."""
    prob = (rng.random((H, W)) * 0.2).astype(np.float32)
    t, step = 2, 6
    y0, x0, y1, x1 = 8, 8, H - 12, W - 20
    first = True
    while y1 - y0 > 2 * step and x1 - x0 > 2 * step:
        prob[y0:y0 + t, x0 if first else x0 - step:x1] = 0.95   # top
        prob[y0:y1, x1 - t:x1] = 0.95                           # right
        prob[y1 - t:y1, x0:x1] = 0.95                           # bottom
        prob[y0 + step:y1, x0:x0 + t] = 0.95                    # left
        y0, x0, y1, x1 = y0 + step, x0 + step, y1 - step, x1 - step
        first = False
    return prob


@pytest.mark.parametrize("case", ["staircase", "spiral"])
def test_labelling_needs_dilation(case):
    prob = torch.from_numpy({"staircase": _staircase, "spiral": _spiral}[case](
        np.random.default_rng(4), 96, 128))
    mask = prob > 0.3
    ys, xs = np.mgrid[0:96, 0:128]
    seed = torch.where(mask, torch.from_numpy((ys * 128 + xs + 1)
                                              .astype(np.int32)), 0)
    flooded = db_device._flood_scans(seed, mask)
    closed = db_device._dilate_converge(flooded, mask)
    n_flooded = len(torch.unique(flooded[mask]))
    n_closed = len(torch.unique(closed[mask]))
    assert n_closed < n_flooded
    if case == "staircase":
        assert n_closed == 1


def _blobs(rng, H, W, n=180):
    prob = (rng.random((H, W)) * 0.2).astype(np.float32)
    for _ in range(n):
        y, x = rng.integers(0, H - 8), rng.integers(0, W - 20)
        prob[y:y + rng.integers(4, 8), x:x + rng.integers(8, 20)] = \
            rng.uniform(0.5, 1.0)
    return prob


@pytest.mark.parametrize("case,scale,max_k,score_k", [
    ("blocks", "1x2", 128, 128),
    ("blocks", "1x1", 128, 0),
    ("staircase", "1x2", 128, 128),
    ("spiral", "1x2", 128, 128),
    ("blobs", "1x2", 256, 16),     # survivors overflow score_k
    ("blobs", "1x2", 256, 128),    # survivors fit score_k
    ("blobs", "1x2", 32, 16),      # components overflow max_k
])
def test_device_boxes_matches(case, scale, max_k, score_k):
    rng = np.random.default_rng(4)
    # the spiral is made wide so that its PCA axis is well conditioned
    H, W = {"blobs": (160, 256), "spiral": (96, 256)}.get(case, (96, 128))
    prob = {"blocks": _blocks, "staircase": _staircase, "spiral": _spiral,
            "blobs": _blobs}[case](rng, H, W)
    rh, rw = H - 8, W - 16
    # a spiral fills little more than a third of its box
    box_thresh = 0.3 if case == "spiral" else 0.4
    kw = dict(max_k=max_k, thresh=0.3, box_thresh=box_thresh, unclip_ratio=1.5,
              min_size=3.0, scale=scale, score_k=score_k)
    rq, rs, rv = jdb.device_boxes(jnp.asarray(prob), rh, rw, reduce="scan",
                                  **kw)
    gq, gs, gv = db_device.device_boxes(torch.from_numpy(prob), rh, rw,
                                        reduce="pallas2", **kw)
    rv = np.asarray(rv)
    np.testing.assert_array_equal(gv.numpy(), rv)
    assert rv.sum() > 0
    np.testing.assert_allclose(gq.numpy()[rv], np.asarray(rq)[rv], atol=1e-3)
    np.testing.assert_allclose(gs.numpy()[rv], np.asarray(rs)[rv], atol=1e-5)


@pytest.fixture(scope="module")
def page_det_map():
    """The committed v5 detector's map of a committed page at the 320 px
    limit (the port's DBNet on the CPU), padded into a 320² canvas."""
    from onnxocr_tpu_torch.models import convert
    from onnxocr_tpu_torch.utils.params_io import load_tree
    img = read_bgr(PAGE)
    padded, h, w = resize_dev.pad_src_bucket(img)
    rh, rw = det_pre.det_resize_target(h, w, 320)
    model = convert.build_dbnet(load_tree(
        config.find_asset("ppocrv5/det/native_params.npz")))
    with torch.inference_mode():
        x = resize_dev.resize_normalize_det(torch.from_numpy(padded), h, w,
                                            rh, rw, 320, 320)
        prob = model(x.permute(2, 0, 1)[None], valid_hw=(rh, rw))[0]
    return prob.numpy().copy(), rh, rw


@pytest.mark.parametrize("reduce,extra", [
    ("scatter", {}),
    ("pallas", {}),
    ("pallas2", {}),
    ("scan", {}),
    ("pallas", {"score_scale": "1x2"}),
    ("pallas2", {"score_scale": "2x2"}),
    ("pallas", {"axis_snap": 0.06}),
    ("pallas2", {"axis_snap": 0.06}),
    ("scatter", {"score_scale": "1x2", "axis_snap": 0.06, "scale": "1x1"}),
])
def test_device_boxes_on_page_matches(page_det_map, reduce, extra):
    """Every reduction form, the pooled score grid and the axis snap on a
    real page's det map vs the JAX function with the same arguments (off
    the TPU it takes its scan lowering for both 'pallas' forms). Quads
    within 1e-3 px and scores within 1e-4: the sums are taken in another
    order (float64 here); `valid` equal."""
    prob, rh, rw = page_det_map
    kw = dict(max_k=256, thresh=0.3, box_thresh=0.4, unclip_ratio=1.5,
              min_size=3.0, scale="1x2", score_k=64, reduce=reduce)
    kw.update(extra)
    rq, rs, rv = jdb.device_boxes(jnp.asarray(prob), rh, rw, **kw)
    gq, gs, gv = db_device.device_boxes(torch.from_numpy(prob), rh, rw, **kw)
    rv = np.asarray(rv)
    np.testing.assert_array_equal(gv.numpy(), rv)
    assert rv.sum() >= 8
    np.testing.assert_allclose(gq.numpy()[rv], np.asarray(rq)[rv], atol=1e-3)
    np.testing.assert_allclose(gs.numpy()[rv], np.asarray(rs)[rv], atol=1e-4)
    if extra.get("axis_snap"):
        # upright text: the snapped quads are axis-aligned rectangles
        q = gq.numpy()[rv]
        assert (np.abs(q[:, 0, 1] - q[:, 1, 1]) < 1e-4).mean() > 0.5


def test_device_boxes_rejects_unknown_reduce(page_det_map):
    prob, rh, rw = page_det_map
    with pytest.raises(ValueError, match="tpu_db_reduce"):
        db_device.device_boxes(torch.from_numpy(prob), rh, rw,
                               reduce="sorted")


def test_label_slots_rank_components_in_raster_order():
    """slot = raster rank of the component's representative; background and
    components past the budget get max_k."""
    lab = np.zeros((6, 8), np.int32)
    lab[0, 5:8] = 6           # representative at raster index 5
    lab[1, 6:8] = 6
    lab[2, 0:3] = 17          # representative at raster index 16
    lab[4, 2:6] = 35          # representative at raster index 34
    for max_k, want in ((8, {6: 0, 17: 1, 35: 2}), (2, {6: 0, 17: 1, 35: 2})):
        slot, hit = db_device.label_slots(torch.from_numpy(lab), max_k)
        slot = slot.numpy().reshape(lab.shape)
        hit = hit.numpy().reshape(lab.shape)
        for label, rank in want.items():
            kept = rank < max_k
            assert (slot[lab == label] == (rank if kept else max_k)).all()
            assert (hit[lab == label] == kept).all()
        assert (slot[lab == 0] == max_k).all() and not hit[lab == 0].any()


def test_pca_axes_snap():
    acc = torch.tensor([[100., 0, 0, 1000., 10., 30., 0],    # ~1.7° tilt
                        [100., 0, 0, 1000., 800., 600., 0],  # ~40° tilt
                        [100., 0, 0, 10., 1000., -30., 0]])  # near vertical
    plain = db_device.pca_axes(acc).numpy()
    snapped = db_device.pca_axes(acc, 0.06).numpy()
    assert abs(plain[0, 1]) > 1e-3
    np.testing.assert_array_equal(snapped[0], [1.0, 0.0])
    np.testing.assert_array_equal(snapped[1], plain[1])
    assert snapped[2, 0] == 0.0 and abs(snapped[2, 1]) == 1.0


def test_unpack_boxes_matches():
    rng = np.random.default_rng(6)
    packed = rng.uniform(-5, 330, size=(32, 10)).astype(np.float32)
    packed[:, 9] = rng.random(32) < 0.6
    ref = jdb.unpack_boxes(packed, 320, 256, 900, 680)
    got = db_device.unpack_boxes(packed, 320, 256, 900, 680)
    assert got.dtype == np.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)

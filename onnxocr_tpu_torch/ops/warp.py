"""Perspective crops of text boxes: host homographies + the device warp.

Port of onnxocr_tpu/ops/warp.py. Every crop pixel maps through one 3×3
dest→source matrix (homography ∘ rot90 quirk ∘ optional 180° ∘ resize), is
sampled bilinearly or bicubically with BORDER_REPLICATE clamping, clipped,
normalized to [−1, 1] and zeroed beyond the crop's valid width. Three forms
compute it, selected per call by `staged` (`tpu_warp_stage`):

* False (`'off'`): the gather form, every tap read by index;
* True / `'upright'`: crops whose map is an exactly upright affine take a
  separable two-pass resample of their source rows, the rest the gather;
* `'shear'` (the default, as in the JAX package): small-tilt affine crops
  take the Catmull-Smith shear decomposition (rows resampled at the exact
  shear heights, then x, then a per-row sub-pixel drift), the rest the
  gather.

Bicubic sampling always takes the gather form, as in the JAX package, and
so does `warp_crops_multi`, which takes crops from a stack of pages (the
cross-request rec batcher's warp). The JAX package wrote the staged passes
as dense hat-weighted matrix products for the TPU's matrix unit; a hat
weight has at most two nonzero taps, so here each pass is a two-tap lerp
by index, which gives the same sums without the (K, out_h, W, 128) weight
tensors. A staged form gathers every
crop too and keeps its own crop where it may: no host sync, so a CUDA graph
can hold the call. (The JAX package compacts the crops left to gather into
`tpu_warp_slow_k` static slots, which XLA's static shapes call for; here
that setting is accepted and stored, and `ab_warp.py` times an exact-size
compaction against this form.) `warp_crops_host` is the host form
(tpu_crop_backend='host'): cv2's bicubic warp of each crop, from the numpy
twin of utils/cv_ops.py.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils import cv_ops


def perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3×3 homography mapping src[i] → dst[i] (cv2.getPerspectiveTransform)."""
    src = np.asarray(src, dtype=np.float64).reshape(4, 2)
    dst = np.asarray(dst, dtype=np.float64).reshape(4, 2)
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        A[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        A[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i] = u
        b[2 * i + 1] = v
    h = np.linalg.solve(A, b)
    return np.append(h, 1.0).reshape(3, 3)


def crop_geometry(box: np.ndarray) -> Tuple[int, int]:
    """Crop width/height of a quad as the reference computes them."""
    pts = np.asarray(box, dtype=np.float32)
    w = int(max(np.linalg.norm(pts[0] - pts[1]),
                np.linalg.norm(pts[2] - pts[3])))
    h = int(max(np.linalg.norm(pts[0] - pts[3]),
                np.linalg.norm(pts[1] - pts[2])))
    return w, h


def _affine(a, b, c, d, tx, ty) -> np.ndarray:
    return np.array([[a, b, tx], [c, d, ty], [0, 0, 1.0]])


def build_crop_matrix(box: np.ndarray, out_h: int, bucket_w: int,
                      rotate180: bool = False) -> Tuple[np.ndarray, int]:
    """Dest→source matrix for one crop: perspective warp to (cw, ch), rot90
    if ch/cw >= 1.5, optional 180°, then resize height → out_h at width
    ceil(out_h·ratio) capped at bucket_w. → (3×3 float32, resized_w)."""
    pts = np.asarray(box, dtype=np.float32).reshape(4, 2)
    cw, ch = crop_geometry(pts)
    cw = max(cw, 1)
    ch = max(ch, 1)
    dst_std = np.array([[0, 0], [cw, 0], [cw, ch], [0, ch]], dtype=np.float32)
    M_inv = perspective_transform(dst_std, pts)
    if ch * 1.0 / cw >= 1.5:
        M_inv = M_inv @ _affine(0, -1, 1, 0, cw - 1.0, 0.0)
        cw, ch = ch, cw
    if rotate180:
        M_inv = M_inv @ _affine(-1, 0, 0, -1, cw - 1.0, ch - 1.0)
    ratio = cw / float(ch)
    if int(np.ceil(out_h * ratio)) > bucket_w:
        resized_w = bucket_w
    else:
        resized_w = max(1, int(np.ceil(out_h * ratio)))
    sx = cw / float(resized_w)
    sy = ch / float(out_h)
    M = M_inv @ _affine(sx, 0, 0, sy, 0.5 * sx - 0.5, 0.5 * sy - 0.5)
    return M.astype(np.float32), resized_w


# staged forms: rows of source a crop may span (taller spans take the gather)
STAGE_ROWS = 128
# shear form: the per-row x drift it can shift by, in columns either way
SHIFT_BANK = 5


def form_of(args) -> dict:
    """warp_crops' interp, staged and stage_tol from the config; staged is
    False for `tpu_warp_stage` 'off' (and its empty spellings), else the
    setting itself."""
    stage = args.tpu_warp_stage
    return dict(interp=args.tpu_warp_interp,
                staged=False if stage in ("off", "", None, False) else stage,
                stage_tol=float(args.tpu_warp_stage_tol))


def _cubic_weights(t, a: float = -0.75):
    """cv2 INTER_CUBIC weights (a = −0.75) of the taps at offsets −1, 0, 1,
    2 from floor(coord)."""
    t2 = t * t
    t3 = t2 * t
    w0 = a * (t3 - 2 * t2 + t)
    w1 = (a + 2) * t3 - (a + 3) * t2 + 1
    w2 = -(a + 2) * t3 + (2 * a + 3) * t2 - a * t
    w3 = a * (t2 - t3)
    return w0, w1, w2, w3


def _gather(image_u8, mats, valid_w, out_h: int, out_w: int, interp: str,
            base=None):
    """The gather form: (N, out_h, out_w, 3) float32 samples in [0, 255]
    before the clip. Dead lanes (columns >= valid_w) read pixel (0, 0).
    image_u8 is one page (H, W, 3), or a stack of pages (B, H, W, 3) with
    `base` (N,) int64 the flat offset of each crop's page (page · H · W)."""
    H, W = image_u8.shape[-3:-1]
    dev = image_u8.device
    flat = image_u8.reshape(-1, 3)
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32,
                                         device=dev),
                            torch.arange(out_w, dtype=torch.float32,
                                         device=dev), indexing="ij")
    m = mats[:, :, :, None, None]
    u = m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]
    v = m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]
    w = m[:, 2, 0] * gx + m[:, 2, 1] * gy + m[:, 2, 2]
    inv_w = 1.0 / w
    sx = torch.clamp(u * inv_w, 0.0, W - 1.0)
    sy = torch.clamp(v * inv_w, 0.0, H - 1.0)
    live = gx[None] < valid_w[:, None, None]
    sx = torch.where(live, sx, 0.0)
    sy = torch.where(live, sy, 0.0)

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)

    def tap(yy, xx):
        # the uint8 pixel, converted after the gather
        yy = torch.clamp(yy, 0, H - 1)
        xx = torch.clamp(xx, 0, W - 1)
        at = yy * W + xx
        if base is not None:
            at = at + base[:, None, None]
        return flat[at].to(torch.float32)

    if interp == "bicubic":
        wx = _cubic_weights(fx)
        wy = _cubic_weights(fy)
        out = 0.0
        for j in range(4):
            row = 0.0
            for i in range(4):
                row = row + tap(y0 + j - 1, x0 + i - 1) * wx[i][..., None]
            out = out + row * wy[j][..., None]
        return out
    fx = fx[..., None]
    fy = fy[..., None]
    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def _index(t, lo: int, hi: int):
    """A float tensor of whole numbers as int64 indices clamped to [lo, hi];
    NaN (the rows of a degenerate crop matrix, which the output mask
    zeroes) reads index lo."""
    return torch.clamp(torch.nan_to_num(t, nan=lo), lo, hi).to(torch.int64)


def _hat_taps(coord, size: int):
    """The two nonzero taps of the hat max(0, 1 − |coord − j|) over j in
    [0, size), for coord in [0, size − 1]: (j0, weight of j0, j1, weight of
    j1). At coord = size − 1, j1 = size weighs 0 and reads j0."""
    j0 = torch.floor(coord)
    w0 = 1.0 - torch.abs(coord - j0)
    w1 = 1.0 - torch.abs(coord - (j0 + 1.0))
    return _index(j0, 0, size - 1), w0, _index(j0 + 1.0, 0, size - 1), w1


def _staged_rows(y0, r, H: int):
    """Image row of staged row r of crops whose window starts at y0."""
    return torch.clamp(_index(y0, 0, H - 1) + r, 0, H - 1)


def _separable_mask(mats, out_h: int, tol: float):
    """Crops whose dest→source map is an upright affine (no cross terms, no
    perspective) and whose source-row span fits the staged window."""
    b = torch.abs(mats[:, 0, 1])
    d = torch.abs(mats[:, 1, 0])
    g = torch.abs(mats[:, 2, 0])
    h = torch.abs(mats[:, 2, 1])
    affine = (g < 1e-8) & (h < 1e-8)
    upright = affine & (b <= tol) & (d <= tol)
    e, f = mats[:, 1, 1], mats[:, 1, 2]
    span = torch.abs((e * (out_h - 1.0) + f) - f)
    return upright & (span <= STAGE_ROWS - 3)


def _staged_separable(image_u8, mats, out_h: int, out_w: int):
    """Upright crops as a separable bilinear resample of their staged rows:
    y first, then x → (N, out_h, out_w, 3) float32 in [0, 255]."""
    H, W = image_u8.shape[:2]
    dev = image_u8.device
    a, c = mats[:, 0, 0], mats[:, 0, 2]
    e, f = mats[:, 1, 1], mats[:, 1, 2]
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    sy = torch.clamp(e[:, None] * ys + f[:, None], 0.0, H - 1.0)
    sx = torch.clamp(a[:, None] * xs + c[:, None], 0.0, W - 1.0)
    y0 = torch.clamp(torch.floor(sy.min(dim=1).values) - 1.0, 0.0,
                     float(max(H - 1, 0)))
    # the clip changes only crops whose rows overflow the window: those
    # take the gather
    syl = torch.clamp(sy - y0[:, None], max=STAGE_ROWS - 1.0)
    r0, wy0, r1, wy1 = _hat_taps(syl, STAGE_ROWS)                # (N, out_h)
    c0, wx0, c1, wx1 = _hat_taps(sx, W)                           # (N, out_w)
    row0 = _staged_rows(y0[:, None], r0, H)[:, :, None] * W
    row1 = _staged_rows(y0[:, None], r1, H)[:, :, None] * W
    flat = image_u8.reshape(-1, 3)
    wy0, wy1 = wy0[:, :, None, None], wy1[:, :, None, None]

    def column(col):  # the y pass at source column col: (N, out_h, out_w, 3)
        col = col[:, None, :]
        return (wy0 * flat[row0 + col].to(torch.float32) +
                wy1 * flat[row1 + col].to(torch.float32))

    return (column(c0) * wx0[:, None, :, None] +
            column(c1) * wx1[:, None, :, None])


def _shear_affine(mats, valid_w, out_h: int, tol: float = 0.35):
    """Least-squares affine through the four mapped corners of each crop's
    valid dest rectangle, and which crops the shear form may take.

    Quads rounded to integer source coordinates are true small-perspective
    quads, so the affine is fitted through the homography's images of the
    dest corners (0, 0), (X, 0), (0, Y), (X, Y) — closed form on a
    rectangle, exact for parallelograms — rather than read off its top
    rows. → (a, b, c, d, e, f, elig), the map sx = a·x + b·y + c,
    sy = d·x + e·y + f, and elig where all of these hold:
      * the map stays within `tol` px of the affine at the four edge
        midpoints and the centre (a homography through rounded corners
        bows between them);
      * |a| ≥ 0.05 (no rot90-composed verticals);
      * |d/a| ≤ 0.3 (the shear decomposition's y-position error, px);
      * |b·(out_h − 1)/a| < SHIFT_BANK (the per-row drift it can shift);
      * the corners' y-span fits the staged window.
    The arithmetic and its order are the JAX package's: `tol` is compared
    against its result.
    """
    X = torch.clamp(valid_w.to(torch.float32) - 1.0, min=1.0)
    Y = float(max(out_h - 1, 1))
    # the 4 corners and the 5 probes are the 3 × 3 grid (fx·X, fy·Y), fx and
    # fy in {0, 0.5, 1}: products exact, so the points of the JAX package
    grid = torch.arange(9, device=mats.device)
    fx, fy = (grid % 3) * 0.5, (grid // 3) * 0.5
    px, py = fx * X[:, None], fy * Y                               # (K, 9)
    # x and y side by side (K, 2, ...), each as the JAX package computes it
    m = mats[:, :, :, None]
    uvw = m[:, :, 0] * px[:, None] + m[:, :, 1] * py + m[:, :, 2]
    w_ok = torch.abs(uvw[:, 2]) > 1e-3
    q = uvw[:, :2] / torch.where(w_ok, uvw[:, 2], 1.0)[:, None]     # (K, 2, 9)
    # (basic indexing only: no index tensor to copy to the device)
    p00, p10, p01, p11 = q[..., 0], q[..., 2], q[..., 6], q[..., 8]
    w_ok = w_ok[:, 0] & w_ok[:, 2] & w_ok[:, 6] & w_ok[:, 8]

    # 2Y as a tensor: PyTorch's CUDA division by a Python number multiplies
    # by its reciprocal, one rounding more than the CPU's and the JAX
    # package's quotient
    X2 = X[:, None]
    ad = (p10 + p11 - p00 - p01) / (2.0 * X2)                      # (a, d)
    be = (p01 + p11 - p00 - p10) / torch.full_like(X2, 2.0 * Y)    # (b, e)
    cf = 0.25 * (p00 + p10 + p01 + p11) - ad * X2 * 0.5 - be * Y * 0.5

    # map-vs-affine deviation, (a·fx)·X + (b·fy)·Y + c in the JAX
    # package's order, taken at the probes: the edge midpoints (odd points)
    # and the centre (point 4)
    err = q - (ad[..., None] * fx * X[:, None, None] +
               be[..., None] * fy * Y + cf[..., None])
    dev = torch.abs(err).amax(dim=1)                                # (K, 9)
    dev = torch.maximum(dev[:, 1::2].amax(dim=1), dev[:, 4])
    near_affine = dev <= tol  # compared in float32, as in the JAX package

    (a, d), (b, e), (c, f) = ad.unbind(1), be.unbind(1), cf.unbind(1)
    p00y, p10y, p01y, p11y = p00[:, 1], p10[:, 1], p01[:, 1], p11[:, 1]
    ok_a = torch.abs(a) >= 0.05
    a_safe = torch.where(ok_a, a, 1.0)
    shear = torch.abs(d / a_safe) <= 0.3
    drift = torch.abs(b * (out_h - 1.0) / a_safe) <= (SHIFT_BANK - 0.001)
    lo = torch.minimum(torch.minimum(p00y, p10y), torch.minimum(p01y, p11y))
    hi = torch.maximum(torch.maximum(p00y, p10y), torch.maximum(p01y, p11y))
    span_ok = (hi - lo) <= (STAGE_ROWS - 4)
    elig = w_ok & near_affine & ok_a & shear & drift & span_ok
    return a, b, c, d, e, f, elig


def _shear_mask(mats, valid_w, out_h: int, tol: float = 0.35):
    """The crops the shear form takes (the eligibility of _shear_affine)."""
    return _shear_affine(mats, valid_w, out_h, tol)[-1]


def _staged_shear(image_u8, coeffs, valid_w, out_h: int, out_w: int):
    """Small-tilt affine crops by the Catmull-Smith decomposition of
    sx = a·x + b·y + c, sy = d·x + e·y + f:

      pass 1   resample each source column w in y at the shear height
               σ(v, w) = d·(w − b·v − c)/a + e·v + f — the sy at the dest
               x that reads column w — from the crop's staged rows;
      pass 2a  resample in x at u(x) = a·x + c;
      pass 2b  shift each row by its remaining drift b·v/a, at most
               SHIFT_BANK columns, with edge padding.

    Against the gather: a y error of at most |d/a| ≤ 0.3 px, and one more
    sub-pixel interpolation in x. Pass 1 is evaluated only at the two
    columns each pass-2a tap reads. coeffs: (a, b, c, d, e, f) of
    _shear_affine. → (N, out_h, out_w, 3) float32 in [0, 255]."""
    H, W = image_u8.shape[:2]
    K = valid_w.shape[0]
    dev = image_u8.device
    a, b, c, d, e, f = coeffs
    a = torch.where(torch.abs(a) >= 0.05, a, 1.0)  # finite for the others
    vs = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)

    # the staged window: rows from floor(min corner sy) − 1
    xw = torch.clamp(valid_w.to(torch.float32) - 1.0, min=0.0)
    yv = out_h - 1.0
    corners = torch.stack([f, d * xw + f, e * yv + f, d * xw + e * yv + f],
                          dim=-1)
    y0 = torch.clamp(torch.floor(corners.min(dim=-1).values) - 1.0, 0.0,
                     float(max(H - 1, 0)))

    # pass 2a's two taps of each dest x: columns (K, out_w, 2) and weights
    u = torch.clamp(a[:, None] * xs + c[:, None], 0.0, W - 1.0)
    c0, wx0, c1, wx1 = _hat_taps(u, W)
    cols, wx = torch.stack([c0, c1], -1), torch.stack([wx0, wx1], -1)

    # pass 1 at those columns only: σ (K, out_h, out_w, 2), its two rows
    # and their weights (K, out_h, out_w, 2, 2)
    k4 = (slice(None), None, None, None)
    sig = (d / a)[k4] * (cols[:, None].to(torch.float32) - b[k4] * vs[
        None, :, None, None] - c[k4]) + e[k4] * vs[None, :, None, None] + f[k4]
    sig = torch.clamp(torch.clamp(sig, 0.0, H - 1.0) - y0[k4], 0.0,
                      STAGE_ROWS - 1.0)
    r0, wy0, r1, wy1 = _hat_taps(sig, STAGE_ROWS)
    rows = _staged_rows(y0[k4 + (None,)], torch.stack([r0, r1], -1), H)
    pix = image_u8.reshape(-1, 3)[rows * W + cols[:, None, :, :, None]]
    # a sum over a dim of two is w0·t0 + w1·t1, the products' own order
    T = (torch.stack([wy0, wy1], -1)[..., None] * pix.to(torch.float32)
         ).sum(dim=-2)                                  # (K, out_h, out_w, 2, 3)
    P = (T * wx[:, None, :, :, None]).sum(dim=-2)       # (K, out_h, out_w, 3)

    # pass 2b: the drift b·v/a as a whole shift m and a lerp by phi between
    # the edge-padded columns x + m and x + m + 1
    shift = b[:, None] * vs[None, :] / a[:, None]            # (K, out_h)
    m = torch.clamp(torch.floor(shift), -float(SHIFT_BANK), float(SHIFT_BANK))
    phi = torch.clamp(shift - m, 0.0, 1.0)
    at = _index(m, -SHIFT_BANK, SHIFT_BANK)[:, :, None, None] + \
        torch.arange(out_w, device=dev)[:, None] + torch.arange(2, device=dev)
    at = torch.clamp(at, 0, out_w - 1).reshape(K, out_h, 2 * out_w, 1)
    taps = torch.gather(P, 2, at.expand(-1, -1, -1, 3)).reshape(
        K, out_h, out_w, 2, 3)
    lerp = torch.stack([1.0 - phi, phi], -1)[:, :, None, :, None]
    return (lerp * taps).sum(dim=-2)


def warp_crops(image_u8: torch.Tensor, mats: torch.Tensor,
               valid_w: torch.Tensor, out_h: int, out_w: int,
               interp: str = "bilinear", staged=False,
               stage_tol: float = 0.35) -> torch.Tensor:
    """image_u8 (H, W, 3) uint8, mats (N, 3, 3) float32 dest→source,
    valid_w (N,) int → (N, out_h, out_w, 3) float32 crops in [−1, 1], zero
    at columns >= valid_w.

    interp: 'bilinear' or 'bicubic' (bicubic always takes the gather form).
    staged: False — the gather form; True / 'upright' — exactly upright
      affine crops take the separable staged form; 'shear' — small-tilt
      affine crops take the shear form (see _shear_affine for which).
    stage_tol: the shear form's bound (px) on the map-vs-affine deviation.
    """
    if interp not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown tpu_warp_interp {interp!r}")
    vals = _gather(image_u8, mats, valid_w, out_h, out_w, interp)
    if staged and interp != "bicubic":
        if staged == "shear":
            *coeffs, fast_ok = _shear_affine(mats, valid_w, out_h, stage_tol)
            fast = _staged_shear(image_u8, coeffs, valid_w, out_h, out_w)
        else:
            # 1e-5 absorbs the float32 homography-solve residual on exactly
            # axis-aligned quads
            fast_ok = _separable_mask(mats, out_h, 1e-5)
            fast = _staged_separable(image_u8, mats, out_h, out_w)
        vals = torch.where(fast_ok[:, None, None, None], fast, vals)
    return to_crops(vals, valid_w, out_w)


def warp_crops_multi(images_u8: torch.Tensor, img_idx: torch.Tensor,
                     mats: torch.Tensor, valid_w: torch.Tensor, out_h: int,
                     out_w: int, interp: str = "bilinear") -> torch.Tensor:
    """Crops from a stack of pages (the cross-request rec batcher's warp):
    images_u8 (B, H, W, 3) uint8 pages of one source bucket, img_idx (N,)
    the page of each crop; mats, valid_w, out_h, out_w and interp as in
    warp_crops → (N, out_h, out_w, 3) float32 crops in [−1, 1]. Always the
    gather form, as the JAX package's `warp_crops_multi` (it has no staged
    form)."""
    if interp not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown tpu_warp_interp {interp!r}")
    H, W = images_u8.shape[1:3]
    base = img_idx.to(torch.int64) * (H * W)
    return to_crops(_gather(images_u8, mats, valid_w, out_h, out_w, interp,
                            base), valid_w, out_w)


def to_crops(vals, valid_w, out_w: int):
    """Samples (N, out_h, out_w, 3) in [0, 255] before the clip → the
    crops: clipped, normalized to [−1, 1], zero at columns >= valid_w."""
    vals = torch.clamp(vals, 0.0, 255.0)
    norm = (vals / 255.0 - 0.5) / 0.5
    live = torch.arange(out_w, device=vals.device)[None, None, :] < \
        valid_w[:, None, None]
    return torch.where(live[..., None], norm, 0.0)


def warp_crops_host(image: np.ndarray, mats: np.ndarray, valid_w: np.ndarray,
                    out_h: int, out_w: int) -> np.ndarray:
    """The host form of warp_crops: cv2's bicubic perspective warp with the
    edge replicated (utils/cv_ops.warp_perspective_cubic) → (N, out_h,
    out_w, 3) float32 crops in [−1, 1], zero at columns >= valid_w."""
    out = np.zeros((len(mats), out_h, out_w, 3), dtype=np.float32)
    for i in range(len(mats)):
        # the twin takes the source → dest matrix, as cv2 does
        M = np.linalg.inv(mats[i].astype(np.float64))
        crop = cv_ops.warp_perspective_cubic(image, M, (out_w, out_h))
        norm = (crop.astype(np.float32) / 255.0 - 0.5) / 0.5
        norm[:, int(valid_w[i]):] = 0.0
        out[i] = norm
    return out

"""numpy twins of the cv2 calls of the JAX package's host image paths, giving
cv2's pixels (the machine with the GPU has no cv2).

* `resize_linear`: `cv2.resize` with INTER_LINEAR on uint8 images. cv2's
  fixed-point scheme: the source coordinate of each destination column and
  row is computed in double and rounded to float32, its fraction becomes two
  11-bit coefficients, the horizontal pass is exact integer arithmetic, and
  the vertical pass is cv2's 16-bit one,
  ((((S0 >> 4) * b0) >> 16) + (((S1 >> 4) * b1) >> 16) + 2) >> 2. Columns
  past either edge take the edge column; rows past either edge are fetched
  clamped but keep their two coefficients, as cv2 keeps them.
* `warp_perspective_cubic`: `cv2.warpPerspective(..., INTER_CUBIC,
  BORDER_REPLICATE)` as cv2 5 computes it: the matrix inverted in double by
  cv2's 3 × 3 formula, each destination pixel's source position in float32
  (cv2 4 rounded it to 1/32 px and used a 15-bit weight table instead), the
  4 × 4 taps around it clamped to the border and weighted by cv2's
  interpolateCubic (a = −0.75) in float32. cv2 5 derives the position by
  float32 steps this twin does not follow; the double one it takes rounds
  to another float32 on a few pixels in 10^5, which then differ by one.
* `rotate_180`: `cv2.rotate(img, cv2.ROTATE_180)`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

_COEF_BITS = 11                  # cv2's INTER_RESIZE_COEF_BITS


def _as_u8_image(img: np.ndarray) -> Tuple[np.ndarray, bool]:
    """→ (H, W, C) uint8 view, whether the input had no channel axis."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"uint8 images only, got {img.dtype}")
    if img.ndim == 2:
        return img[:, :, None], True
    if img.ndim != 3:
        raise ValueError(f"expected (H, W) or (H, W, C), got {img.shape}")
    return img, False


def _axis_taps(dst_n: int, src_n: int, scale: float, clamp_frac: bool):
    """Source index and 11-bit coefficients of each destination position
    along one axis: (first tap (dst_n,) int64, (dst_n, 2) int32 weights)."""
    d = np.arange(dst_n, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp_frac:
        # columns: before the first, or at or past the last, source column
        # take that column whole
        lo, hi = s < 0, s >= src_n - 1
        f = np.where(lo | hi, np.float32(0), f)
        s = np.where(lo, 0, np.where(hi, src_n - 1, s))
    # np.rint rounds half to even, as cv2's saturate_cast
    one = np.float32(1 << _COEF_BITS)
    c0 = np.rint((np.float32(1) - f) * one)
    c1 = np.rint(f * one)
    return s, np.stack([c0, c1], -1).astype(np.int32)


def resize_linear(img: np.ndarray, dsize: Optional[Sequence[int]] = None,
                  fx: float = 0.0, fy: float = 0.0) -> np.ndarray:
    """cv2.resize(img, dsize, fx=fx, fy=fy) with INTER_LINEAR on a uint8
    image of 1 or more channels ((H, W) or (H, W, C)). dsize = (width,
    height); without it the size is (round(W·fx), round(H·fy)), half to
    even, and the scales are 1/fx and 1/fy, as cv2 takes them."""
    src, flat = _as_u8_image(img)
    H, W, C = src.shape
    if dsize is not None and tuple(dsize) != (0, 0):
        dw, dh = int(dsize[0]), int(dsize[1])
        inv_x, inv_y = dw / W, dh / H
    else:
        if not (fx > 0 and fy > 0):
            raise ValueError("resize_linear needs dsize or fx, fy > 0")
        dw = int(np.rint(W * fx))
        dh = int(np.rint(H * fy))
        inv_x, inv_y = float(fx), float(fy)
    if dw <= 0 or dh <= 0:
        raise ValueError(f"empty destination size {(dw, dh)}")
    # an exact 2× downscale, which cv2 may take as INTER_AREA, gives the
    # same pixels here: both taps weigh 2^10
    out = src.copy() if (dw, dh) == (W, H) else \
        _resize_fixed(src, dw, dh, 1.0 / inv_x, 1.0 / inv_y)
    return out[:, :, 0] if flat else out


def _resize_fixed(src: np.ndarray, dw: int, dh: int, scale_x: float,
                  scale_y: float) -> np.ndarray:
    H, W, _ = src.shape
    sx, ax = _axis_taps(dw, W, scale_x, clamp_frac=True)
    sy, by = _axis_taps(dh, H, scale_y, clamp_frac=False)
    x1 = np.minimum(sx + 1, W - 1)
    # horizontal pass on the source rows the vertical pass reads: exact
    # integers up to 255 · 2^11
    rows = np.unique(np.clip(np.concatenate([sy, sy + 1]), 0, H - 1))
    s = src[rows].astype(np.int32)
    hor = s[:, sx] * ax[None, :, 0, None] + s[:, x1] * ax[None, :, 1, None]
    where = np.searchsorted(rows, np.clip(sy, 0, H - 1))
    where1 = np.searchsorted(rows, np.clip(sy + 1, 0, H - 1))
    r0 = hor[where] >> 4
    r1 = hor[where1] >> 4
    b0 = by[:, 0, None, None]
    b1 = by[:, 1, None, None]
    v = (((r0 * b0) >> 16) + ((r1 * b1) >> 16) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8)


# ------------------------------------------------------- warpPerspective
def _cubic_weights(t: np.ndarray):
    """cv2's interpolateCubic (a = −0.75) on float32 fractions → four
    float32 weight arrays, each operation rounded to float32 as cv2's."""
    f = np.float32
    A, one = f(-0.75), f(1)
    t = t.astype(f)
    tp = t + one
    c0 = ((A * tp - f(5) * A) * tp + f(8) * A) * tp - f(4) * A
    c1 = ((A + f(2)) * t - (A + f(3))) * t * t + one
    tm = one - t
    c2 = ((A + f(2)) * tm - (A + f(3))) * tm * tm + one
    return c0, c1, c2, one - c0 - c1 - c2


def invert_3x3(M: np.ndarray) -> np.ndarray:
    """cv2.invert of a 3 × 3 float64 matrix (DECOMP_LU takes the adjugate
    formula at n = 3); a singular matrix gives zeros, as cv2's."""
    m = np.asarray(M, np.float64).reshape(3, 3)
    d = (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) -
         m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0]) +
         m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))
    if d == 0.0:
        return np.zeros((3, 3), np.float64)
    d = 1.0 / d
    t = np.empty(9, np.float64)
    t[0] = (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) * d
    t[1] = (m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]) * d
    t[2] = (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * d
    t[3] = (m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]) * d
    t[4] = (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * d
    t[5] = (m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]) * d
    t[6] = (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]) * d
    t[7] = (m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]) * d
    t[8] = (m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]) * d
    return t.reshape(3, 3)


def remap_cubic(img: np.ndarray, map_x: np.ndarray,
                map_y: np.ndarray) -> np.ndarray:
    """cv2.remap(img, map_x, map_y, INTER_CUBIC, BORDER_REPLICATE) on a
    uint8 image with float32 maps: the 4 × 4 taps around each position,
    clamped to the border, weighted in float32 and rounded half to even."""
    src, flat = _as_u8_image(img)
    H, W, _ = src.shape
    X = np.asarray(map_x, np.float32)
    Y = np.asarray(map_y, np.float32)
    x0, y0 = np.floor(X), np.floor(Y)
    wx = _cubic_weights(X - x0)
    wy = _cubic_weights(Y - y0)
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    acc = np.float32(0)
    for j in range(4):
        yy = np.clip(y0 + (j - 1), 0, H - 1)
        row = np.float32(0)
        for i in range(4):
            xx = np.clip(x0 + (i - 1), 0, W - 1)
            row = row + src[yy, xx].astype(np.float32) * wx[i][..., None]
        acc = acc + row * wy[j][..., None]
    out = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return out[:, :, 0] if flat else out


def warp_perspective_cubic(img: np.ndarray, M: np.ndarray,
                           dsize: Sequence[int]) -> np.ndarray:
    """cv2.warpPerspective(img, M, dsize, flags=INTER_CUBIC,
    borderMode=BORDER_REPLICATE) on a uint8 image: M maps source to
    destination, dsize = (width, height). Each destination pixel's source
    position is computed in double from cv2's inverse of M and sampled at
    float32 precision as `remap_cubic` samples."""
    w, h = int(dsize[0]), int(dsize[1])
    if w <= 0 or h <= 0:
        raise ValueError(f"empty destination size {(w, h)}")
    m = invert_3x3(M)
    x = np.arange(w, dtype=np.float64)[None, :]
    y = np.arange(h, dtype=np.float64)[:, None]
    den = m[2, 0] * x + m[2, 1] * y + m[2, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = (m[0, 0] * x + m[0, 1] * y + m[0, 2]) / den
        sy = (m[1, 0] * x + m[1, 1] * y + m[1, 2]) / den
    return remap_cubic(img, sx.astype(np.float32), sy.astype(np.float32))


def rotate_180(img: np.ndarray) -> np.ndarray:
    """cv2.rotate(img, cv2.ROTATE_180)."""
    return np.ascontiguousarray(np.asarray(img)[::-1, ::-1])

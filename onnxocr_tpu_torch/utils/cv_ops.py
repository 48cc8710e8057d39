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
* `polylines2`: `cv2.polylines(img, [pts], True, color, 2)` (LINE_8) as
  cv2 5.0 draws it: each side clipped in whole pixels to the image grown
  by 2, a quadrilateral one pixel either side of it in 16.16 fixed point
  (outlined by cv2's fixed-point line, clipped in fixed point, and filled
  by its convex scanline fill), and a radius-1 disc at its end.
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


# ------------------------------------------------------- polylines
_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2's clipLine on a w x h (fixed-point) frame → the clipped ends, or
    None when the line misses the frame."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return None if (c1 | c2) else (x1, y1, x2, y2)


def _put(img, xs, ys, color):
    keep = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[keep], xs[keep]] = color


def _line_fixed(img, p1, p2, color):
    """cv2's Line2: an 8-connected line between two 16.16 fixed-point
    points."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, *p1, *p2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:                     # swap the ends
            x1, y1, x2, y2 = x2, y2, x1, y1
            dy = -dy
        step = _div_trunc(dy << _XY_SHIFT, ax | 1)
        count = (x2 - x1) >> _XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dx = -dx
        step = _div_trunc(dx << _XY_SHIFT, ay | 1)
        count = (y2 - y1) >> _XY_SHIFT
    x1 += _XY_ONE >> 1
    y1 += _XY_ONE >> 1
    _put(img, np.array([(x2 + (_XY_ONE >> 1)) >> _XY_SHIFT]),
         np.array([(y2 + (_XY_ONE >> 1)) >> _XY_SHIFT]), color)
    k = np.arange(count + 1, dtype=np.int64) if count >= 0 else \
        np.zeros(0, np.int64)
    if ax > ay:
        _put(img, (x1 >> _XY_SHIFT) + k, (y1 + k * step) >> _XY_SHIFT, color)
    else:
        _put(img, (x1 + k * step) >> _XY_SHIFT, (y1 >> _XY_SHIFT) + k, color)


def _div_trunc(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fill_convex(img, pts, color):
    """cv2's FillConvexPoly (LINE_8) of 16.16 fixed-point vertices."""
    h, w = img.shape[:2]
    n = len(pts)
    delta = _XY_ONE >> 1
    p0 = pts[-1]
    for p in pts:
        _line_fixed(img, p0, p, color)
        p0 = p
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    imin = int(np.argmin(ys))
    xmin, xmax = (min(xs) + delta) >> 16, (max(xs) + delta) >> 16
    ymin, ymax = (min(ys) + delta) >> 16, (max(ys) + delta) >> 16
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "x": -_XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": n - 1, "x": -_XY_ONE, "dx": 0, "ye": ymin}]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (pts[idx][1] + delta) >> 16
                    if ty > y:
                        xs_, xe = pts[idx0][0], pts[idx][0]
                        e["ye"] = ty
                        e["dx"] = _div_trunc((xe - xs_) * 2 + (ty - y),
                                             2 * (ty - y))
                        e["x"] = xs_
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            x1 = (edge[left]["x"] + delta) >> 16
            x2 = (edge[right]["x"] + delta) >> 16
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _disc1(img, cx: int, cy: int, color):
    """cv2's filled Circle of radius 1: the centre row of 3, one above and
    one below."""
    _put(img, np.array([cx - 1, cx, cx + 1, cx, cx]),
         np.array([cy, cy, cy, cy - 1, cy + 1]), color)


def polylines2(img: np.ndarray, pts, color) -> np.ndarray:
    """cv2.polylines(img, [pts], True, color, 2) in place (LINE_8,
    thickness 2, integer vertices): each side a filled quadrilateral one
    pixel either side of it, with a radius-1 disc at each vertex →
    img."""
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    color = np.asarray(color, img.dtype)
    p0 = pts[-1]
    h, w = img.shape[:2]
    for p in pts:
        # cv2 clips each side to the image grown by the thickness, in
        # whole pixels, before it draws the side
        seg = _clip_line(w + 4, h + 4, p0[0] + 2, p0[1] + 2, p[0] + 2,
                         p[1] + 2)
        if seg is None:
            p0 = p
            continue
        seg = [v - 2 for v in seg]
        x0, y0, x1, y1 = (v << 16 for v in seg)
        dx, dy = (x0 - x1) / _XY_ONE, (y1 - y0) / _XY_ONE
        r = dx * dx + dy * dy
        if abs(r) > np.finfo(np.float64).eps:
            r = _XY_ONE / np.sqrt(r)
            ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
            _fill_convex(img, [(x0 + ox, y0 + oy), (x0 - ox, y0 - oy),
                               (x1 - ox, y1 - oy), (x1 + ox, y1 + oy)],
                         color)
        _disc1(img, seg[2], seg[3], color)
        p0 = p
    return img

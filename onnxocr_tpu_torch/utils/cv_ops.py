"""numpy twins (the bicubic sampler in host C++) of the cv2 calls of the JAX
package's host image paths, giving cv2's pixels (the machine with the GPU
has no cv2).

* `resize_linear`: `cv2.resize` with INTER_LINEAR on uint8 images. cv2's
  fixed-point scheme: the source coordinate of each destination column and
  row is computed in double and rounded to float32, its fraction becomes two
  11-bit coefficients, the horizontal pass is exact integer arithmetic, and
  the vertical pass is cv2's 16-bit one,
  ((((S0 >> 4) * b0) >> 16) + (((S1 >> 4) * b1) >> 16) + 2) >> 2. Columns
  past either edge take the edge column; rows past either edge are fetched
  clamped but keep their two coefficients, as cv2 keeps them.
* `warp_perspective_cubic`, `remap_cubic`: `cv2.warpPerspective(...,
  INTER_CUBIC, BORDER_REPLICATE)` and `cv2.remap` with float32 maps as cv2
  5.0 computes them on a host with AVX2 and FMA: the matrix inverted in
  double by cv2's 3 × 3 formula and rounded to float32, each row's
  constants y·m1 + m2 (and the other two) float32 products and sums, each
  pixel's x·m0 + row constant and the quotients of those in double,
  rounded to float32; the position clamped to [−K, 2K] (K = max(side,
  16)), its 4 × 4 taps clamped to the border and summed by cv2's float32
  weights and FMAs (host C++, csrc/host/remap.cc), rounded half to even.
* `resize_cubic` and `resize_linear` on float32 images: IPP's AVX-512
  kernels as cv2 5.0 calls them (`_resize_float`, `_ipp_cubic`).
* `rotate_180`: `cv2.rotate(img, cv2.ROTATE_180)`.
* `bgr2gray`, `erode`, `dilate`, `morph_gradient`, `morph_close`,
  `threshold_otsu`: `cv2.cvtColor(.., COLOR_BGR2GRAY)` in cv2 5.0's
  15-bit fixed point, the rectangular-kernel morphology with cv2's default border
  (outside pixels never win the min or the max), and
  `cv2.threshold(.., 0, 255, THRESH_BINARY + THRESH_OTSU)` with cv2's
  double-precision Otsu search, on uint8 images.
* `polylines2`: `cv2.polylines(img, [pts], True, color, 2)` (LINE_8) as
  cv2 5.0 draws it: each side clipped in whole pixels to the image grown
  by 2, a quadrilateral one pixel either side of it in 16.16 fixed point
  (outlined by cv2's fixed-point line, clipped in fixed point, and filled
  by its convex scanline fill), and a radius-1 disc at its end.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_COEF_BITS = 11                  # cv2's INTER_RESIZE_COEF_BITS
_REMAP_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / \
    "remap.cc"
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_REMAP_SIGNATURES = {
    "ocr_remap_cubic": (None, [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # src, h, w, c
        _F32P, _F32P, ctypes.c_int64, _U8P]),          # maps, n, out
}


def _as_image(img: np.ndarray, dtype=np.uint8) -> Tuple[np.ndarray, bool]:
    """→ (H, W, C) view of a `dtype` image, whether the input had no
    channel axis."""
    img = np.asarray(img)
    if img.dtype != dtype:
        raise TypeError(f"{np.dtype(dtype).name} images only, got {img.dtype}")
    if img.ndim == 2:
        return img[:, :, None], True
    if img.ndim != 3:
        raise ValueError(f"expected (H, W) or (H, W, C), got {img.shape}")
    return img, False


def _axis_taps(dst_n: int, src_n: int, scale: float, clamp_frac: bool,
               area: bool = False):
    """Source index and 11-bit coefficients of each destination position
    along one axis: (first tap (dst_n,) int64, (dst_n, 2) int32 weights).
    `area`: cv2's INTER_AREA taps where it enlarges (area_mode: the first
    tap floor(d · scale), the fraction of the destination pixel's end past
    that source pixel's)."""
    d = np.arange(dst_n, dtype=np.float64)
    if area:
        s = np.floor(d * scale)
        f = ((d + 1) - (s + 1) * (1.0 / scale)).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(
            np.float32)
    else:
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
    """cv2.resize(img, dsize, fx=fx, fy=fy) with INTER_LINEAR on a uint8 or
    float32 image of 1 or more channels ((H, W) or (H, W, C)). dsize =
    (width, height); without it the size is (round(W·fx), round(H·fy)),
    half to even, and the scales are 1/fx and 1/fy, as cv2 takes them."""
    if np.asarray(img).dtype == np.float32:
        return _resize_float(img, dsize, "linear")
    src, flat = _as_image(img)
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
                  scale_y: float, area: bool = False) -> np.ndarray:
    H, W, _ = src.shape
    sx, ax = _axis_taps(dw, W, scale_x, clamp_frac=True, area=area)
    sy, by = _axis_taps(dh, H, scale_y, clamp_frac=False, area=area)
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


def _dst_size(dsize) -> Tuple[int, int]:
    dw, dh = int(dsize[0]), int(dsize[1])
    if dw <= 0 or dh <= 0:
        raise ValueError(f"empty destination size {(dw, dh)}")
    return dw, dh


def _fma(a, b, c) -> np.ndarray:
    """a · b + c of float32 values (given as float32 or float64 holding
    float32 values) rounded once to float32, as an FMA instruction rounds
    it. The product is exact in float64, and so is the float32 rounding of
    the float64 sum except where that sum lies exactly halfway between two
    float32 values: there the sum's own rounding error (its TwoSum term)
    decides the side."""
    shape = np.broadcast_shapes(np.shape(a), np.shape(b), np.shape(c))
    s = np.empty(shape, np.float64)
    np.multiply(a, b, out=s, dtype=np.float64)
    np.add(s, c, out=s)
    out = s.astype(np.float32)
    # a float64 of a float32 halfway point ends in the bits 1000...0 (29 of
    # them); below 2^-125 float32's spacing is fixed, so those are checked
    # whole
    tie = np.bitwise_and(s.view(np.int64), 0x1FFFFFFF) == 0x10000000
    if out.size and np.abs(out).min() < 2.0 ** -125:
        tie |= np.abs(s) < 2.0 ** -125
    if tie.any():
        p = np.broadcast_to(np.multiply(a, b, dtype=np.float64), shape)[tie]
        c = np.broadcast_to(np.asarray(c, np.float64), shape)[tie]
        st = s[tie]
        cc = st - p
        err = (p - (st - cc)) + (c - cc)
        r = out[tie]
        nb = np.nextafter(r, np.where(st > r, np.float32(np.inf),
                                      np.float32(-np.inf)))
        mid = (r.astype(np.float64) + nb.astype(np.float64)) / 2
        flip = (st == mid) & (err != 0) & ((err > 0) == (nb > r))
        out[tie] = np.where(flip, nb, r)
    return out


def _resize_float(img: np.ndarray, dsize, kind: str) -> np.ndarray:
    """cv2.resize of a float32 image with INTER_LINEAR or INTER_CUBIC, as
    cv2 5.0's pip build computes it. Linear resizes, and cubic ones from 4
    pixels a side, go to IPP, whose float kernels differ with the host's
    ISA: this twin gives the values of IPP's AVX-512 code (the one
    `cv2.ipp.getIppVersion()` names on an AVX-512 host; OPENCV_IPP=avx2 or
    sse42 select others), for images of 1 or 3 channels (cubic: also 4).

    * INTER_LINEAR: each destination position in double, its fraction t
      rounded to float32, taps past the edge clamped to it (a position
      before the first or at or past the last source column takes that
      column whole), rows interpolated first, each as one fused
      multiply-add a + (b − a)·t, then the columns of the result the same
      way. With 3 channels the columns taken whole at either edge run in
      groups of 16 from the run's start, and when 5 or more are left
      over, channels 0 and 1 of those are interpolated down the columns
      as a product and a sum, each rounded.
    * INTER_CUBIC from a source under 4 pixels a side (cv2's generic
      path): the fraction of the float32 position, interpolateCubic's
      float32 weights (a = −0.75), taps clamped; the horizontal sums tap by
      tap from the left, the vertical ones as the 4-lane vector loop takes
      them, S0·b0 + (S1·b1 + (S2·b2 + S3·b3)), and the last (width · C) mod 4
      values of a row from the left as its scalar tail does.
    * INTER_CUBIC from 4 pixels a side on: `_ipp_cubic`."""
    src, flat = _as_image(img, np.float32)
    H, W, C = src.shape
    dw, dh = _dst_size(dsize)
    if (dw, dh) == (W, H):
        out = src.copy()
    elif kind == "linear":
        xs, x1, tx = _linear_taps(dw, W)
        ys, y1, ty = _linear_taps(dh, H)
        rows = _fma(src[:, x1] - src[:, xs], tx[None, :, None], src[:, xs])
        a, b, t = rows[ys], rows[y1], ty[:, None, None]
        out = _fma(b - a, t, a)
        if C == 3:
            pos = (np.arange(dw) + 0.5) * (W / dw) - 0.5
            for run in (np.nonzero(pos < 0)[0], np.nonzero(pos >= W - 1)[0]):
                rest = run[len(run) - len(run) % 16:]
                if len(rest) >= 5:
                    lo, hi = a[:, rest, :2], b[:, rest, :2]
                    out[:, rest, :2] = lo + (hi - lo) * t
    elif H >= 4 and W >= 4:
        out = _ipp_cubic(src, dw, dh)
    else:
        xs, wx = _cubic_taps(dw, W)
        ys, wy = _cubic_taps(dh, H)
        hor = None
        for k in range(4):
            t = src[:, xs[:, k]] * wx[None, :, k, None]
            hor = t if hor is None else hor + t
        terms = [hor[ys[:, k]] * wy[:, k, None, None] for k in range(4)]
        vec = terms[0] + (terms[1] + (terms[2] + terms[3]))
        tail = ((terms[0] + terms[1]) + terms[2]) + terms[3]
        out = vec.reshape(dh, -1)
        n = out.shape[1]
        out[:, n - n % 4:] = tail.reshape(dh, -1)[:, n - n % 4:]
        out = out.reshape(dh, dw, C)
    return out[:, :, 0] if flat else out


def _ipp_cubic(src: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """IPP's float32 cubic resize (its AVX-512 code; Keys' a = −0.75) of an
    (H, W, C) image, as its impulse responses and its sums of two taps
    show it, with `_ipp_cubic_taps`' weights. A destination pixel
    whose four taps lie inside the source on both axes is inner, the others
    take IPP's border code:

    * inner: each of the four source rows summed across — with one channel
      (p0·w0 + p1·w1) + (p2·w2 + p3·w3) for the values in whole groups of 4
      from the first inner column and (p0·w0 + p2·w2) + (p1·w1 + p3·w3)
      past them; with more channels fma(p0, w0, p3·w3) + fma(p1, w1,
      p2·w2) — then the four rows fma(r0, v0, r1·v1) + fma(r2, v2, r3·v3),
      past the last whole group of 4 values (columns × channels)
      fma(r1, v1, r0·v0) + fma(r2, v2, r3·v3).
    * border: rows 0 and 3 of the taps summed across by FMAs from p0·w0 on
      (p1, p2, p3 in turn), rows 1 and 2 from p1·w1 (then p0, p2, p3), taps
      clamped to the edge; then (r0·v0 + r2·v2) + (r1·v1 + r3·v3)."""
    H, W, C = src.shape
    xs, wx, inner_x = _ipp_cubic_taps(dw, W)
    ys, wy, inner_y = _ipp_cubic_taps(dh, H)
    P = [src[:, xs[:, k]] for k in range(4)]
    w = [wx[None, :, k, None] for k in range(4)]
    T = [P[k] * w[k] for k in range(4)]
    from_p1 = _fma(P[3], w[3], _fma(P[2], w[2], _fma(P[0], w[0], T[1])))
    from_p0 = _fma(P[3], w[3], _fma(P[2], w[2], _fma(P[1], w[1], T[0])))
    v = [wy[:, j, None, None] for j in range(4)]
    r = [(from_p0 if j in (0, 3) else from_p1)[ys[:, j]] for j in range(4)]
    out = (r[0] * v[0] + r[2] * v[2]) + (r[1] * v[1] + r[3] * v[3])
    if not (inner_x.any() and inner_y.any()):
        return out
    # the inner pixels form one block: its columns, then its rows
    cols, rows = (slice(np.argmax(m), len(m) - np.argmax(m[::-1]))
                  for m in (inner_x, inner_y))
    P, w, T = ([a[:, cols] for a in arrs] for arrs in (P, w, T))
    # each value's place among the inner ones, columns × channels
    n = cols.stop - cols.start
    grouped = (np.arange(n * C).reshape(1, n, C) < n * C // 4 * 4)
    if C == 1:
        hor = np.where(grouped, (T[0] + T[1]) + (T[2] + T[3]),
                       (T[0] + T[2]) + (T[1] + T[3]))
    else:
        hor = _fma(P[0], w[0], T[3]) + _fma(P[1], w[1], T[2])
    r = [hor[ys[rows, j]] for j in range(4)]
    v = [a[rows] for a in v]
    out[rows, cols] = np.where(
        grouped, _fma(r[0], v[0], r[1] * v[1]),
        _fma(r[1], v[1], r[0] * v[0])) + _fma(r[2], v[2], r[3] * v[3])
    return out


def _linear_taps(dst_n: int, src_n: int):
    """IPP's linear taps along one axis: (first, second source index,
    float32 fraction)."""
    x = (np.arange(dst_n) + 0.5) * (src_n / dst_n) - 0.5
    s = np.floor(x)
    t = x - s
    s = s.astype(np.int64)
    lo, hi = s < 0, s >= src_n - 1
    t = np.where(lo | hi, 0.0, t).astype(np.float32)
    s = np.where(lo, 0, np.where(hi, src_n - 1, s))
    return s, np.minimum(s + 1, src_n - 1), t


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


def _cubic_taps(dst_n: int, src_n: int):
    """cv2's cubic taps along one axis: (dst_n, 4) source indices, clamped,
    and their float32 weights, interpolateCubic in float32 at the fraction
    of the float32 position."""
    x = ((np.arange(dst_n) + 0.5) * (src_n / dst_n) - 0.5).astype(np.float32)
    s = np.floor(x)
    t = (x - s).astype(np.float32)
    idx = np.clip(s.astype(np.int64)[:, None] - 1 + np.arange(4)[None, :],
                  0, src_n - 1)
    return idx, np.stack(_cubic_weights(t), -1).astype(np.float32)


def _ipp_cubic_taps(dst_n: int, src_n: int):
    """IPP's cubic taps along one axis: (dst_n, 4) source indices, clamped;
    their float32 weights, the Keys kernel (a = −0.75) in float64 at the
    fraction of the double position rounded to float32 and then to a
    multiple of 2^-23 (1 + t − 1 in float32), rounded to float32; and
    whether all four taps lie inside."""
    x = (np.arange(dst_n) + 0.5) * (src_n / dst_n) - 0.5
    s = np.floor(x)
    one = np.float32(1)
    t = ((one + (x - s).astype(np.float32)) - one).astype(np.float64)
    first = s.astype(np.int64) - 1
    idx = np.clip(first[:, None] + np.arange(4)[None, :], 0, src_n - 1)
    a = -0.75
    w = [a * t ** 3 - 2 * a * t ** 2 + a * t,
         (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
         -(a + 2) * t ** 3 + (2 * a + 3) * t ** 2 - a * t,
         -a * t ** 3 + a * t ** 2]
    inside = (first >= 0) & (first + 3 <= src_n - 1)
    return idx, np.stack(w, -1).astype(np.float32), inside


def resize_cubic(img: np.ndarray, dsize: Sequence[int]) -> np.ndarray:
    """cv2.resize(img, dsize, interpolation=cv2.INTER_CUBIC) on a float32
    image ((H, W) or (H, W, C)); dsize = (width, height)."""
    return _resize_float(img, dsize, "cubic")


def resize_nearest(img: np.ndarray, dsize: Sequence[int]) -> np.ndarray:
    """cv2.resize(img, dsize, interpolation=cv2.INTER_NEAREST): destination
    pixel (x, y) takes source (floor(x · W / w), floor(y · H / h)), the
    products in double with cv2's 1 / (w / W), clamped to the last."""
    src = np.asarray(img)
    H, W = src.shape[:2]
    dw, dh = _dst_size(dsize)
    fx, fy = 1.0 / (dw / W), 1.0 / (dh / H)
    xs = np.minimum(np.floor(np.arange(dw) * fx).astype(np.int64), W - 1)
    ys = np.minimum(np.floor(np.arange(dh) * fy).astype(np.int64), H - 1)
    return np.ascontiguousarray(src[ys][:, xs])


def _area_tab(src_n: int, dst_n: int, scale: float):
    """cv2's computeResizeAreaTab: (destination, source, float32 weight)
    triples in cv2's order."""
    tab = []
    for dx in range(dst_n):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src_n - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, src_n - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            tab.append((dx, sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            tab.append((dx, sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            tab.append((dx, sx2, np.float32(
                min(min(fsx2 - sx2, 1.0), cell) / cell)))
    return tab


def _tab_arrays(tab, dst_n: int):
    """The triples grouped by destination: (dst_n, k) source indices and
    weights, k the largest group, the missing entries of weight 0 at
    source 0 (adding 0 to a sum is exact)."""
    k = max(sum(1 for t in tab if t[0] == d) for d in range(dst_n))
    idx = np.zeros((dst_n, k), np.int64)
    w = np.zeros((dst_n, k), np.float32)
    fill = np.zeros(dst_n, np.int64)
    for d, s, a in tab:
        idx[d, fill[d]] = s
        w[d, fill[d]] = a
        fill[d] += 1
    return idx, w, fill


def resize_area(img: np.ndarray, dsize: Sequence[int]) -> np.ndarray:
    """cv2.resize(img, dsize, interpolation=cv2.INTER_AREA) on a uint8 image
    ((H, W) or (H, W, C)). Reducing on both axes: for integer factors cv2's
    resizeAreaFast_ (each block's integer sum, rounded), else its
    ResizeArea_Invoker — computeResizeAreaTab's float32 weights, each
    source row's weighted columns summed into a float32 row in table order,
    the rows weighted and summed in float32, rounded half to even.
    Enlarging on either axis: the fixed-point linear resize of
    `resize_linear` on cv2's area-mode taps."""
    src, flat = _as_image(img)
    H, W, C = src.shape
    dw, dh = _dst_size(dsize)
    sx, sy = 1.0 / (dw / W), 1.0 / (dh / H)
    if sx < 1 or sy < 1:
        # enlarging on either axis: cv2's linear path with area-mode taps
        out = _resize_fixed(src, dw, dh, sx, sy, area=True)
        return out[:, :, 0] if flat else out
    ix, iy = int(round(sx)), int(round(sy))
    if abs(sx - ix) < np.finfo(np.float64).eps and \
            abs(sy - iy) < np.finfo(np.float64).eps:
        if (dw, dh) == (W, H):
            out = src.copy()
        else:
            blocks = src[:dh * iy, :dw * ix].astype(np.int32).reshape(
                dh, iy, dw, ix, C).sum(axis=(1, 3))
            area = ix * iy
            if area == 4:    # ResizeAreaFastVec: (sum + 2) >> 2
                out = ((blocks + 2) >> 2).astype(np.uint8)
            else:            # saturate_cast<uchar>(sum * (1 / area))
                out = np.clip(np.rint(blocks.astype(np.float32) *
                                      np.float32(1.0 / area)), 0, 255
                              ).astype(np.uint8)
        return out[:, :, 0] if flat else out
    xi, xw, _ = _tab_arrays(_area_tab(W, dw, sx), dw)
    ytab = _area_tab(H, dh, sy)
    f32 = np.float32
    row_cache = {}

    def row(s):
        if s not in row_cache:
            S = src[s].astype(f32)                        # (W, C)
            buf = np.zeros((dw, C), f32)
            for k in range(xi.shape[1]):
                buf = buf + S[xi[:, k]] * xw[:, k, None]
            row_cache[s] = buf
        return row_cache[s]

    out = np.empty((dh, dw, C), np.uint8)
    acc, prev = None, 0
    for d, s, beta in ytab:
        term = beta * row(s)
        if acc is None or d != prev:
            if acc is not None:
                out[prev] = np.clip(np.rint(acc), 0, 255)
            acc, prev = term, d
        else:
            acc = acc + term
    out[prev] = np.clip(np.rint(acc), 0, 255)
    return out[:, :, 0] if flat else out


# ------------------------------------------------------- GaussianBlur
# cv2's kernels for ksize 3 and 5 at sigma 0 (getGaussianKernel's small
# table), in 1/256: exact in its 8.8 fixed point and in float32
_GAUSS = {3: (64, 128, 64), 5: (16, 64, 96, 64, 16)}


def _reflect101(n: int, pad: int) -> np.ndarray:
    """Source indices of 0 - pad .. n - 1 + pad under BORDER_REFLECT_101."""
    i = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def gaussian_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """cv2.GaussianBlur(img, (ksize, ksize), 0) for ksize 3 or 5 (default
    border, BORDER_REFLECT_101) on a uint8 or float32 image ((H, W) or
    (H, W, C)). uint8 takes cv2's bit-exact fixed-point path: rows then
    columns in 8.8 fixed point, exact, then (v + 2^15) >> 16. float32 is
    the separable float filter with the symmetric kernel, each pass
    k_c · S_c + k_1 · (S_−1 + S_1) (+ k_2 · (S_−2 + S_2))."""
    if ksize not in _GAUSS:
        raise ValueError(f"ksize 3 or 5, got {ksize}")
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        src, flat = _as_image(arr)
    else:
        src, flat = _as_image(arr, np.float32)
    H, W, C = src.shape
    r = ksize // 2
    k = _GAUSS[ksize]
    cols = _reflect101(W, r)
    rows = _reflect101(H, r)
    if src.dtype == np.uint8:
        x = src.astype(np.int64)
        hor = sum(k[j] * x[:, cols[j:j + W]] for j in range(ksize))
        ver = sum(k[j] * hor[rows[j:j + H]] for j in range(ksize))
        out = ((ver + (1 << 15)) >> 16).astype(np.uint8)
    else:
        f = [np.float32(v / 256.0) for v in k]

        def smooth(a, idx, axis, n):
            def tap(j):
                return np.take(a, idx[j:j + n], axis=axis)
            acc = tap(r) * f[r] + (tap(r - 1) + tap(r + 1)) * f[r - 1]
            if r == 2:
                acc = acc + (tap(0) + tap(4)) * f[0]
            return acc.astype(np.float32)
        out = smooth(smooth(src, cols, 1, W), rows, 0, H)
    return out[:, :, 0] if flat else out


def copy_make_border(img: np.ndarray, top: int, bottom: int, left: int,
                     right: int, value) -> np.ndarray:
    """cv2.copyMakeBorder(img, top, bottom, left, right,
    cv2.BORDER_CONSTANT, value=value)."""
    src = np.asarray(img)
    H, W = src.shape[:2]
    out = np.empty((H + top + bottom, W + left + right) + src.shape[2:],
                   src.dtype)
    v = np.asarray(value, np.float64)
    if src.ndim == 3:
        v = np.resize(v, src.shape[2]) if v.size else np.zeros(src.shape[2])
    else:
        v = v.reshape(-1)[:1] if v.size else np.zeros(1)
    out[...] = v.astype(src.dtype) if src.ndim == 3 else v[0].astype(
        src.dtype)
    out[top:top + H, left:left + W] = src
    return out


# ------------------------------------------------------- warpPerspective
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
    uint8 image with float32 maps, as cv2 5.0 computes it on a host with
    AVX2 and FMA (its SSE-only kernels round some values the other way),
    in host C++ (csrc/host/remap.cc). Each position is first clamped to
    [−K, 2K], K = max(width, 16) (or height), NaN to −K; its float32
    fraction t gives the weights a·t·s², ((a + 2)·t − (a + 3))·t² + 1 (two
    FMAs), a·t²·s and 1 less those three (s = 1 − t, a = −0.75); the 4 × 4
    taps around it are clamped to the border, each row summed from the
    left by FMAs after a first product, the four rows from the top the
    same way, and the sum rounded half to even and saturated. An empty
    source raises ValueError (cv2.warpPerspective refuses one; cv2.remap
    reads past it)."""
    src, flat = _as_image(img)
    src = np.ascontiguousarray(src)
    H, W, C = src.shape
    if H == 0 or W == 0:
        raise ValueError(f"empty source image {src.shape}")
    X = np.ascontiguousarray(map_x, np.float32)
    Y = np.ascontiguousarray(map_y, np.float32)
    if X.shape != Y.shape:
        raise ValueError(f"map shapes differ: {X.shape} and {Y.shape}")
    out = np.empty(X.shape + (C,), np.uint8)
    from ..ops import native
    native.load(_REMAP_SOURCE, "libocrremap", _REMAP_SIGNATURES) \
        .ocr_remap_cubic(src.ctypes.data_as(_U8P), H, W, C,
                         X.ctypes.data_as(_F32P), Y.ctypes.data_as(_F32P),
                         X.size, out.ctypes.data_as(_U8P))
    return out[..., 0] if flat else out


def warp_perspective_cubic(img: np.ndarray, M: np.ndarray,
                           dsize: Sequence[int]) -> np.ndarray:
    """cv2.warpPerspective(img, M, dsize, flags=INTER_CUBIC,
    borderMode=BORDER_REPLICATE) on a uint8 image, as cv2 5.0 computes it
    on a host with AVX2 and FMA: M maps source to destination, dsize =
    (width, height). cv2's inverse of M is rounded to float32; each row's
    constants y·m1 + m2, y·m4 + m5, y·m7 + m8 are float32 products and
    sums; each pixel's x·m0 + row constant (and the other two) and their
    quotients are taken in double and the quotients rounded to float32
    (a zero denominator gives an infinite or NaN position, which the
    sampler clamps); `remap_cubic` samples there."""
    w, h = int(dsize[0]), int(dsize[1])
    if w <= 0 or h <= 0:
        raise ValueError(f"empty destination size {(w, h)}")
    m = invert_3x3(M).astype(np.float32).ravel()
    x = np.arange(w, dtype=np.float64)[None, :]
    y = np.arange(h, dtype=np.float32)[:, None]
    num = [x * np.float64(m[k]) + (y * m[k + 1] + m[k + 2]).astype(
        np.float64) for k in (0, 3, 6)]
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = (num[0] / num[2]).astype(np.float32)
        sy = (num[1] / num[2]).astype(np.float32)
    return remap_cubic(img, sx, sy)


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


def _fill_convex(img, pts, color, shift: int = _XY_SHIFT):
    """cv2's FillConvexPoly (LINE_8) of vertices with `shift` fractional
    bits (16: 16.16 fixed point, the outline by Line2; 0: whole pixels,
    the outline by the integer Line)."""
    h, w = img.shape[:2]
    n = len(pts)
    delta = 1 << (shift - 1) if shift else 0
    up = _XY_SHIFT - shift
    p0 = pts[-1]
    for p in pts:
        if shift:
            _line_fixed(img, p0, p, color)
        else:
            _line_int(img, p0, p, color)
        p0 = p
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    imin = int(np.argmin(ys))
    xmin, xmax = (min(xs) + delta) >> shift, (max(xs) + delta) >> shift
    ymin, ymax = (min(ys) + delta) >> shift, (max(ys) + delta) >> shift
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
                    ty = (pts[idx][1] + delta) >> shift
                    if ty > y:
                        xs_, xe = pts[idx0][0] << up, pts[idx][0] << up
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
            x1 = (edge[left]["x"] + (_XY_ONE >> 1)) >> 16
            x2 = (edge[right]["x"] + (_XY_ONE >> 1)) >> 16
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _line_int(img, p1, p2, color):
    """cv2's Line (LINE_8): its LineIterator from the left end, clipped to
    the image (clipLine) when an end lies outside it."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = p1, p2
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        x1, y1, dx, dy = x2, y2, -dx, -dy
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    # err < 0 before a step moves the minor axis (cv2's mask)
    k = np.arange(major + 1, dtype=np.int64)
    err0 = major - 2 * minor
    # err after k steps: err0 - 2·minor·k + 2·major·(minor steps so far);
    # the minor steps are the Bresenham count, computed by a running sum
    steps = np.zeros(major + 1, np.int64)
    err = err0
    for i in range(1, major + 1):
        m = err < 0
        steps[i] = steps[i - 1] + m
        err += -2 * minor + (2 * major if m else 0)
    if vert:
        xs, ys = x1 + steps, y1 + sy * k
    else:
        xs, ys = x1 + k, y1 + sy * steps
    _put(img, xs, ys, color)


def _circle(img, cx: int, cy: int, radius: int, color, fill: bool):
    """cv2's Circle (LINE_8, whole pixels): Bresenham's octants, spans when
    filled, clipped to the image."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    xs, ys = [], []
    while dx >= dy:
        for (yy, xa, xb) in ((cy - dy, cx - dx, cx + dx),
                             (cy + dy, cx - dx, cx + dx),
                             (cy - dx, cx - dy, cx + dy),
                             (cy + dx, cx - dy, cx + dy)):
            if not 0 <= yy < h:
                continue
            if fill:
                a, b = max(xa, 0), min(xb, w - 1)
                if a <= b:
                    img[yy, a:b + 1] = color
            else:
                xs += [xa, xb]
                ys += [yy, yy]
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    if xs:
        _put(img, np.array(xs), np.array(ys), color)


def _thick_line(img, p0, p1, color, thickness: int, caps: int,
                shift: int = 0):
    """cv2's ThickLine (LINE_8) between two points with `shift` fractional
    bits: thickness 1 a line, else the quadrilateral ± thickness / 2 about
    it in 16.16 fixed point filled by FillConvexPoly, and a filled circle
    of radius round(thickness / 2) at the ends `caps` names (bit 0: p0,
    bit 1: p1)."""
    up = _XY_SHIFT - shift
    p0 = (p0[0] << up, p0[1] << up)
    p1 = (p1[0] << up, p1[1] << up)
    half = _XY_ONE >> 1
    if thickness <= 1:
        if shift == 0:
            _line_int(img, ((p0[0] + half) >> 16, (p0[1] + half) >> 16),
                      ((p1[0] + half) >> 16, (p1[1] + half) >> 16), color)
        else:
            _line_fixed(img, p0, p1, color)
        return
    dx = (p0[0] - p1[0]) / _XY_ONE
    dy = (p1[1] - p0[1]) / _XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (_XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (t + odd * _XY_ONE * 0.5) / np.sqrt(r)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(img, [(p0[0] + ox, p0[1] + oy), (p0[0] - ox, p0[1] - oy),
                           (p1[0] - ox, p1[1] - oy), (p1[0] + ox, p1[1] + oy)],
                     color)
    for i, p in enumerate((p0, p1)):
        if caps & (1 << i):
            _circle(img, (p[0] + half) >> 16, (p[1] + half) >> 16,
                    (t + half) >> 16, color, True)


def _color(img, color):
    c = np.asarray(color, np.float64).reshape(-1)
    n = img.shape[2] if img.ndim == 3 else 1
    c = np.resize(c, n) if c.size < n else c[:n]
    return np.clip(np.rint(c), 0, 255).astype(img.dtype) if n > 1 else \
        np.clip(np.rint(c[0]), 0, 255).astype(img.dtype)


def line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """cv2.line(img, p1, p2, color, thickness) in place (LINE_8, integer
    points) → img."""
    _thick_line(img, (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1])),
                _color(img, color), int(thickness), 3)
    return img


def rectangle(img: np.ndarray, p1, p2, color, thickness: int = 1
              ) -> np.ndarray:
    """cv2.rectangle(img, p1, p2, color, thickness) in place (LINE_8;
    thickness -1 fills): the closed outline p1, (p2.x, p1.y), p2, (p1.x,
    p2.y), each side capped at its end only, as cv2's PolyLine draws it
    → img."""
    c = _color(img, color)
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    if thickness < 0:
        _fill_convex(img, pts, c, shift=0)
        return img
    p0 = pts[-1]
    for p in pts:
        _thick_line(img, p0, p, c, int(thickness), 2)
        p0 = p
    return img


# cv2's SinTable: sin of each whole degree 0..450 to 7 decimals, in float32
_SIN_TABLE = np.array([float(f"{np.sin(np.radians(d)):.7f}")
                       for d in range(451)], np.float32)


def circle(img: np.ndarray, center, radius: int, color,
           thickness: int = 1) -> np.ndarray:
    """cv2.circle(img, center, radius, color, thickness) in place (LINE_8):
    thickness 1 is the Bresenham circle; thicker ones are cv2's EllipseEx,
    ellipse2Poly's points (every 90, 30, 18 or 5 degrees by the radius) in
    16.16 fixed point joined by an open thick polyline → img."""
    c = _color(img, color)
    cx, cy, radius = int(center[0]), int(center[1]), int(radius)
    if thickness <= 1:
        _circle(img, cx, cy, radius, c, thickness < 0)
        return img
    ax = radius << _XY_SHIFT
    delta = (ax + (_XY_ONE >> 1)) >> _XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 \
        else 5
    pts, prev = [], None
    for ang in range(0, 360 + delta, delta):
        ang = min(ang, 360)
        x = (cx << _XY_SHIFT) + ax * float(_SIN_TABLE[450 - ang])
        y = (cy << _XY_SHIFT) + ax * float(_SIN_TABLE[ang])
        px = (int(np.rint(x / _XY_ONE)) << _XY_SHIFT)
        py = (int(np.rint(y / _XY_ONE)) << _XY_SHIFT)
        px += int(np.rint(x - px))
        py += int(np.rint(y - py))
        if (px, py) != prev:
            pts.append((px, py))
            prev = (px, py)
    if len(pts) == 1:
        pts = [(cx << _XY_SHIFT, cy << _XY_SHIFT)] * 2
    caps = 3
    for a, b in zip(pts[:-1], pts[1:]):
        _thick_line(img, a, b, c, int(thickness), caps, shift=_XY_SHIFT)
        caps = 2
    return img


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


# -------------------------------------------- grey, morphology, Otsu
def bgr2gray(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) of a uint8 BGR image as cv2
    5.0 computes it: (B·3735 + G·19235 + R·9798 + 2^14) >> 15 (the 14-bit
    coefficients of cv2 4 round a few pixels in 10^3 the other way)."""
    img = np.asarray(img, np.uint8).astype(np.int32)
    return ((img[..., 0] * 3735 + img[..., 1] * 19235 + img[..., 2] * 9798 +
             (1 << 14)) >> 15).astype(np.uint8)


def _morph(img: np.ndarray, kh: int, kw: int, take, pad: int) -> np.ndarray:
    """A kh x kw rectangular min or max (anchor at the centre) of a 2-D
    uint8 image, the border padded with `pad`, which never wins."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape
    ay, ax = kh // 2, kw // 2
    rows = np.pad(img, ((0, 0), (ax, kw - 1 - ax)), constant_values=pad)
    out = rows[:, 0:w]
    for dx in range(1, kw):
        out = take(out, rows[:, dx:dx + w])
    cols = np.pad(out, ((ay, kh - 1 - ay), (0, 0)), constant_values=pad)
    out = cols[0:h]
    for dy in range(1, kh):
        out = take(out, cols[dy:dy + h])
    return np.ascontiguousarray(out)


def erode(img: np.ndarray, ksize: Sequence[int]) -> np.ndarray:
    """cv2.erode(img, np.ones(ksize, np.uint8)) of a 2-D uint8 image."""
    return _morph(img, ksize[0], ksize[1], np.minimum, 255)


def dilate(img: np.ndarray, ksize: Sequence[int]) -> np.ndarray:
    """cv2.dilate(img, np.ones(ksize, np.uint8)) of a 2-D uint8 image."""
    return _morph(img, ksize[0], ksize[1], np.maximum, 0)


def morph_gradient(img: np.ndarray, ksize: Sequence[int]) -> np.ndarray:
    """cv2.morphologyEx(img, MORPH_GRADIENT, np.ones(ksize, np.uint8))."""
    return dilate(img, ksize) - erode(img, ksize)


def morph_close(img: np.ndarray, ksize: Sequence[int]) -> np.ndarray:
    """cv2.morphologyEx(img, MORPH_CLOSE, np.ones(ksize, np.uint8))."""
    return erode(dilate(img, ksize), ksize)


def threshold_otsu(img: np.ndarray) -> Tuple[float, np.ndarray]:
    """cv2.threshold(img, 0, 255, THRESH_BINARY + THRESH_OTSU) of a uint8
    image → (the threshold, the 0 / 255 image): the level of the largest
    between-class variance, searched in double as cv2 searches it (the
    first of equal maxima)."""
    img = np.asarray(img, np.uint8)
    hist = np.bincount(img.ravel(), minlength=256)
    scale = 1.0 / img.size
    mu = 0.0
    for i in range(256):
        mu += i * float(hist[i])
    mu *= scale
    mu1 = q1 = max_sigma = 0.0
    best = 0
    eps = float(np.finfo(np.float32).eps)
    for i in range(256):
        p_i = float(hist[i]) * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, best = sigma, i
    return float(best), np.where(img > best, 255, 0).astype(np.uint8)

"""Numpy twins of the PIL image operations of the PDF rasteriser
(batch/pdf_raster.py), for a machine without PIL. Each computes what
Pillow 12's C code (libImaging) computes, on (H, W, 3) uint8 RGB arrays and
(H, W) uint8 'L' masks:

* `new`: `Image.new('RGB', (w, h), color)`;
* `rectangle`: `ImageDraw.rectangle(xy, fill)` — corners truncated to int,
  both edges inclusive, clipped;
* `paste`: `Image.paste(src, (x, y), mask)` — clipped, an 'L' mask blended
  as libImaging's BLEND rounds it;
* `resize_bicubic`: `Image.resize((w, h))` at its default (BICUBIC):
  separable, horizontal pass first, support widened by the scale when
  reducing, 22-bit fixed-point coefficients, 8-bit intermediate;
* `transform_affine`: `Image.transform(size, AFFINE, coeffs, resample)` —
  BILINEAR through the generic transform (pixel centres, edge clamp,
  truncated, outside → 0), NEAREST through libImaging's scale path, its 16.16
  fixed-point path or its float path, as it picks them;
* `rotate`: `Image.rotate(angle, expand=False, fillcolor=...)` — the
  reverse matrix Pillow builds around the centre, rounded to 15 places,
  through `transform_affine` at NEAREST;
* `gaussian_blur`: `Image.filter(ImageFilter.GaussianBlur(radius))` —
  libImaging's three passes of the extended box blur in each direction,
  the box radius computed in single precision, 8.24 fixed-point weights,
  8-bit rounding after each pass.

The held-out page generator's JPEG round trip (`Image.save(..., 'JPEG',
quality=q)` then `np.asarray(Image.open(...))`) is `utils/imcodec.py`'s
`imencode_jpeg` (libjpeg-turbo's encoder at Pillow's settings) and
`jpeg_pil_rgb`.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def new(size: Tuple[int, int], color=(255, 255, 255)) -> np.ndarray:
    """An RGB image of `size` = (w, h) filled with `color`."""
    w, h = size
    out = np.empty((h, w, 3), np.uint8)
    out[:] = np.asarray(color, np.uint8)
    return out


def rectangle(img: np.ndarray, xy: Sequence[float], fill) -> None:
    """Fill the rectangle [x0, x1] x [y0, y1] (corners truncated toward
    zero, both edges included) with `fill`, in place."""
    x0, y0, x1, y1 = (int(v) for v in xy)
    if x1 < x0:
        x0, x1 = x1, x0
    if y1 < y0:
        y0, y1 = y1, y0
    h, w = img.shape[:2]
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, w - 1), min(y1, h - 1)
    if x0 <= x1 and y0 <= y1:
        img[y0:y1 + 1, x0:x1 + 1] = np.asarray(fill, np.uint8)


def paste(img: np.ndarray, src: np.ndarray, xy: Tuple[int, int],
          mask: Optional[np.ndarray] = None) -> None:
    """Paste `src` with its top-left corner at xy, in place; with an 'L'
    mask each channel is (dst * (255 - m) + src * m) / 255, rounded."""
    x, y = int(xy[0]), int(xy[1])
    sh, sw = src.shape[:2]
    h, w = img.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + sw, w), min(y + sh, h)
    if x1 <= x0 or y1 <= y0:
        return
    part = src[y0 - y:y1 - y, x0 - x:x1 - x]
    if mask is None:
        img[y0:y1, x0:x1] = part
        return
    m = mask[y0 - y:y1 - y, x0 - x:x1 - x].astype(np.int32)[:, :, None]
    t = img[y0:y1, x0:x1].astype(np.int32) * (255 - m) + \
        part.astype(np.int32) * m + 128
    img[y0:y1, x0:x1] = (((t >> 8) + t) >> 8).astype(np.uint8)


# ---------------------------------------------------------------- resize
def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int):
    """libImaging's precompute_coeffs + normalize_coeffs_8bpc: per output
    index its first source index, tap count and 22-bit coefficients."""
    support0 = 2.0
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic((np.arange(xmax) + xmin - center + 0.5) * ss)
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        fixed = w * (1 << PRECISION_BITS)
        kk[xx, :xmax] = np.where(fixed < 0, (-0.5 + fixed).astype(np.int64),
                                 (0.5 + fixed).astype(np.int64))
        bounds[xx] = (xmin, xmax)
    return bounds, kk


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _pass(img: np.ndarray, bounds, kk, axis: int, rows: int = 256
          ) -> np.ndarray:
    """One separable pass along `axis` (1: columns of each row, 0: rows)."""
    out_n = len(bounds)
    if axis == 0:
        img = img.transpose(1, 0, 2)
    h = img.shape[0]
    out = np.empty((h, out_n, img.shape[2]), np.uint8)
    ksize = kk.shape[1]
    idx = bounds[:, :1] + np.arange(ksize)[None, :]
    valid = np.arange(ksize)[None, :] < bounds[:, 1:2]
    idx = np.where(valid, idx, 0)
    coef = np.where(valid, kk, 0)
    for r0 in range(0, h, rows):
        src = img[r0:r0 + rows].astype(np.int64)
        acc = np.full((src.shape[0], out_n, img.shape[2]),
                      1 << (PRECISION_BITS - 1), np.int64)
        for k in range(ksize):
            acc += src[:, idx[:, k]] * coef[None, :, k, None]
        out[r0:r0 + rows] = _clip8(acc)
    return out.transpose(1, 0, 2) if axis == 0 else out


def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`Image.fromarray(img).resize(size)` (BICUBIC) for (H, W, C) uint8."""
    w, h = int(size[0]), int(size[1])
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    ih, iw = img.shape[:2]
    if (w, h) == (iw, ih):
        out = img.copy()
        return out[:, :, 0] if squeeze else out
    bx, kx = _coeffs(iw, w)
    by, ky = _coeffs(ih, h)
    out = img
    if w != iw:
        # only the source rows the vertical pass reads
        first = int(by[0, 0])
        last = int(by[-1, 0] + by[-1, 1])
        out = _pass(img[first:last], bx, kx, axis=1)
        by = by.copy()
        by[:, 0] -= first
    if h != ih:
        out = _pass(out, by, ky, axis=0)
    return out[:, :, 0] if squeeze else out


# ------------------------------------------------------------- transform
def _coord(v: np.ndarray) -> np.ndarray:
    """libImaging's COORD: negative → -1, else truncated."""
    v = np.asarray(v, np.float64)
    return np.where(v < 0.0, -1, np.trunc(np.maximum(v, 0.0))).astype(
        np.int64)


def _steps(start: float, step: float, n: int) -> np.ndarray:
    """start, start + step, ... summed one step at a time in doubles."""
    seq = np.full(n, step, np.float64)
    if n:
        seq[0] = start
    return np.add.accumulate(seq)


def transform_affine(img: np.ndarray, size: Tuple[int, int], coeffs,
                     resample: str = "nearest", fillcolor=None) -> np.ndarray:
    """`Image.fromarray(img).transform(size, Image.AFFINE, coeffs,
    resample, fillcolor=fillcolor)` for (H, W, 3) RGB or (H, W) 'L' uint8
    (outside the source: 0, or `fillcolor`); input (x, y) = (a x + b y + c,
    d x + e y + f) at output pixel centres."""
    w, h = int(size[0]), int(size[1])
    a = [float(v) for v in coeffs[:6]]
    img = np.asarray(img)
    squeeze = img.ndim == 2
    src = img[:, :, None] if squeeze else img
    ih, iw, nb = src.shape
    out = np.zeros((h, w, nb), np.uint8)
    fill = np.zeros(nb, np.uint8)
    if fillcolor is not None:
        fill[:] = fillcolor
        out[...] = fill
    if w <= 0 or h <= 0:
        return out[:, :, 0] if squeeze else out
    ys, xs = np.mgrid[0:h, 0:w]
    if resample == "bilinear":
        xin = a[0] * (xs + 0.5) + a[1] * (ys + 0.5) + a[2]
        yin = a[3] * (xs + 0.5) + a[4] * (ys + 0.5) + a[5]
        inside = (xin >= 0.0) & (xin < iw) & (yin >= 0.0) & (yin < ih)
        xf, yf = xin - 0.5, yin - 0.5
        x0 = np.floor(xf).astype(np.int64)
        y0 = np.floor(yf).astype(np.int64)
        dx, dy = (xf - x0)[:, :, None], (yf - y0)[:, :, None]
        xa, xb = np.clip(x0, 0, iw - 1), np.clip(x0 + 1, 0, iw - 1)
        ya = np.clip(y0, 0, ih - 1)
        row1 = y0 + 1
        has2 = (row1 >= 0) & (row1 < ih)
        yb = np.clip(row1, 0, ih - 1)
        s = src.astype(np.float64)
        v1 = s[ya, xa] + (s[ya, xb] - s[ya, xa]) * dx
        v2 = s[yb, xa] + (s[yb, xb] - s[yb, xa]) * dx
        v2 = np.where(has2[:, :, None], v2, v1)
        v = v1 + (v2 - v1) * dy
        vals = _coord(v)
        out = np.where(inside[:, :, None], vals, fill).astype(np.uint8)
    elif a[1] == 0 and a[3] == 0:
        # ImagingScaleAffine
        xin = _coord(_steps(a[2] + a[0] * 0.5, a[0], w))
        yin = _coord(_steps(a[5] + a[4] * 0.5, a[4], h))
        okx = (xin >= 0) & (xin < iw)
        oky = (yin >= 0) & (yin < ih)
        if okx.any():
            xmin = int(np.argmax(okx))
            xmax = int(w - np.argmax(okx[::-1]))
            cols = np.where(okx[xmin:xmax], xin[xmin:xmax], 0)
            for y in np.nonzero(oky)[0]:
                out[y, xmin:xmax] = src[yin[y], cols]
    elif all(abs(px * a[0] + py * a[1] + a[2]) < 32768.0 and
             abs(px * a[3] + py * a[4] + a[5]) < 32768.0
             for px, py in ((0, 0), (w, h), (0, h), (w, 0))):
        # affine_fixed: 16.16 accumulation
        def fix(v):
            return int(math.floor(v * 65536.0 + 0.5))
        a0, a1, a3, a4 = fix(a[0]), fix(a[1]), fix(a[3]), fix(a[4])
        a2 = fix(a[2] + a[0] * 0.5 + a[1] * 0.5)
        a5 = fix(a[5] + a[3] * 0.5 + a[4] * 0.5)
        xx = a2 + a1 * ys + a0 * xs
        yy = a5 + a4 * ys + a3 * xs
        xi, yi = xx >> 16, yy >> 16
        ok = (xi >= 0) & (xi < iw) & (yi >= 0) & (yi < ih)
        out[ok] = src[yi[ok], xi[ok]]
    else:
        # float accumulation, stepped as libImaging steps it
        xo = _steps(a[2] + a[1] * 0.5 + a[0] * 0.5, a[1], h)
        yo = _steps(a[5] + a[4] * 0.5 + a[3] * 0.5, a[4], h)
        for y in range(h):
            xi = _coord(_steps(xo[y], a[0], w))
            yi = _coord(_steps(yo[y], a[3], w))
            ok = (xi >= 0) & (xi < iw) & (yi >= 0) & (yi < ih)
            out[y, ok] = src[yi[ok], xi[ok]]
    return out[:, :, 0] if squeeze else out


def rotate(img: np.ndarray, angle: float, fillcolor=(255, 255, 255)
           ) -> np.ndarray:
    """`Image.fromarray(img).rotate(angle, expand=False,
    fillcolor=fillcolor)` (NEAREST) for (H, W, 3) RGB uint8, at an angle
    that is not a multiple of 90 degrees (Pillow transposes there)."""
    angle = angle % 360.0
    if angle % 90.0 == 0:
        raise ValueError(f"{angle}: a multiple of 90 degrees")
    img = np.asarray(img)
    h, w = img.shape[:2]
    cx, cy = w / 2, h / 2
    theta = -math.radians(angle)
    m = [round(math.cos(theta), 15), round(math.sin(theta), 15), 0.0,
         round(-math.sin(theta), 15), round(math.cos(theta), 15), 0.0]
    x, y = -cx, -cy
    m[2], m[5] = m[0] * x + m[1] * y + m[2], m[3] * x + m[4] * y + m[5]
    m[2] += cx
    m[5] += cy
    return transform_affine(img, (w, h), m, "nearest", fillcolor=fillcolor)


BLUR_PASSES = 3  # ImageFilter.GaussianBlur's box blurs in each direction


def _box_radius(radius: float) -> np.float32:
    """libImaging's _gaussian_blur_radius, in single precision."""
    f = np.float32
    r = f(radius)
    sigma2 = f(r * r / f(BLUR_PASSES))
    big_l = f(math.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = f(math.floor((float(big_l) - 1.0) / 2.0))
    a = f((f(2) * small_l + f(1)) * (small_l * (small_l + f(1)) -
                                     f(3) * sigma2))
    a = f(a / (f(6) * (sigma2 - (small_l + f(1)) * (small_l + f(1)))))
    return f(small_l + a)


def _box_blur_rows(img: np.ndarray, radius_f: np.float32) -> np.ndarray:
    """ImagingHorizontalBoxBlur: every row of (H, W, C) uint8 at once."""
    radius = int(radius_f)
    ww = int(np.float32(np.float32(1 << 24) /
                        (radius_f * np.float32(2) + np.float32(1))))
    fw = ((1 << 24) - (radius * 2 + 1) * ww) // 2
    w = img.shape[1]
    lastx = w - 1
    edge_a = min(radius + 1, w)
    edge_b = max(w - radius - 1, 0)
    line = img.astype(np.uint64)
    mask = np.uint64(0xFFFFFFFF)
    acc = line[:, 0] * np.uint64(radius + 1)
    for x in range(edge_a - 1):
        acc = acc + line[:, x]
    acc = acc + line[:, lastx] * np.uint64(radius - edge_a + 1)
    out = np.empty_like(img)
    ww64, fw64 = np.uint64(ww), np.uint64(fw)

    def step(x, sub, add, left, right):
        nonlocal acc
        acc = (acc + line[:, add] - line[:, sub]) & mask
        bulk = (acc * ww64 + (line[:, left] + line[:, right]) * fw64) & mask
        out[:, x] = ((bulk + np.uint64(1 << 23)) >> np.uint64(24)).astype(
            np.uint8)

    if edge_a <= edge_b:
        for x in range(0, edge_a):
            step(x, 0, x + radius, 0, x + radius + 1)
        for x in range(edge_a, edge_b):
            step(x, x - radius - 1, x + radius, x - radius - 1, x + radius + 1)
        for x in range(edge_b, lastx + 1):
            step(x, x - radius - 1, lastx, x - radius - 1, lastx)
    else:
        for x in range(0, edge_b):
            step(x, 0, x + radius, 0, lastx)
        for x in range(edge_b, edge_a):
            step(x, 0, lastx, 0, lastx)
        for x in range(edge_a, lastx + 1):
            step(x, x - radius - 1, lastx, x - radius - 1, lastx)
    return out


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """`Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius))` for
    (H, W, 3) RGB uint8."""
    img = np.asarray(img)
    if radius == 0:
        return img.copy()
    r = _box_radius(radius)
    out = img
    if r != 0:
        for _ in range(BLUR_PASSES):
            out = _box_blur_rows(out, r)
        t = np.ascontiguousarray(out.transpose(1, 0, 2))
        for _ in range(BLUR_PASSES):
            t = _box_blur_rows(t, r)
        out = np.ascontiguousarray(t.transpose(1, 0, 2))
    return out

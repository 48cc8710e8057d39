"""The plain OCR pipeline the benchmark holds the program's answers
against: the same inputs and checkpoints, float32 with TF32 off, written
from the published PaddleOCR pipeline (DBNet + DB postprocess + CTC
recognizer) in the forms the configuration fixes:

* det input: the page resized to the det target (the longest side limited
  to `det_limit_side_len`, both sides rounded to 32) by a half-pixel
  bilinear resize rounded to whole grey levels, ImageNet-normalized.
  'device' resize: the float bilinear of two tap weights a pixel (the
  configuration's det on the page as uploaded); 'host' resize: the
  fixed-point INTER_LINEAR of OpenCV (11-bit weights). 'fixed' canvas: the
  page on a zero square of the det limit rounded up to 320, the
  activations zeroed outside the page block by block; 'bucket' canvas: the
  page zero-padded up to 320-multiples (a backbone whose map depends on the
  padding);
* DB extraction: the map thresholded, each 8-connected region's min-area
  rectangle, its mean probability inside (an even-odd raster of the
  rectangle) against box_thresh, unclipped by area · ratio / perimeter
  with round joins, the min-area rectangle again, rescaled to the page;
* rec: each box cut from the page by the homography that maps the crop
  grid to the box (bilinear, edges replicated), 48 px high, its width by
  the box's aspect; the recognizer's argmax and max probability a time
  step; CTC's collapse; a line's score is the mean of its kept steps.

It imports nothing of the program and takes nothing the program made."""
from __future__ import annotations

import json
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.ndimage
import torch

from . import nets

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
SRC_BUCKET = 512


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def det_target(h: int, w: int, limit: float) -> Tuple[int, int]:
    ratio = float(limit) / max(h, w) if max(h, w) > limit else 1.0
    rh = max(int(round(int(h * ratio) / 32) * 32), 32)
    rw = max(int(round(int(w * ratio) / 32) * 32), 32)
    return rh, rw


# ----------------------------------------------------------- det input
def _bgr(img: np.ndarray) -> np.ndarray:
    return np.repeat(img[:, :, None], 3, 2) if img.ndim == 2 else img


def _normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.as_tensor(MEAN, device=x.device)
    std = torch.as_tensor(STD, device=x.device)
    return (x.to(torch.float32) / 255.0 - mean) / std


def resize_float(img: np.ndarray, rh: int, rw: int, device) -> torch.Tensor:
    """Half-pixel bilinear with the two taps max(0, 1 − |i − src|), the
    source edge-padded to 512-multiples and the positions clamped to the
    page, rounded to whole levels → (rh, rw, 3) float32 in [0, 255]."""
    h, w = img.shape[:2]
    hb, wb = max(SRC_BUCKET, round_up(h, SRC_BUCKET)), \
        max(SRC_BUCKET, round_up(w, SRC_BUCKET))
    src = np.pad(_bgr(img), ((0, hb - h), (0, wb - w), (0, 0)), mode="edge")
    f32 = torch.float32
    sy = float(np.float32(h) / np.float32(rh))
    sx = float(np.float32(w) / np.float32(rw))
    ys = torch.arange(rh, dtype=f32, device=device)
    xs = torch.arange(rw, dtype=f32, device=device)
    src_y = torch.clamp((ys + 0.5) * sy - 0.5, 0.0, h - 1.0)
    src_x = torch.clamp((xs + 0.5) * sx - 0.5, 0.0, w - 1.0)
    iy = torch.arange(hb, dtype=f32, device=device)
    ix = torch.arange(wb, dtype=f32, device=device)
    wy = torch.clamp(1.0 - torch.abs(iy[None, :] - src_y[:, None]), min=0.0)
    wx = torch.clamp(1.0 - torch.abs(ix[None, :] - src_x[:, None]), min=0.0)
    page = torch.from_numpy(src).to(device).reshape(hb, wb * 3).to(f32)
    tmp = (wy @ page).reshape(rh, wb, 3)
    vals = torch.einsum("hwc,xw->hxc", tmp, wx)
    return torch.round(torch.clamp(vals, 0.0, 255.0))


def _taps(dst: int, src: int, clamp_frac: bool):
    scale = src / dst
    d = np.arange(dst, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp_frac:
        lo, hi = s < 0, s >= src - 1
        f = np.where(lo | hi, np.float32(0), f)
        s = np.where(lo, 0, np.where(hi, src - 1, s))
    one = np.float32(2048)
    c0 = np.rint((np.float32(1) - f) * one).astype(np.int64)
    c1 = np.rint(f * one).astype(np.int64)
    return s, c0, c1


def resize_fixed(img: np.ndarray, rh: int, rw: int) -> np.ndarray:
    """OpenCV's INTER_LINEAR on uint8: 11-bit weights, the horizontal sums
    >> 4, the vertical pass's rounding → uint8 (rh, rw[, C])."""
    src = img if img.ndim == 3 else img[:, :, None]
    H, W = src.shape[:2]
    if (H, W) == (rh, rw):
        return img.copy()
    sx, a0, a1 = _taps(rw, W, True)
    sy, b0, b1 = _taps(rh, H, False)
    x1 = np.minimum(sx + 1, W - 1)
    out = np.empty((rh, rw, src.shape[2]), np.uint8)
    y0 = np.clip(sy, 0, H - 1)
    y1 = np.clip(sy + 1, 0, H - 1)
    for r0 in range(0, rh, 256):
        r = slice(r0, min(rh, r0 + 256))

        def hor(rows):
            s = src[rows].astype(np.int64)
            return s[:, sx] * a0[None, :, None] + s[:, x1] * a1[None, :, None]

        t0 = hor(y0[r]) >> 4
        t1 = hor(y1[r]) >> 4
        v = (((t0 * b0[r, None, None]) >> 16) +
             ((t1 * b1[r, None, None]) >> 16) + 2) >> 2
        out[r] = np.clip(v, 0, 255)
    return out if img.ndim == 3 else out[:, :, 0]


def det_map(params, img: np.ndarray, det: dict, device) -> np.ndarray:
    """The shrink-probability map over the resized page (rh, rw)."""
    h, w = img.shape[:2]
    rh, rw = det_target(h, w, det["limit_side_len"])
    if det["resize"] == "device":
        x = _normalize(resize_float(img, rh, rw, device))
    else:
        x = _normalize(torch.from_numpy(resize_fixed(_bgr(img), rh, rw))
                       .to(device))
    valid = None
    if det["canvas"] == "bucket":
        ch, cw = round_up(rh, 320), round_up(rw, 320)
        canvas = _normalize(torch.zeros((ch, cw, 3), device=device))
        canvas[:rh, :rw] = x
        x = canvas
    elif det["canvas"] == "fixed":
        side = round_up(int(det["limit_side_len"]), 320)
        canvas = torch.zeros((side, side, 3), device=device)
        canvas[:rh, :rw] = x
        x, valid = canvas, (rh, rw)
    with torch.no_grad():
        prob = nets.dbnet(params, x.permute(2, 0, 1)[None], det["arch"],
                          valid)[0]
    return prob[:rh, :rw].cpu().numpy()


# ------------------------------------------------------ DB extraction
def _hull(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain on integer points, counter-clockwise."""
    pts = np.unique(pts, axis=0)
    if len(pts) <= 2:
        return pts.astype(np.float64)
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and (
                    (out[-1][0] - out[-2][0]) * (p[1] - out[-2][1]) -
                    (out[-1][1] - out[-2][1]) * (p[0] - out[-2][0])) <= 0:
                out.pop()
            out.append(p)
        return out

    lower, upper = half(pts), half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1], np.float64)


def min_area_rect(points: np.ndarray):
    """Rotating calipers → ((cx, cy), (w, h), angle in (0, 90])."""
    hull = _hull(np.asarray(points, np.float64).reshape(-1, 2))
    if len(hull) == 1:
        return (float(hull[0, 0]), float(hull[0, 1])), (0.0, 0.0), 0.0
    if len(hull) == 2:
        c = hull.mean(0)
        d = hull[1] - hull[0]
        length = float(np.hypot(d[0], d[1]))
        ang = math.degrees(math.atan2(d[1], d[0])) % 180.0
        if ang == 0.0:
            return (float(c[0]), float(c[1])), (0.0, length), 90.0
        return (float(c[0]), float(c[1])), (length, 0.0), ang
    edges = np.roll(hull, -1, 0) - hull
    best = None
    for theta in np.unique(np.arctan2(edges[:, 1], edges[:, 0]) %
                           (np.pi / 2)):
        c, s = math.cos(theta), math.sin(theta)
        rot = np.array([[c, s], [-s, c]])
        proj = hull @ rot.T
        lo, hi = proj.min(0), proj.max(0)
        wh = hi - lo
        area = wh[0] * wh[1]
        if best is None or area < best[0] - 1e-12:
            centre = rot.T @ ((lo + hi) / 2)
            best = (area, theta, float(wh[0]), float(wh[1]),
                    (float(centre[0]), float(centre[1])))
    _, theta, w, h, centre = best
    angle = math.degrees(theta)
    if angle == 0.0:
        angle, w, h = 90.0, h, w
    return centre, (w, h), angle


def _corners(rect) -> np.ndarray:
    (cx, cy), (w, h), angle = rect
    a = math.radians(angle)
    dx = np.array([math.cos(a), math.sin(a)]) * (w / 2)
    dy = np.array([-math.sin(a), math.cos(a)]) * (h / 2)
    c = np.array([cx, cy])
    return np.asarray([c - dx - dy, c + dx - dy, c + dx + dy, c - dx + dy],
                      np.float32)


def mini_box(points) -> Tuple[np.ndarray, float]:
    """The min-area rectangle's corners in DB's order and its short side."""
    rect = min_area_rect(points)
    pts = sorted(_corners(rect).tolist(), key=lambda p: p[0])
    i1, i4 = (0, 1) if pts[1][1] > pts[0][1] else (1, 0)
    i2, i3 = (2, 3) if pts[3][1] > pts[2][1] else (3, 2)
    box = np.array([pts[i1], pts[i2], pts[i3], pts[i4]], np.float32)
    return box, float(min(rect[1]))


def _area(p):
    return 0.5 * float(np.sum(p[:, 0] * np.roll(p[:, 1], -1) -
                              np.roll(p[:, 0], -1) * p[:, 1]))


def unclip(box: np.ndarray, ratio: float) -> np.ndarray:
    """Offset by area · ratio / perimeter, convex corners joined by arcs of
    0.25 px tolerance."""
    pts = np.asarray(box, np.float64).reshape(-1, 2)
    d = pts - np.roll(pts, -1, 0)
    length = float(np.sum(np.hypot(d[:, 0], d[:, 1])))
    if length <= 0:
        return pts
    dist = abs(_area(pts)) * ratio / length
    if dist <= 0:
        return pts
    if _area(pts) < 0:
        pts = pts[::-1]
    steps_circle = max(6.0, math.pi / math.acos(
        max(-1.0, min(1.0, 1 - 0.25 / dist))))
    out = []
    n = len(pts)
    for i in range(n):
        p0, p, p1 = pts[i - 1], pts[i], pts[(i + 1) % n]
        e0, e1 = p - p0, p1 - p
        l0 = np.hypot(*e0) or 1e-12
        l1 = np.hypot(*e1) or 1e-12
        n0 = np.array([e0[1], -e0[0]]) / l0
        n1 = np.array([e1[1], -e1[0]]) / l1
        if e0[0] * e1[1] - e0[1] * e1[0] >= 0:
            a0 = math.atan2(n0[1], n0[0])
            da = math.atan2(n1[1], n1[0]) - a0
            while da > math.pi:
                da -= 2 * math.pi
            while da < -math.pi:
                da += 2 * math.pi
            k = max(1, int(math.ceil(abs(da) * steps_circle / (2 * math.pi))))
            for j in range(k + 1):
                ang = a0 + da * j / k
                out.append(p + dist * np.array([math.cos(ang),
                                                math.sin(ang)]))
        else:
            q0, q1 = p + n0 * dist, p + n1 * dist
            d0, d1 = e0 / l0, e1 / l1
            den = d0[0] * d1[1] - d0[1] * d1[0]
            if abs(den) < 1e-12:
                out.extend([q0, q1])
            else:
                t = ((q1 - q0)[0] * d1[1] - (q1 - q0)[1] * d1[0]) / den
                out.append(q0 + d0 * t)
    return np.asarray(out)


def quad_score(prob: np.ndarray, quad: np.ndarray) -> float:
    """Mean of the map inside the quad's even-odd raster over its bounding
    box (vertices truncated to whole pixels after the shift)."""
    h, w = prob.shape
    pts = np.asarray(quad, np.float64).reshape(-1, 2).copy()
    x0 = int(np.clip(np.floor(pts[:, 0].min()), 0, w - 1))
    x1 = int(np.clip(np.ceil(pts[:, 0].max()), 0, w - 1))
    y0 = int(np.clip(np.floor(pts[:, 1].min()), 0, h - 1))
    y1 = int(np.clip(np.ceil(pts[:, 1].max()), 0, h - 1))
    pts[:, 0] -= x0
    pts[:, 1] -= y0
    pts = pts.astype(np.int32).astype(np.float64)
    ys, xs = np.mgrid[0:y1 - y0 + 1, 0:x1 - x0 + 1].astype(np.float64)
    inside = np.zeros(ys.shape, bool)
    j = len(pts) - 1
    for i in range(len(pts)):
        (xi, yi), (xj, yj) = pts[i], pts[j]
        cond = (yi > ys) != (yj > ys)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = (xj - xi) * (ys - yi) / (yj - yi) + xi
        inside ^= cond & (xs < xint)
        j = i
    n = inside.sum()
    region = prob[y0:y1 + 1, x0:x1 + 1]
    return float((region * inside).sum() / n) if n else 0.0


def clockwise(pts: np.ndarray) -> np.ndarray:
    """[top-left, top-right, bottom-right, bottom-left]."""
    idx = np.argsort(pts[:, 0])
    left = pts[idx[:2]][np.argsort(pts[idx[:2], 1])]
    right = pts[idx[2:]][np.argsort(pts[idx[2:], 1])]
    return np.asarray([left[0], right[0], right[1], left[1]], pts.dtype)


def _borders(bitmap: np.ndarray, max_candidates: int):
    """The borders the DB postprocess considers: every outer border (one
    an 8-connected region) and every hole border (one a 4-connected hole)
    in the raster order of their starting pixels — a region's first pixel,
    the pixel left of a hole's first pixel —, the first max_candidates of
    them → [point set (K, 2) int (x, y)]: a region's pixels' row ends, the
    region pixels 4-adjacent to a hole."""
    h, w = bitmap.shape
    fg, n_fg = scipy.ndimage.label(bitmap, structure=np.ones((3, 3), bool))
    order = np.arange(h * w).reshape(h, w)
    fg_slices = scipy.ndimage.find_objects(fg)
    starts = [(int(v), k, True) for k, v in enumerate(
        scipy.ndimage.minimum(order, fg, range(1, n_fg + 1)), 1)]
    bg, n_bg = scipy.ndimage.label(np.pad(~bitmap, 1, constant_values=True))
    bg = bg[1:-1, 1:-1]
    outside = set(np.concatenate([bg[0], bg[-1], bg[:, 0],
                                  bg[:, -1]]).tolist()) | {0}
    holes = [k for k in range(1, n_bg + 1) if k not in outside]
    bg_slices = scipy.ndimage.find_objects(bg)
    if holes:
        firsts = scipy.ndimage.minimum(order, bg, holes)
        starts += [(int(v) - 1, k, False) for k, v in zip(holes, firsts)]
    starts.sort()
    out = []
    for _, k, region in starts[:max_candidates]:
        if region:
            sl = fg_slices[k - 1]
            m = fg[sl] == k
            rows = np.nonzero(m.any(1))[0]
            left = np.argmax(m[rows], 1)
            right = m.shape[1] - 1 - np.argmax(m[rows, ::-1], 1)
            pts = np.concatenate([np.stack([left, rows], 1),
                                  np.stack([right, rows], 1)])
            out.append(pts + np.array([sl[1].start, sl[0].start]))
        else:
            sl = bg_slices[k - 1]
            y0, x0 = sl[0].start - 1, sl[1].start - 1   # holes never touch
            y1, x1 = sl[0].stop + 1, sl[1].stop + 1      # the map's edge
            hole = bg[y0:y1, x0:x1] == k
            near = np.zeros_like(hole)
            near[1:] |= hole[:-1]
            near[:-1] |= hole[1:]
            near[:, 1:] |= hole[:, :-1]
            near[:, :-1] |= hole[:, 1:]
            ys, xs = np.nonzero(near & bitmap[y0:y1, x0:x1])
            out.append(np.stack([xs + x0, ys + y0], 1))
    return out


def db_boxes(prob: np.ndarray, src_h: int, src_w: int, det: dict
             ) -> np.ndarray:
    """DB extraction on the map of the resized page → (N, 4, 2) float32
    boxes in page coordinates, clockwise from the top left."""
    rh, rw = prob.shape
    out = []
    for pts in _borders(prob > det["thresh"], det["max_candidates"]):
        if np.ptp(pts[:, 0]) * np.ptp(pts[:, 1]) < 9:
            continue
        quad, sside = mini_box(pts)
        if sside < 3:
            continue
        if quad_score(prob, quad) < det["box_thresh"]:
            continue
        box, sside = mini_box(unclip(quad, det["unclip_ratio"]).astype(
            np.float32))
        if sside < 5:
            continue
        box = np.array(box)
        box[:, 0] = np.clip(np.round(box[:, 0] / rw * src_w), 0, src_w)
        box[:, 1] = np.clip(np.round(box[:, 1] / rh * src_h), 0, src_h)
        box = clockwise(box.astype(np.int32).astype(np.float32))
        box[:, 0] = np.clip(box[:, 0], 0, src_w - 1)
        box[:, 1] = np.clip(box[:, 1], 0, src_h - 1)
        if int(np.linalg.norm(box[0] - box[1])) <= 3 or \
                int(np.linalg.norm(box[0] - box[3])) <= 3:
            continue
        out.append(box)
    return np.asarray(out, np.float32).reshape(-1, 4, 2)


# ---------------------------------------------------------------- rec
WIDTHS = (640, 960, 1280)
WIDTH_STEP, WIDTH_CAP = 320, 3200


def bucket_of(desired: int) -> int:
    for w in WIDTHS:
        if desired <= w:
            return w
    if desired >= WIDTH_CAP:
        return WIDTH_CAP
    return int(math.ceil(desired / WIDTH_STEP) * WIDTH_STEP)


def _crop_size(box):
    p = np.asarray(box, np.float32)
    return (int(max(np.linalg.norm(p[0] - p[1]), np.linalg.norm(p[2] - p[3]))),
            int(max(np.linalg.norm(p[0] - p[3]), np.linalg.norm(p[1] - p[2]))))


def _homography(src, dst):
    a, b = np.zeros((8, 8)), np.zeros(8)
    for i in range(4):
        (x, y), (u, v) = src[i], dst[i]
        a[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        a[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i], b[2 * i + 1] = u, v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def crop_matrix(box, out_h: int = 48) -> Tuple[np.ndarray, int, int]:
    """Dest → page matrix of one line's crop: the box's own rectangle
    (turned upright if it stands at 1.5 or more), scaled to out_h rows →
    (3 × 3 float32, valid width, width bucket)."""
    pts = np.asarray(box, np.float32).reshape(4, 2)
    cw, ch = _crop_size(pts)
    cw, ch = max(cw, 1), max(ch, 1)
    m = _homography(np.array([[0, 0], [cw, 0], [cw, ch], [0, ch]],
                             np.float32).astype(np.float64),
                    pts.astype(np.float64))
    if ch / cw >= 1.5:
        m = m @ np.array([[0, -1, cw - 1.0], [1, 0, 0], [0, 0, 1.0]])
        cw, ch = ch, cw
    bucket = bucket_of(max(320, math.ceil(out_h * cw / ch)))
    vw = min(bucket, max(1, int(np.ceil(out_h * cw / float(ch)))))
    sx, sy = cw / float(vw), ch / float(out_h)
    m = m @ np.array([[sx, 0, 0.5 * sx - 0.5], [0, sy, 0.5 * sy - 0.5],
                      [0, 0, 1.0]])
    return m.astype(np.float32), vw, bucket


def crops(page: torch.Tensor, mats: torch.Tensor, valid: torch.Tensor,
          out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear samples of the (H, W, 3) uint8 page (edge-padded) at each
    crop pixel's mapped position, clamped to the page; → (N, out_h, out_w,
    3) in [−1, 1], zero from the valid width on."""
    H, W = page.shape[:2]
    dev = page.device
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32,
                                         device=dev),
                            torch.arange(out_w, dtype=torch.float32,
                                         device=dev), indexing="ij")
    m = mats[:, :, :, None, None]
    u = m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]
    v = m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]
    w = m[:, 2, 0] * gx + m[:, 2, 1] * gy + m[:, 2, 2]
    inv = 1.0 / w
    sx = torch.clamp(u * inv, 0.0, W - 1.0)
    sy = torch.clamp(v * inv, 0.0, H - 1.0)
    live = gx[None] < valid[:, None, None]
    sx = torch.where(live, sx, 0.0)
    sy = torch.where(live, sy, 0.0)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()

    def px(yy, xx):
        return page[torch.clamp(yy, 0, H - 1),
                    torch.clamp(xx, 0, W - 1)].to(torch.float32)

    top = px(y0, x0) * (1 - fx) + px(y0, x0 + 1) * fx
    bot = px(y0 + 1, x0) * (1 - fx) + px(y0 + 1, x0 + 1) * fx
    vals = torch.clamp(top * (1 - fy) + bot * fy, 0.0, 255.0)
    norm = (vals / 255.0 - 0.5) / 0.5
    return torch.where(live[..., None], norm, 0.0)


def support_mask(sidecar: str, vocab: int, device) -> torch.Tensor:
    """−1e30 on the classes the checkpoint was not trained on (its
    committed sidecar), 0 on the rest and on the blank."""
    with open(sidecar) as f:
        keep = np.asarray(sorted(set(json.load(f)["indices"]) | {0}))
    mask = np.full(vocab, -1e30, np.float32)
    mask[keep[keep < vocab]] = 0.0
    return torch.from_numpy(mask).to(device)


def rec_logits(params, x: torch.Tensor, arch: str) -> torch.Tensor:
    with torch.no_grad():
        return nets.svtr(params, x) if arch == "svtr" else \
            nets.crnn(params, x)


def decode(logits: torch.Tensor, mask: torch.Tensor, valid_t: Sequence[int]
           ) -> List[Tuple[Tuple[int, ...], float]]:
    """Rows of logits (N, T, V) → [(kept class ids, score)]: argmax and
    max softmax probability a step over each row's valid steps, repeats
    then blanks dropped, the score the mean of the kept steps (0 with
    none)."""
    z = logits + mask
    prob, idx = torch.softmax(z, -1).max(-1)
    idx, prob = idx.cpu().numpy(), prob.cpu().numpy()
    out = []
    for r, t in enumerate(valid_t):
        i, p = idx[r, :t], prob[r, :t]
        keep = np.ones(len(i), bool)
        keep[1:] = i[1:] != i[:-1]
        keep &= i != 0
        conf = p[keep]
        out.append((tuple(int(c) for c in i[keep]),
                    float(np.mean(conf)) if len(conf) else 0.0))
    return out


def recognize(params, rec: dict, page: np.ndarray, boxes, mask, device
              ) -> List[Tuple[Tuple[int, ...], float]]:
    """Each box of the page recognized → [(class ids, score)] in box
    order."""
    if len(boxes) == 0:
        return []
    h, w = page.shape[:2]
    hb, wb = max(SRC_BUCKET, round_up(h, SRC_BUCKET)), \
        max(SRC_BUCKET, round_up(w, SRC_BUCKET))
    padded = np.pad(_bgr(page), ((0, hb - h), (0, wb - w), (0, 0)),
                    mode="edge")
    page_t = torch.from_numpy(padded).to(device)
    plans = [crop_matrix(b) for b in boxes]
    stride = 8 if rec["arch"] == "svtr" else 4
    groups: Dict[int, List[int]] = {}
    for i, (_, vw, bucket) in enumerate(plans):
        # the masked SVTR reads a crop at its own width; the CRNN, whose
        # logits depend on the padding, at its width bucket
        width = 8 * math.ceil(vw / 8) if rec["arch"] == "svtr" else bucket
        groups.setdefault(width, []).append(i)
    out: List = [None] * len(boxes)
    for width, rows in groups.items():
        for lo in range(0, len(rows), 64):
            part = rows[lo:lo + 64]
            mats = torch.from_numpy(np.stack([plans[i][0] for i in part])
                                    ).to(device)
            valid = torch.tensor([plans[i][1] for i in part], device=device)
            x = crops(page_t, mats, valid, 48, width)
            logits = rec_logits(params, x.permute(0, 3, 1, 2), rec["arch"])
            vt = [min(logits.shape[1], math.ceil(plans[i][1] / stride))
                  for i in part]
            for i, res in zip(part, decode(logits, mask, vt)):
                out[i] = res
    return out


def recognize_lines(params, rec: dict, lines: Sequence[np.ndarray], mask,
                    device) -> List[Tuple[Tuple[int, ...], float]]:
    """Line images (BGR uint8) → [(class ids, score)]: each line resized
    to 48 rows at its aspect (INTER_LINEAR), at least 320 wide in its
    bucket, normalized to [−1, 1]."""
    stride = 8 if rec["arch"] == "svtr" else 4
    plans = []
    for im in lines:
        h, w = im.shape[:2]
        bucket = bucket_of(max(320, math.ceil(48 * w / h)))
        vw = min(bucket, int(math.ceil(48 * w / float(h))))
        plans.append((vw, bucket))
    out: List = [None] * len(lines)
    groups: Dict[int, List[int]] = {}
    for i, (vw, bucket) in enumerate(plans):
        width = 8 * math.ceil(vw / 8) if rec["arch"] == "svtr" else bucket
        groups.setdefault(width, []).append(i)
    for width, rows in groups.items():
        for lo in range(0, len(rows), 64):
            part = rows[lo:lo + 64]
            x = np.zeros((len(part), 48, width, 3), np.float32)
            for r, i in enumerate(part):
                vw = plans[i][0]
                im = resize_fixed(lines[i], 48, vw).astype(np.float32)
                x[r, :, :vw] = (im / 255.0 - 0.5) / 0.5
            logits = rec_logits(params, torch.from_numpy(x).to(device)
                                .permute(0, 3, 1, 2), rec["arch"])
            vt = [min(logits.shape[1], math.ceil(plans[i][0] / stride))
                  for i in part]
            for i, res in zip(part, decode(logits, mask, vt)):
                out[i] = res
    return out

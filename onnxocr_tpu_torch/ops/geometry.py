"""Host-side polygon geometry of the DB postprocess: shoelace area and
perimeter, convex hull, min-area rect, round-join offset (unclip),
Douglas-Peucker, the DB 2×2 dilation, clockwise corner order and an
even-odd polygon fill. Own copy of onnxocr_tpu/ops/geometry.py.

Pure numpy. The host library (ops/native.py, csrc/host/geometry.cc) holds
the C++ contour tracer, min-area rect and box scorer that the DB
postprocess calls; `min_area_rect` and `fill_poly_mask` here are their
plain versions, which the tests hold the library against.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def polygon_area(pts: np.ndarray) -> float:
    """Signed shoelace area (positive = counter-clockwise in xy coords)."""
    x = pts[:, 0]
    y = pts[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def polygon_perimeter(pts: np.ndarray) -> float:
    d = pts - np.roll(pts, -1, axis=0)
    return float(np.sum(np.hypot(d[:, 0], d[:, 1])))


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain; returns hull in counter-clockwise order."""
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    # lexicographic sort by (x, y)
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: List[np.ndarray] = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: List[np.ndarray] = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1])


def min_area_rect(points: np.ndarray
                  ) -> Tuple[Tuple[float, float], Tuple[float, float], float]:
    """Rotating-calipers minimum-area bounding rectangle.

    Returns ((cx, cy), (w, h), angle_degrees) with cv2.minAreaRect-compatible
    convention: angle in (0, 90], w is the side extent along the angle
    direction. Degenerate inputs collapse to axis-aligned boxes.
    """
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    hull = convex_hull(pts)
    if len(hull) == 1:
        return (float(hull[0, 0]), float(hull[0, 1])), (0.0, 0.0), 0.0
    if len(hull) == 2:
        c = hull.mean(axis=0)
        d = hull[1] - hull[0]
        length = float(np.hypot(d[0], d[1]))
        ang = math.degrees(math.atan2(d[1], d[0])) % 180.0
        if ang == 0.0:
            ang = 90.0  # cv2 convention: angle in (0, 90]
            return (float(c[0]), float(c[1])), (0.0, length), ang
        return (float(c[0]), float(c[1])), (length, 0.0), ang

    edges = np.roll(hull, -1, axis=0) - hull
    angles = np.arctan2(edges[:, 1], edges[:, 0]) % (np.pi / 2)
    angles = np.unique(angles)

    best = None
    for theta in angles:
        c, s = math.cos(theta), math.sin(theta)
        rot = np.array([[c, s], [-s, c]])
        proj = hull @ rot.T
        mins = proj.min(axis=0)
        maxs = proj.max(axis=0)
        wh = maxs - mins
        area = wh[0] * wh[1]
        if best is None or area < best[0] - 1e-12:
            center_r = (mins + maxs) / 2
            center = rot.T @ center_r
            best = (area, theta, float(wh[0]), float(wh[1]),
                    (float(center[0]), float(center[1])))
    _, theta, w, h, center = best
    angle = math.degrees(theta)
    # Normalize to cv2's (0, 90] convention.
    if angle == 0.0:
        angle = 90.0
        w, h = h, w
    return center, (w, h), angle


def box_points(rect) -> np.ndarray:
    """cv2.boxPoints equivalent: 4 corners of a rotated rect.

    Corner order matches cv2: starting from the corner that is lowest
    (max y) going clockwise in image coords — what matters downstream is
    only the *set* of corners; get_mini_boxes re-sorts them by x.
    """
    (cx, cy), (w, h), angle = rect
    a = math.radians(angle)
    ca, sa = math.cos(a), math.sin(a)
    dx = np.array([ca, sa]) * (w / 2)
    dy = np.array([-sa, ca]) * (h / 2)
    c = np.array([cx, cy])
    return np.asarray([c - dx - dy, c + dx - dy, c + dx + dy, c - dx + dy],
                      dtype=np.float32)


def offset_polygon_round(poly: np.ndarray, distance: float,
                         arc_tolerance: float = 0.25) -> np.ndarray:
    """Outward offset of a polygon with round joins.

    pyclipper.PyclipperOffset(JT_ROUND, ET_CLOSEDPOLYGON) replacement for the
    DB unclip step. Each edge is shifted outward along its normal; convex
    corners are joined with arc points (step chosen from arc_tolerance like
    Clipper), reflex corners with the miter intersection. Inputs from the DB
    pipeline are min-area rectangles (always convex), where this matches
    Clipper's result to sub-pixel accuracy.
    """
    pts = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
    n = len(pts)
    if n < 3 or distance <= 0:
        return pts.copy()
    # Ensure counter-clockwise orientation in xy (outward = left normal).
    if polygon_area(pts) < 0:
        pts = pts[::-1]

    # Clipper arc step: number of segments for a full circle given tolerance.
    steps_per_circle = max(6.0, math.pi / math.acos(
        max(-1.0, min(1.0, 1 - arc_tolerance / max(distance, 1e-9)))))

    out: List[np.ndarray] = []
    for i in range(n):
        p_prev = pts[(i - 1) % n]
        p = pts[i]
        p_next = pts[(i + 1) % n]
        e0 = p - p_prev
        e1 = p_next - p
        l0 = np.hypot(*e0) or 1e-12
        l1 = np.hypot(*e1) or 1e-12
        # Outward normals (for CCW polygon, outward is to the right in image
        # coords with y down — use the normal pointing away from interior).
        n0 = np.array([e0[1], -e0[0]]) / l0
        n1 = np.array([e1[1], -e1[0]]) / l1
        cross_z = e0[0] * e1[1] - e0[1] * e1[0]
        if cross_z >= 0:
            # convex corner (for y-down CCW): join with arc from n0 to n1
            a0 = math.atan2(n0[1], n0[0])
            a1 = math.atan2(n1[1], n1[0])
            # sweep through the outside (shorter way matching normal turn)
            da = a1 - a0
            while da > math.pi:
                da -= 2 * math.pi
            while da < -math.pi:
                da += 2 * math.pi
            steps = max(1, int(math.ceil(abs(da) * steps_per_circle /
                                         (2 * math.pi))))
            for k in range(steps + 1):
                ang = a0 + da * k / steps
                out.append(p + distance * np.array([math.cos(ang),
                                                    math.sin(ang)]))
        else:
            # reflex corner: miter join (intersection of offset edges)
            q0 = p + n0 * distance
            q1 = p + n1 * distance
            d0 = e0 / l0
            d1 = e1 / l1
            denom = d0[0] * d1[1] - d0[1] * d1[0]
            if abs(denom) < 1e-12:
                out.extend([q0, q1])
            else:
                diff = q1 - q0
                t = (diff[0] * d1[1] - diff[1] * d1[0]) / denom
                out.append(q0 + d0 * t)
    return np.asarray(out)


def unclip(box: np.ndarray, unclip_ratio: float) -> np.ndarray:
    """DB unclip: offset distance = area * ratio / perimeter
    (reference: onnxocr/db_postprocess.py:151-157)."""
    pts = np.asarray(box, dtype=np.float64).reshape(-1, 2)
    area = abs(polygon_area(pts))
    length = polygon_perimeter(pts)
    if length <= 0:
        return pts
    distance = area * unclip_ratio / length
    return offset_polygon_round(pts, distance)


def arc_length(pts: np.ndarray, closed: bool = True) -> float:
    """Polyline length (cv2.arcLength semantics)."""
    pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
    if len(pts) < 2:
        return 0.0
    segs = np.diff(pts, axis=0)
    total = float(np.hypot(segs[:, 0], segs[:, 1]).sum())
    if closed:
        total += float(np.hypot(*(pts[0] - pts[-1])))
    return total


def _dp_keep(pts: np.ndarray, lo: int, hi: int, eps: float,
             keep: np.ndarray) -> None:
    """Douglas-Peucker on the open chain pts[lo..hi] (endpoints kept)."""
    stack = [(lo, hi)]
    while stack:
        a, b = stack.pop()
        if b - a < 2:
            continue
        pa, pb = pts[a], pts[b]
        d = pb - pa
        seg_len = np.hypot(*d)
        chain = pts[a + 1:b]
        if seg_len == 0.0:
            dists = np.hypot(*(chain - pa).T)
        else:
            # the 2-D cross product written out (np.cross of 2-vectors is
            # deprecated), the same operations in the same order
            rel = chain - pa
            dists = np.abs(d[0] * rel[:, 1] - d[1] * rel[:, 0]) / seg_len
        k = int(np.argmax(dists))
        if dists[k] > eps:
            m = a + 1 + k
            keep[m] = True
            stack.append((a, m))
            stack.append((m, b))


def approx_poly_dp(points: np.ndarray, epsilon: float,
                   closed: bool = True) -> np.ndarray:
    """Douglas-Peucker polygon simplification (cv2.approxPolyDP
    replacement). For a closed curve the chain splits at the two mutually
    farthest vertices so no artificial endpoint survives."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    n = len(pts)
    if n < 3 or epsilon <= 0:
        return pts.astype(points.dtype if hasattr(points, "dtype")
                          else np.float64)
    keep = np.zeros(n, dtype=bool)
    if closed:
        # anchor at vertex 0 and the vertex farthest from it
        far = int(np.argmax(np.hypot(*(pts - pts[0]).T)))
        if far == 0:
            return pts[:1]
        keep[0] = keep[far] = True
        _dp_keep(pts, 0, far, epsilon, keep)
        # second chain wraps around: far .. n-1 .. 0
        wrapped = np.vstack([pts[far:], pts[:1]])
        wkeep = np.zeros(len(wrapped), dtype=bool)
        wkeep[0] = wkeep[-1] = True
        _dp_keep(wrapped, 0, len(wrapped) - 1, epsilon, wkeep)
        keep[far:] |= wkeep[:-1]
    else:
        keep[0] = keep[-1] = True
        _dp_keep(pts, 0, n - 1, epsilon, keep)
    return pts[keep]


def dilate2x2(mask: np.ndarray) -> np.ndarray:
    """Binary dilation with the DB 2x2 all-ones kernel
    (cv2.dilate(mask, ones(2,2)) semantics, anchor at kernel center (1,1):
    out[y, x] = max over src[y-1:y+1, x-1:x+1])."""
    m = np.asarray(mask)
    tmp = m.copy()
    tmp[1:, :] = np.maximum(tmp[1:, :], m[:-1, :])   # vertical pass
    out = tmp.copy()
    out[:, 1:] = np.maximum(out[:, 1:], tmp[:, :-1])  # horizontal pass
    return out


def order_points_clockwise(pts: np.ndarray) -> np.ndarray:
    """Order 4 points as [top-left, top-right, bottom-right, bottom-left]
    (reference semantics: onnxocr/predict_det.py:50-59)."""
    pts = np.asarray(pts)
    idx = np.argsort(pts[:, 0])
    left = pts[idx[:2]]
    right = pts[idx[2:]]
    left = left[np.argsort(left[:, 1])]
    right = right[np.argsort(right[:, 1])]
    return np.asarray([left[0], right[0], right[1], left[1]],
                      dtype=pts.dtype)


def fill_poly_mask(shape_hw: Tuple[int, int], poly: np.ndarray) -> np.ndarray:
    """Rasterize a polygon into a binary mask via even-odd scanline test.

    cv2.fillPoly replacement used by box scoring when cv2/native is absent.
    Matches cv2's integer-vertex fill closely for the small masks used in
    box_score_fast.
    """
    h, w = shape_hw
    pts = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
    ys, xs = np.mgrid[0:h, 0:w]
    inside = np.zeros((h, w), dtype=bool)
    n = len(pts)
    px = xs + 0.0
    py = ys + 0.0
    j = n - 1
    for i in range(n):
        xi, yi = pts[i]
        xj, yj = pts[j]
        cond = ((yi > py) != (yj > py))
        with np.errstate(divide="ignore", invalid="ignore"):
            xints = (xj - xi) * (py - yi) / (yj - yi) + xi
        inside ^= cond & (px < xints)
        j = i
    return inside.astype(np.uint8)

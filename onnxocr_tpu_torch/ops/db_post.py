"""DB (Differentiable Binarization) postprocess on the host. Port of
onnxocr_tpu/ops/db_post.py, on the host library (ops/native.py) as the JAX
package runs it when its library is loaded:

threshold the shrink-prob map (pred > 0.3) → contours → min-area rect →
score by the masked mean → drop below box_thresh → unclip by the ratio →
min-area rect again → rescale to source coordinates, clip, int32
(reference onnxocr/db_postprocess.py:104-149).

The numpy twins (geometry.min_area_rect, `box_score_plain`) are the plain
versions the tests hold the library against; the path never takes them.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import geometry, native


def _min_area_quad(points: np.ndarray) -> Tuple[np.ndarray, float]:
    """Min-area rect corners sorted the DB way → (4 × 2 float32 points,
    short side) (reference get_mini_boxes, db_postprocess.py:159-180)."""
    rect = native.min_area_rect(points.astype(np.float64))
    corners = geometry.box_points(rect)
    sside = min(rect[1])
    pts = sorted(corners.tolist(), key=lambda p: p[0])
    if pts[1][1] > pts[0][1]:
        i1, i4 = 0, 1
    else:
        i1, i4 = 1, 0
    if pts[3][1] > pts[2][1]:
        i2, i3 = 2, 3
    else:
        i2, i3 = 3, 2
    box = np.array([pts[i1], pts[i2], pts[i3], pts[i4]], dtype=np.float32)
    return box, float(sside)


def box_score_fast(bitmap: np.ndarray, box: np.ndarray) -> float:
    """Mean prob inside the quad (reference db_postprocess.py:182-197)."""
    return native.box_score(bitmap, box)


def box_score_slow(bitmap: np.ndarray, contour: np.ndarray) -> float:
    """Mean prob inside the exact contour polygon (reference
    db_postprocess.py:199-218)."""
    return native.box_score(bitmap, np.reshape(contour, (-1, 2)))


def box_score_plain(bitmap: np.ndarray, poly: np.ndarray) -> float:
    """The numpy twin of the library's scorer: the polygon's bbox crop and
    its geometry.fill_poly_mask (the JAX package's fallback scorer)."""
    h, w = bitmap.shape[:2]
    pts = np.asarray(poly, np.float64).reshape(-1, 2).copy()
    xmin = int(np.clip(np.floor(pts[:, 0].min()), 0, w - 1))
    xmax = int(np.clip(np.ceil(pts[:, 0].max()), 0, w - 1))
    ymin = int(np.clip(np.floor(pts[:, 1].min()), 0, h - 1))
    ymax = int(np.clip(np.ceil(pts[:, 1].max()), 0, h - 1))
    pts[:, 0] -= xmin
    pts[:, 1] -= ymin
    mask = geometry.fill_poly_mask((ymax - ymin + 1, xmax - xmin + 1),
                                   pts.astype(np.int32))
    region = bitmap[ymin:ymax + 1, xmin:xmax + 1]
    denom = mask.sum()
    if denom == 0:
        return 0.0
    return float((region * mask).sum() / denom)


def _candidate_contours(bitmap_u8: np.ndarray, min_sq: float,
                        max_candidates: int) -> List[np.ndarray]:
    """Contours eligible for the DB quad loop: the first max_candidates by
    raster index (reference `contours[:max_candidates]`), minus those whose
    bbox area < min_sq — an exact prefilter (min-area-rect sside ≤ √(bbox
    area)) run inside the tracer."""
    return native.find_contours_filtered(bitmap_u8, min_sq, max_candidates)


def _rescale(box: np.ndarray, width: int, height: int, dest_width: int,
             dest_height: int) -> np.ndarray:
    box = np.array(box)
    box[:, 0] = np.clip(np.round(box[:, 0] / width * dest_width), 0,
                        dest_width)
    box[:, 1] = np.clip(np.round(box[:, 1] / height * dest_height), 0,
                        dest_height)
    return box


class DBPostProcess:
    """Same knobs and output contract as the reference class
    (db_postprocess.py:29-246)."""

    def __init__(self, thresh=0.3, box_thresh=0.7, max_candidates=1000,
                 unclip_ratio=2.0, use_dilation=False, score_mode="fast",
                 box_type="quad", **kwargs):
        assert score_mode in ("slow", "fast")
        self.thresh = thresh
        self.box_thresh = box_thresh
        self.max_candidates = max_candidates
        self.unclip_ratio = unclip_ratio
        self.min_size = 3
        self.score_mode = score_mode
        self.box_type = box_type
        self.use_dilation = use_dilation

    def boxes_from_bitmap(self, pred: np.ndarray, bitmap: np.ndarray,
                          dest_width: int, dest_height: int):
        height, width = bitmap.shape
        boxes = []
        scores = []
        for contour in _candidate_contours(
                (bitmap * 255).astype(np.uint8),
                float(self.min_size) ** 2, self.max_candidates):
            points, sside = _min_area_quad(contour.reshape(-1, 2))
            if sside < self.min_size:
                continue
            if self.score_mode == "fast":
                score = box_score_fast(pred, points.reshape(-1, 2))
            else:
                score = box_score_slow(pred, contour)
            if self.box_thresh > score:
                continue
            expanded = geometry.unclip(points, self.unclip_ratio)
            box, sside = _min_area_quad(expanded.astype(np.float32))
            if sside < self.min_size + 2:
                continue
            box = _rescale(box, width, height, dest_width, dest_height)
            boxes.append(box.astype(np.int32))
            scores.append(score)
        return np.array(boxes, dtype=np.int32), scores

    def candidates_from_bitmap(self, bitmap: np.ndarray, dest_width: int,
                               dest_height: int
                               ) -> Tuple[np.ndarray, np.ndarray]:
        """boxes_from_bitmap with the score deferred, for the bitmap wire:
        the same contour → min-area quad → unclip chain without the prob
        map; the candidates are scored on the device against the map that
        stayed there (pipeline/fused.call_scored) and the box_thresh filter
        applies when the scores come back (the same final set and order as
        the reference flow). Quad boxes, score_mode 'fast'.

        → (pre_quads (K, 4, 2) float32 in map coordinates, the pre-unclip
        quads the reference scores; boxes (K, 4, 2) int32 in source
        coordinates)."""
        height, width = bitmap.shape
        pre_quads = []
        boxes = []
        for contour in _candidate_contours(
                (bitmap * 255).astype(np.uint8),
                float(self.min_size) ** 2, self.max_candidates):
            points, sside = _min_area_quad(contour.reshape(-1, 2))
            if sside < self.min_size:
                continue
            expanded = geometry.unclip(points, self.unclip_ratio)
            box, sside = _min_area_quad(expanded.astype(np.float32))
            if sside < self.min_size + 2:
                continue
            box = _rescale(box, width, height, dest_width, dest_height)
            pre_quads.append(points)
            boxes.append(box.astype(np.int32))
        return (np.asarray(pre_quads, np.float32).reshape(-1, 4, 2),
                np.asarray(boxes, np.int32).reshape(-1, 4, 2))

    def polygons_from_bitmap(self, pred: np.ndarray, bitmap: np.ndarray,
                             dest_width: int, dest_height: int):
        height, width = bitmap.shape
        boxes = []
        scores = []
        contours = native.find_contours((bitmap * 255).astype(np.uint8))
        for contour in contours[:self.max_candidates]:
            c = contour.reshape(-1, 2).astype(np.int32)
            epsilon = 0.002 * geometry.arc_length(c, closed=True)
            points = geometry.approx_poly_dp(c, epsilon, closed=True)
            points = points.reshape((-1, 2))
            if points.shape[0] < 4:
                continue
            score = box_score_fast(pred, points.reshape(-1, 2))
            if self.box_thresh > score:
                continue
            expanded = geometry.unclip(points, self.unclip_ratio)
            if expanded.shape[0] < 3:
                continue
            box = expanded.reshape(-1, 2)
            _, sside = _min_area_quad(box.astype(np.float32))
            if sside < self.min_size + 2:
                continue
            box = _rescale(box, width, height, dest_width, dest_height)
            boxes.append(box.tolist())
            scores.append(score)
        return boxes, scores

    def __call__(self, outs_dict, shape_list):
        pred = outs_dict["maps"]
        pred = pred[:, 0, :, :]
        segmentation = pred > self.thresh
        boxes_batch = []
        for batch_index in range(pred.shape[0]):
            src_h, src_w, ratio_h, ratio_w = shape_list[batch_index]
            mask = segmentation[batch_index]
            if self.use_dilation:
                mask = geometry.dilate2x2(mask.astype(np.uint8))
            if self.box_type == "poly":
                boxes, scores = self.polygons_from_bitmap(
                    pred[batch_index], mask, src_w, src_h)
            elif self.box_type == "quad":
                boxes, scores = self.boxes_from_bitmap(
                    pred[batch_index], mask, src_w, src_h)
            else:
                raise ValueError("box_type can only be one of "
                                 "['quad', 'poly']")
            boxes_batch.append({"points": boxes})
        return boxes_batch

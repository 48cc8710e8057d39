"""Host image helpers. Counterpart of onnxocr_tpu/utils/image.py: the
reference's host crops (`get_rotate_crop_image`, `get_minarea_rect_crop`),
`resize_img`, the min-area quad of a poly box and `base64_to_cv2`. The cv2 calls there are
the cv2-exact numpy twins of utils/cv_ops.py here.
"""
from __future__ import annotations

import base64
from typing import Optional

import numpy as np

from ..ops import geometry
from ..ops.warp import perspective_transform
from . import cv_ops, imcodec


def get_rotate_crop_image(img: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Perspective-crop a quad (bicubic, edge replicated) at the size of its
    longer side pairs, turned by 90° when h / w >= 1.5 (reference
    onnxocr/utils.py:12-53)."""
    if len(points) != 4:
        raise ValueError("shape of points must be 4*2")
    points = np.asarray(points, dtype=np.float32)
    img_crop_width = int(max(np.linalg.norm(points[0] - points[1]),
                             np.linalg.norm(points[2] - points[3])))
    img_crop_height = int(max(np.linalg.norm(points[0] - points[3]),
                              np.linalg.norm(points[1] - points[2])))
    pts_std = np.float32([[0, 0], [img_crop_width, 0],
                          [img_crop_width, img_crop_height],
                          [0, img_crop_height]])
    M = perspective_transform(points, pts_std)
    dst_img = cv_ops.warp_perspective_cubic(
        img, M, (img_crop_width, img_crop_height))
    dst_h, dst_w = dst_img.shape[0:2]
    if dst_h * 1.0 / dst_w >= 1.5:
        dst_img = np.rot90(dst_img)
    return dst_img


def get_minarea_rect_crop(img: np.ndarray, points: np.ndarray) -> np.ndarray:
    """The crop of a poly box: its min-area rect's quad (reference
    onnxocr/utils.py:56-76)."""
    return get_rotate_crop_image(img, minarea_quad(points))


def minarea_quad(points: np.ndarray) -> np.ndarray:
    """Min-area rect of a point set, corners in the DB order (x-sorted
    pairing, reference utils.py:58-74): the crop quad of a poly box."""
    rect = geometry.min_area_rect(np.asarray(points, dtype=np.float32))
    pts = sorted(geometry.box_points(rect).tolist(), key=lambda p: p[0])
    if pts[1][1] > pts[0][1]:
        ia, id_ = 0, 1
    else:
        ia, id_ = 1, 0
    if pts[3][1] > pts[2][1]:
        ib, ic = 2, 3
    else:
        ib, ic = 3, 2
    return np.array([pts[ia], pts[ib], pts[ic], pts[id_]], dtype=np.float32)


def resize_img(img: np.ndarray, input_size: int = 600) -> np.ndarray:
    """Scale the longest side to input_size (reference utils.py:79-88)."""
    img = np.asarray(img)
    im_scale = float(input_size) / max(img.shape[:2])
    return cv_ops.resize_linear(img, None, fx=im_scale, fy=im_scale)


def base64_to_cv2(b64str: str) -> Optional[np.ndarray]:
    """Base64 text of an encoded image → (H, W, 3) uint8 BGR, or None, as
    cv2.imdecode(..., IMREAD_COLOR) reads it (utils/imcodec.imdecode)."""
    return imcodec.imdecode(base64.b64decode(b64str.encode("utf8")))

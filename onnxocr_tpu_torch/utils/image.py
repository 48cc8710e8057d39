"""Host image helpers of the ported paths. Counterpart of
onnxocr_tpu/utils/image.py; the host crop warps there (cv2) are not
ported — crops are warped on the device (ops/warp.py).
"""
from __future__ import annotations

import numpy as np

from ..ops import geometry


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

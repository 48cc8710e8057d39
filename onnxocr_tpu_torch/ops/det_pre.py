"""Detection preprocessing helpers (host side): the reference resize target
and the ImageNet constants. Copy of the parts of onnxocr_tpu/ops/det_pre.py
the one-call path reads.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def det_resize_target(h: int, w: int, limit_side_len: float = 960
                      ) -> Tuple[int, int]:
    """The /32-rounded (resize_h, resize_w) the reference would use
    (DetResizeForTest resize_image_type0, limit_type 'max': the only one
    the one-call path takes)."""
    ratio = float(limit_side_len) / max(h, w) \
        if max(h, w) > limit_side_len else 1.0
    resize_h = int(h * ratio)
    resize_w = int(w * ratio)
    resize_h = max(int(round(resize_h / 32) * 32), 32)
    resize_w = max(int(round(resize_w / 32) * 32), 32)
    return resize_h, resize_w


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m

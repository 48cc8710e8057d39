"""Result drawing: the quad outlines of `onnxocr_tpu/utils/draw.py`
`draw_ocr`, for the service's v2 `return_image` preview.

The outlines are cv2's pixels (`cv_ops.polylines2`, the twin of
`cv2.polylines(img, [pts], True, (255, 0, 0), 2)`). The text panel that the
JAX package draws beside the page when texts are given (and that `sav2Img`
saves) needs a TrueType rasteriser, which this package does not have.
"""
from __future__ import annotations

import math

import numpy as np

from .cv_ops import polylines2


def draw_ocr(image, boxes, txts=None, scores=None,
             drop_score: float = 0.5) -> np.ndarray:
    """A copy of `image` with each box whose score is at least drop_score
    (and not NaN) outlined in (255, 0, 0), two pixels wide; boxes are
    truncated to whole pixels as the JAX package's int64 cast does."""
    if txts is not None:
        raise NotImplementedError(
            "draw_ocr with texts (the text panel of sav2Img) needs a "
            "TrueType rasteriser, which is not ported")
    image = np.array(image)
    if scores is None:
        scores = [1] * len(boxes)
    for quad, score in zip(boxes, scores):
        if score < drop_score or math.isnan(score):
            continue
        polylines2(image, np.asarray(quad, dtype=np.int64).reshape(-1, 2),
                   (255, 0, 0))
    return image

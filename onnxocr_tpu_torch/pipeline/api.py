"""Public API: ONNXPaddleOcr with the reference kwargs and result nesting
(onnxocr_tpu/pipeline/api.py), plus `device` — "cuda" by default; "cpu"
only when the caller passes it."""
from __future__ import annotations

import numpy as np

from .. import config as cfg_mod
from .system import TextSystem


class ONNXPaddleOcr(TextSystem):
    def __init__(self, device="cuda", **kwargs):
        params = cfg_mod.make_params()
        # reference quirk: rec_image_shape is force-set BEFORE the kwargs
        params.rec_image_shape = "3, 48, 320"
        params.__dict__.update(**kwargs)
        params._user_keys = set(kwargs)
        super().__init__(params, device)

    def ocr(self, img, det: bool = True, rec: bool = True, cls: bool = True):
        """det+rec → [[[box_as_lists, (text, score)], ...]]; `cls` runs the
        angle classifier when it was built (use_angle_cls=True). The
        det-only and rec-only forms wait for the cv2-exact host image
        operations (the host det resize, host crops, the classifier's and
        recognizer's resize of crop lists), which are not ported."""
        if cls and not self.use_angle_cls:
            # observable stdout contract of the reference, typo included
            print("Since the angle classifier is not initialized, "
                  "the angle classifier will not be uesd during the forward "
                  "process")
        if not (det and rec):
            raise NotImplementedError(
                "det-only and rec-only calls need the cv2-exact host image "
                "operations (host det resize, host crops), which are not "
                "ported")
        boxes, texts = self(img, cls)
        return [[[np.asarray(b).tolist(), t] for b, t in zip(boxes, texts)]]

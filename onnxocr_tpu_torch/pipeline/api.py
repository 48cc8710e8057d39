"""Public API: ONNXPaddleOcr with the reference kwargs, the det/rec/cls forms
of `ocr()` and their result nesting (onnxocr_tpu/pipeline/api.py), plus
`device` — "cuda" by default; "cpu" only when the caller passes it — and
`sav2Img`, the reference's drawing written as a JPEG."""
from __future__ import annotations

import os

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
        """The reference's forms, in its nesting:

        det+rec      → [[[box_as_lists, (text, score)], ...]]
        det only     → [[box_as_lists, ...]]   (unfiltered by drop_score)
        cls+rec/rec  → [[(text, score), ...]]  over a crop (list)
        cls only     → [[[label, score], ...]]

        `cls` runs the angle classifier when it was built
        (use_angle_cls=True). Without it, rec=False on a crop list gives
        [] (the reference's empty classifier result)."""
        if cls and not self.use_angle_cls:
            # observable stdout contract of the reference, typo included
            print("Since the angle classifier is not initialized, "
                  "the angle classifier will not be uesd during the forward "
                  "process")
        if det:
            if not rec:
                return [[np.asarray(b).tolist()
                         for b in self.text_detector(img)]]
            boxes, texts = self(img, cls)
            return [[[np.asarray(b).tolist(), t]
                     for b, t in zip(boxes, texts)]]
        crops = img if isinstance(img, list) else [img]
        if self.use_angle_cls and cls:
            crops, verdicts = self.text_classifier(crops)
            if not rec:
                return [verdicts]
        if not rec:
            return []
        return [self.text_recognizer(crops)]


_JPEG_EXTENSIONS = (".jpg", ".jpeg", ".jpe", ".jfif")


def sav2Img(org_img, result, name: str = "draw_ocr.jpg"):
    """Render boxes + texts next to the (BGR) image and write it to `name`
    (reference onnx_paddleocr.py:64-77): the bytes PIL's
    `Image.fromarray(rgb).save(name)` writes for a JPEG name, at its default
    quality 75. Other formats are not written."""
    from ..utils.draw import draw_ocr
    from ..utils.imcodec import imencode_jpeg
    if os.path.splitext(name)[1].lower() not in _JPEG_EXTENSIONS:
        raise ValueError(f"sav2Img writes JPEG files only, not {name!r}")
    result = result[0]
    image = org_img[:, :, ::-1]
    boxes = [line[0] for line in result]
    txts = [line[1][0] for line in result]
    scores = [line[1][1] for line in result]
    im_show = draw_ocr(image, boxes, txts, scores)
    with open(name, "wb") as f:
        f.write(imencode_jpeg(im_show[:, :, ::-1], quality=75))

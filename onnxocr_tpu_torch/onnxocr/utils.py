"""Reference surface: onnxocr/utils.py — the geometry and drawing helpers
and infer_args(), an argparse parser built from the port's flag tables
(onnxocr_tpu_torch/config.py: DEFAULTS and INERT_DEFAULTS, the JAX
package's defaults)."""
import argparse

from ..config import DEFAULTS, INERT_DEFAULTS, str2bool
from ..utils.draw import draw_ocr, str_count, text_visual
from ..utils.image import (base64_to_cv2, get_minarea_rect_crop,
                           get_rotate_crop_image, resize_img)

__all__ = ["infer_args", "str2bool", "get_rotate_crop_image",
           "get_minarea_rect_crop", "resize_img", "base64_to_cv2",
           "draw_ocr", "text_visual", "str_count"]


def infer_args() -> argparse.ArgumentParser:
    """A parser with the reference's flag names and the port's defaults;
    ONNXPaddleOcr harvests parser._actions."""
    parser = argparse.ArgumentParser()
    for name, default in {**INERT_DEFAULTS, **DEFAULTS}.items():
        kwargs = {"default": default}
        if isinstance(default, bool):
            kwargs["type"] = str2bool
        elif isinstance(default, (int, float, str)):
            kwargs["type"] = type(default)
        parser.add_argument(f"--{name}", **kwargs)
    return parser

"""Reference surface: onnxocr/onnx_paddleocr.py → ONNXPaddleOcr, sav2Img."""
from ..pipeline.api import ONNXPaddleOcr, sav2Img

__all__ = ["ONNXPaddleOcr", "sav2Img"]

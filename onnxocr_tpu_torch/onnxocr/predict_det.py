"""Reference surface: onnxocr/predict_det.py → TextDetector."""
from ..pipeline.detector import TextDetector

__all__ = ["TextDetector"]

"""Reference surface: onnxocr/predict_rec.py → TextRecognizer."""
from ..pipeline.recognizer import TextRecognizer

__all__ = ["TextRecognizer"]

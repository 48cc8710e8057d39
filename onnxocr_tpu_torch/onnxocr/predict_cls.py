"""Reference surface: onnxocr/predict_cls.py → TextClassifier."""
from ..pipeline.classifier import TextClassifier

__all__ = ["TextClassifier"]

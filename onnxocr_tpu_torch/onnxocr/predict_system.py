"""Reference surface: onnxocr/predict_system.py → TextSystem and
sorted_boxes."""
from ..pipeline.system import TextSystem, sorted_boxes

__all__ = ["TextSystem", "sorted_boxes"]

from .api import ONNXPaddleOcr, sav2Img
from .system import TextSystem, sorted_boxes

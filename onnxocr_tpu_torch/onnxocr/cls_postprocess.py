"""Reference surface: onnxocr/cls_postprocess.py → ClsPostProcess."""
from ..ops.ctc import ClsPostProcess

__all__ = ["ClsPostProcess"]

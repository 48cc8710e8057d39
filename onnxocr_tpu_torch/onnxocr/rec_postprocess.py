"""Reference surface: onnxocr/rec_postprocess.py."""
from ..ops.ctc import CTCLabelDecode, DistillationCTCLabelDecode

__all__ = ["CTCLabelDecode", "DistillationCTCLabelDecode"]

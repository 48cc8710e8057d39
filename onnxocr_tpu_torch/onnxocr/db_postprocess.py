"""Reference surface: onnxocr/db_postprocess.py."""
from ..ops.db_post import DBPostProcess, DistillationDBPostProcess

__all__ = ["DBPostProcess", "DistillationDBPostProcess"]

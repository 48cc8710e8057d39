"""onnxocr_tpu_torch — the PyTorch/CUDA port of onnxocr_tpu.

The PP-OCRv5 pipelines of the JAX package — by default the staged one (det
→ bitpacked DB bitmap → host DB postprocess in C++ → fused cls + rec with
the box scores on the device), and the one-call one — run on an NVIDIA GPU
through hand-written CUDA kernels (csrc/). It imports torch and numpy only
— never jax, and nothing of the onnxocr_tpu package, whose committed data
files (checkpoints, sidecars) it reads by path.
"""
__version__ = "0.1.0"

from .pipeline.api import ONNXPaddleOcr, sav2Img
from .pipeline.system import TextSystem, sorted_boxes

__all__ = ["ONNXPaddleOcr", "sav2Img", "TextSystem", "sorted_boxes"]

"""onnxocr_tpu_torch — the PyTorch/CUDA port of onnxocr_tpu.

The one-call PP-OCRv5 path (det → device DB boxes → rec → fused CTC head)
runs on an NVIDIA GPU through hand-written CUDA kernels (csrc/). It imports
torch and numpy only — never jax, and nothing of the onnxocr_tpu package,
whose committed data files (checkpoints, sidecars) it reads by path.
"""
from .pipeline.api import ONNXPaddleOcr

__all__ = ["ONNXPaddleOcr"]

"""The reference package's layout (ding113/OnnxOCR `onnxocr/`) over the
port: code written as `from onnxocr.onnx_paddleocr import ONNXPaddleOcr`
runs on the H100 as `from onnxocr_tpu_torch.onnxocr.onnx_paddleocr import
ONNXPaddleOcr`. Every module here re-exports onnxocr_tpu_torch, module for
module as the JAX package's `onnxocr/` shim re-exports onnxocr_tpu."""

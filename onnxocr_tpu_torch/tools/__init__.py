"""Command-line tools of the port
(python -m onnxocr_tpu_torch.tools.<name>)."""

"""Training: the DB and CTC trainers and their AdamW (counterpart of
onnxocr_tpu/train; the synthetic data renderer is not ported yet)."""

"""Training: the DB and CTC trainers, their AdamW and the synthetic-data
renderer (counterpart of onnxocr_tpu/train)."""

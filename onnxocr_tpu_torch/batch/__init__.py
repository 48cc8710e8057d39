"""Batch image/PDF OCR (counterpart of onnxocr_tpu/batch): `OCRLogic` and
the PDF page extractors."""

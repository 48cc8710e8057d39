"""Reference surface: onnxocr/ocr_images_pdfs.py → OCRLogic and
pdf_to_images."""
from ..batch.logic import OCRLogic
from ..batch.pdf import pdf_to_images

__all__ = ["OCRLogic", "pdf_to_images"]

"""PDF page → image extraction: counterpart of onnxocr_tpu/batch/pdf.py.

The reference rasterizes PDF pages with pymupdf (C library,
onnxocr/ocr_images_pdfs.py:21-35). pymupdf is absent on both machines the
two packages run on, and this package does not read it, so the JAX
package's fallback order is the only route here:

1. a pure-Python embedded-image extractor for the dominant OCR case —
   scanned PDFs whose pages are single full-page images (JPEG /DCTDecode,
   decoded by utils/imcodec.imdecode as cv2.imdecode decodes them, or zlib
   /FlateDecode XObjects), else
2. the vector rasterizer (pdf_raster.py) for digitally-born PDFs' text +
   filled-rect subset. Only when both fail does the call raise.

Returned images are RGB numpy arrays (the batch layer converts RGB→BGR).
"""
from __future__ import annotations

import re
import zlib
from typing import List

import numpy as np

from ..utils import imcodec


def pdf_to_images(pdf_path: str, dpi: int = 200) -> List[np.ndarray]:
    # Malformed/truncated PDFs must degrade per-file, never kill a batch
    # (reference contract: per-item error reporting,
    # onnxocr/ocr_images_pdfs.py:86-95). Any failure in one extractor —
    # not just a clean RuntimeError — falls through to the next; only
    # when both fail does the call raise, and the batch layer catches it.
    try:
        return extract_embedded_images(pdf_path)
    except Exception as img_err:  # noqa: BLE001 — fall through by design
        from . import pdf_raster
        try:
            return pdf_raster.render_pdf_pages(pdf_path, dpi=min(dpi, 200))
        except Exception as vec_err:  # noqa: BLE001
            raise RuntimeError(f"{img_err}; {vec_err}") from None


_STREAM_RE = re.compile(rb"stream\r?\n", re.S)


def _iter_objects(data: bytes):
    """Yield (dict_bytes, stream_bytes_or_None) for each indirect object."""
    for m in re.finditer(rb"\d+\s+\d+\s+obj\b", data):
        start = m.end()
        end = data.find(b"endobj", start)
        if end < 0:
            continue
        body = data[start:end]
        sm = _STREAM_RE.search(body)
        if sm:
            head = body[:sm.start()]
            stream = body[sm.end():]
            es = stream.rfind(b"endstream")
            if es >= 0:
                stream = stream[:es].rstrip(b"\r\n")
        else:
            head = body
            stream = None
        yield head, stream


def _dict_int(head: bytes, key: bytes, default: int = 0) -> int:
    m = re.search(key + rb"\s+(\d+)", head)
    return int(m.group(1)) if m else default


def extract_embedded_images(pdf_path: str, min_pixels: int = 64 * 64
                            ) -> List[np.ndarray]:
    with open(pdf_path, "rb") as f:
        data = f.read()
    images: List[np.ndarray] = []
    for head, stream in _iter_objects(data):
        if stream is None or b"/Image" not in head:
            continue
        w = _dict_int(head, rb"/Width")
        h = _dict_int(head, rb"/Height")
        if w * h < min_pixels:
            continue
        if b"/DCTDecode" in head:
            img = imcodec.imdecode(stream)
            if img is not None:
                images.append(np.ascontiguousarray(img[:, :, ::-1]))
        elif b"/FlateDecode" in head:
            try:
                raw = zlib.decompress(stream)
            except zlib.error:
                continue
            bpc = _dict_int(head, rb"/BitsPerComponent", 8)
            if bpc != 8:
                continue
            if b"/DeviceRGB" in head and len(raw) >= w * h * 3:
                img = np.frombuffer(raw[: w * h * 3],
                                    np.uint8).reshape(h, w, 3)
                images.append(img.copy())
            elif b"/DeviceGray" in head and len(raw) >= w * h:
                gray = np.frombuffer(raw[: w * h], np.uint8).reshape(h, w)
                images.append(np.stack([gray] * 3, axis=-1))
    if not images:
        raise RuntimeError(
            f"{pdf_path}: no extractable page images (vector-only PDF?). "
            "Install pymupdf for full rasterization support.")
    return images

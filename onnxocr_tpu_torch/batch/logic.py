"""Batch image/PDF OCR: ingest → device-batched recognize → emit.
Counterpart of onnxocr_tpu/batch/logic.py on the GPU: the same stages,
output contract and placeholders, with a `device` argument ("cuda" by
default) passed to the pipeline; images decode through utils/imcodec (the
cv2.imdecode twin) and overlays are written by `sav2Img`.

Output contract follows the reference batch layer (onnxocr/ocr_images_pdfs.py
OCRLogic): per-file txt under Output_OCR/ beside the input, optional merged
txt, overlay jpgs, the everything-decodes-with-the-v5-dict model-swap quirk
(:229), and its placeholder strings. The *execution model* is redesigned for
the TPU: the reference pushes whole files through `model.ocr` from a thread
pool (so every page pays its own det/cls/rec session runs); here a run is a
three-stage page pipeline —

1. **ingest** — worker threads decode images / pull PDF pages (host-CPU
   only) into one flat page work-list;
2. **recognize** — pages flow through the shared pipeline with cross-page
   det batching enabled (runtime/batcher.DetPageBatcher): DBNet forwards of
   pages in flight coalesce into single device calls, and each page's crops
   already run as per-width-bucket batches, so device utilization grows
   with the work-list instead of with luck;
3. **emit** — results regroup by file and render txt / overlays / merged
   output.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List

import numpy as np

from ..pipeline.api import ONNXPaddleOcr, sav2Img
from .. import config as cfg_mod
from ..utils import imcodec
from . import pdf as pdf_mod

_EMPTY_PAGE = "[未检测到内容]"   # reference placeholder strings are part of
_UNRECOGNIZED = "[未识别] "      # the txt-output contract (:184-201)


@dataclass
class _FileJob:
    path: str
    index: int
    pages: List[np.ndarray] = field(default_factory=list)
    page_texts: List[str] = field(default_factory=list)
    is_pdf: bool = False
    error: str = ""
    started: float = 0.0
    elapsed: float = 0.0


class OCRLogic:
    def __init__(self, status_callback: Callable[[str], None],
                 device: str = "cuda"):
        self.status_callback = status_callback
        self.device = device
        self.model = ONNXPaddleOcr(device=device, use_angle_cls=True,
                                   use_gpu=False)
        self._batching_enabled = False

    # ------------------------------------------------------------- pipeline
    def run(self, files: List[str], save_txt: bool, merge_txt: bool,
            output_img: bool = False, file_time_callback=None,
            pdf_progress_callback=None, max_workers: int = 4):
        start = time.time()
        self._total = len(files)
        jobs = [_FileJob(path=f, index=i) for i, f in enumerate(files)]

        self._enable_page_batching()
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            # stage 1: decode/rasterize everything (host CPU only)
            list(pool.map(self._ingest, jobs))
            # stage 2: flat page work-list through the device pipeline;
            # concurrent pages batch inside DetPageBatcher / width buckets
            work = [(job, pno) for job in jobs if not job.error
                    for pno in range(len(job.pages))]
            for job in jobs:
                job.page_texts = [""] * len(job.pages)
                job.started = time.time()
            done_pages = {job.index: 0 for job in jobs}

            def recognize(item):
                job, pno = item
                text = self._ocr_page(job, pno, output_img=output_img)
                job.page_texts[pno] = text
                done_pages[job.index] += 1
                if job.is_pdf and pdf_progress_callback:
                    pdf_progress_callback(done_pages[job.index],
                                          len(job.pages))
                if done_pages[job.index] == len(job.pages):
                    job.elapsed = time.time() - job.started
                    self.status_callback(
                        f"{os.path.basename(job.path)} took "
                        f"{job.elapsed:.2f}s")

            list(pool.map(recognize, work))

        # stage 3: emit per-file txt + merged txt
        for job in jobs:
            if file_time_callback:
                file_time_callback(job.index, job.elapsed)
            if not job.error and save_txt and job.pages:
                self._write_file_txt(job)
        all_text = ["\n\n".join(j.page_texts) if not j.error else ""
                    for j in jobs]
        if save_txt and merge_txt and len(files) > 1:
            self._write_merged_txt(files[0], all_text)

        elapsed = time.time() - start
        where = f", outputs in {self._get_output_dir(files[0])}" \
            if files else ""
        self.status_callback(f"done in {elapsed:.2f}s{where}")
        return all_text

    # --------------------------------------------------------------- stages
    def _enable_page_batching(self):
        if self._batching_enabled:
            return
        det = getattr(self.model, "text_detector", None)
        if det is not None and det._page_batcher is None:
            det.enable_page_batching()
        self._batching_enabled = True

    def _ingest(self, job: _FileJob):
        self.status_callback(
            f"processing: {os.path.basename(job.path)} "
            f"({job.index + 1}/{getattr(self, '_total', '?')})")
        ext = os.path.splitext(job.path)[1].lower()
        try:
            if ext == ".pdf":
                job.is_pdf = True
                rgb_pages = pdf_mod.pdf_to_images(job.path, dpi=300)
                job.pages = [np.ascontiguousarray(np.asarray(p)[:, :, ::-1])
                             for p in rgb_pages]
            else:
                # byte-buffer decode keeps non-ASCII paths working
                with open(job.path, "rb") as f:
                    buf = f.read()
                img = imcodec.imdecode(buf)
                if img is None:
                    raise ValueError("not a valid image")
                job.pages = [img]
        except Exception as e:
            job.error = str(e)
            self.status_callback(f"read failed: {job.path}: {e}")

    def _ocr_page(self, job: _FileJob, pno: int, output_img: bool) -> str:
        img = job.pages[pno]
        result = self.model.ocr(img)
        if output_img:
            stem = Path(job.path).stem
            name = (f"{stem}_page{pno + 1}_ocr.jpg" if job.is_pdf
                    else f"{stem}_ocr.jpg")
            sav2Img(img, result,
                    name=os.path.join(self._get_output_dir(job.path), name))
        return self._result_to_text(result)

    def _write_file_txt(self, job: _FileJob):
        stamp = time.strftime("%Y%m%d_%H%M%S")
        out = os.path.join(self._get_output_dir(job.path),
                           f"{Path(job.path).stem}_ocr_{stamp}.txt")
        with open(out, "w", encoding="utf-8") as f:
            f.write("\n\n".join(job.page_texts))

    def _write_merged_txt(self, first_file: str, texts: List[str]):
        stamp = time.strftime("%Y%m%d_%H%M%S")
        out = os.path.join(self._get_output_dir(first_file),
                           f"merged_ocr_{stamp}.txt")
        with open(out, "w", encoding="utf-8") as f:
            for t in texts:
                if t:
                    f.write(t + "\n\n")

    # ------------------------------------------------------------ rendering
    def _result_to_text(self, result) -> str:
        """OCR result structure → plain text, with the reference's
        placeholders for empty/odd shapes."""
        page = result[0] if isinstance(result, list) and result else None
        if not page or not isinstance(page, list):
            return _EMPTY_PAGE
        lines = []
        for entry in page:
            text = self._entry_text(entry)
            lines.append(text)
        return "\n".join(lines)

    @staticmethod
    def _entry_text(entry) -> str:
        if isinstance(entry, list) and len(entry) == 2 and \
                isinstance(entry[1], (list, tuple)) and entry[1]:
            return str(entry[1][0])            # [box, (text, score)]
        if isinstance(entry, list) and entry and \
                isinstance(entry[0], (list, tuple, float)):
            return _UNRECOGNIZED + str(entry)  # box-like but no text
        return str(entry)

    def _get_output_dir(self, file_path: str) -> str:
        out_dir = os.path.join(os.path.dirname(file_path), "Output_OCR")
        os.makedirs(out_dir, exist_ok=True)
        return out_dir

    # ------------------------------------------------------------ model swap
    def set_model(self, model_name: str, use_gpu: bool = False):
        """Hot-swap the pipeline; every model decodes with the v5 dict
        (reference :212-241 quirk)."""
        model_map = {"PP-OCRv5": "ppocrv5", "PP-OCRv4": "ppocrv4",
                     "ch_ppocr_server_v2.0": "ch_ppocr_server_v2.0"}
        model_dir = model_map.get(model_name, "ppocrv5")
        kwargs = dict(
            device=getattr(self, "device", "cuda"),
            use_angle_cls=True,
            use_gpu=use_gpu,
            det_model_dir=cfg_mod.find_asset(f"{model_dir}/det/det.onnx"),
            cls_model_dir=cfg_mod.find_asset(f"{model_dir}/cls/cls.onnx"),
            rec_char_dict_path=cfg_mod.find_asset(
                "ppocrv5/ppocrv5_dict.txt"),
        )
        rec_path = cfg_mod.find_asset(f"{model_dir}/rec/rec.onnx")
        if os.path.exists(rec_path):
            kwargs["rec_model_dir"] = rec_path
        self.model = ONNXPaddleOcr(**kwargs)
        self._batching_enabled = False

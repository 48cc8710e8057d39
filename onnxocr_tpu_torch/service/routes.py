"""HTTP routes: v1 (/ocr base64 JSON), v2 (/api/v2/* multipart), health, UI.

Byte-compatible contracts with the reference:
* v1: app/routers/v1.py:48-115 (originally app-service.py:18-67) —
  {"image": base64} → {"processing_time", "results": [{"text",
  "confidence", "bounding_box"}]}; errors as {"error": ...} 400/500.
* v2: app/routers/v2.py:138-388 — multipart file/files, model_name,
  conf_threshold, output_format json/text/tsv/hocr, bbox, return_image;
  multi-file session dirs + txt + zip + zip_url; /tasks/{id};
  /healthz; /readyz gated on engine.ready.

Counterpart of onnxocr_tpu/service/routes.py, giving its responses for the
same uploads: uploads decode through utils/imcodec.py (cv2.imdecode's
pixels and its None), the preview's quads draw through utils/draw.py and
encode as cv2.imencode's JPEG.
"""
from __future__ import annotations

import base64
import os
import time
import zipfile
from typing import Any, Dict, List

import numpy as np

from ..utils import imcodec
from ..utils.draw import draw_ocr
from .http import (App, HTTPError, Request, Response, file_response,
                   json_response, text_response)
from .engine import get_engine_manager
from .settings import settings

MODEL_NAMES = ("PP-OCRv5", "PP-OCRv4", "ch_ppocr_server_v2.0")
OUTPUT_FORMATS = ("json", "text", "tsv", "hocr")

# in-memory task store (reference keeps the same restart-lossy stub,
# app/routers/v2.py:87-88)
task_store: Dict[str, Any] = {}


def _decode_image(content: bytes):
    return imcodec.imdecode(content)


def _format_results(result, bbox: bool = True) -> List[Dict[str, Any]]:
    out = []
    if result and result[0]:
        for line in result[0]:
            if isinstance(line[0], (list, np.ndarray)):
                bounding_box = np.array(line[0]).reshape(4, 2).tolist() \
                    if bbox else None
            else:
                bounding_box = None
            out.append({"text": line[1][0],
                        "confidence": float(line[1][1]),
                        "bounding_box": bounding_box})
    return out


def results_to_text(results: List[Dict[str, Any]]) -> str:
    return "\n".join(item["text"] for item in results)


def results_to_tsv(results: List[Dict[str, Any]]) -> str:
    lines = ["text\tconfidence\tbbox"]
    for item in results:
        bbox_str = str(item["bounding_box"]) if item["bounding_box"] else ""
        lines.append(f"{item['text']}\t{item['confidence']}\t{bbox_str}")
    return "\n".join(lines)


def results_to_hocr(results: List[Dict[str, Any]]) -> str:
    lines = ['<?xml version="1.0" encoding="UTF-8"?>',
             '<!DOCTYPE html PUBLIC "-//W3C//DTD XHTML 1.0 Transitional//EN"',
             '"http://www.w3.org/TR/xhtml1/DTD/xhtml1-transitional.dtd">',
             '<html xmlns="http://www.w3.org/1999/xhtml" xml:lang="en" '
             'lang="en">',
             '<head><title></title></head><body>']
    for item in results:
        bb = item["bounding_box"]
        if bb and len(bb) >= 4:
            x1, y1 = bb[0]
            x2, y2 = bb[2]
            bbox = f"bbox {int(x1)} {int(y1)} {int(x2)} {int(y2)}"
            conf = int(item["confidence"] * 100)
            lines.append(f'<span class="ocrx_word" title="{bbox}; '
                         f'x_wconf {conf}">{item["text"]}</span>')
        else:
            lines.append(f'<span class="ocrx_word">{item["text"]}</span>')
    lines.append('</body></html>')
    return "\n".join(lines)


def generate_timestamp() -> str:
    return time.strftime("%Y%m%d_%H%M%S")


def _render_preview(img, result) -> str:
    """Detected quads drawn onto the image → base64 JPEG (the v2
    `return_image` feature the reference left as a TODO)."""
    page = result[0] if result else []
    boxes = [entry[0] for entry in page]
    overlay = draw_ocr(img.copy(), boxes, drop_score=0.0)
    return base64.b64encode(imcodec.imencode_jpeg(overlay, 85)).decode(
        "ascii")


def build_app() -> App:
    app = App()

    @app.on_startup
    def _warmup():
        get_engine_manager().warmup()

    # ------------------------------------------------------------- health
    @app.get("/health")
    async def health(request: Request) -> Response:
        return json_response({"status": "healthy",
                              "service": "OCR Web Service"})

    @app.get("/api/v2/healthz")
    async def healthz(request: Request) -> Response:
        return json_response({"status": "ok", "timestamp": time.time()})

    @app.get("/api/v2/readyz")
    async def readyz(request: Request) -> Response:
        engine = get_engine_manager()
        if not engine.ready:
            raise HTTPError(503, {"status": "not ready",
                                  "message": "Models not loaded"})
        return json_response({"status": "ready", "timestamp": time.time()})

    # ------------------------------------------------------------------ v1
    @app.post("/ocr")
    async def ocr_v1(request: Request) -> Response:
        try:
            payload = request.json()
            if not isinstance(payload, dict) or not payload.get("image"):
                return json_response(
                    {"error": "Invalid request, 'image' field is required."},
                    400)
            try:
                image_bytes = base64.b64decode(payload["image"])
                img = _decode_image(image_bytes)
                if img is None:
                    return json_response(
                        {"error": "Failed to decode image from base64."},
                        400)
            except HTTPError:
                raise
            except Exception as e:
                return json_response(
                    {"error": f"Image decoding failed: {e}"}, 400)

            engine = get_engine_manager()
            # v1 always uses the default model, no conf_threshold (quirk #10)
            processing_time, result = await engine.run_ocr(img)
            return json_response({
                "processing_time": processing_time,
                "results": _format_results(result, bbox=True),
            })
        except HTTPError:
            raise
        except Exception as e:
            return json_response({"error": f"An error occurred: {e}"}, 500)

    # ------------------------------------------------------------------ v2
    @app.post("/api/v2/ocr")
    async def ocr_v2(request: Request) -> Response:
        fields, files = request.form()
        if not files:
            raise HTTPError(400, {"error": "No files provided",
                                  "code": "VALIDATION_ERROR"})

        model_name = fields.get("model_name", [settings.DEFAULT_MODEL])[0]
        if model_name not in MODEL_NAMES:
            raise HTTPError(422, {"error": f"invalid model_name "
                                  f"{model_name!r}", "code":
                                  "VALIDATION_ERROR"})
        try:
            conf_threshold = float(fields.get("conf_threshold", ["0.5"])[0])
        except ValueError:
            raise HTTPError(422, {"error": "invalid conf_threshold",
                                  "code": "VALIDATION_ERROR"})
        output_format = fields.get("output_format", ["json"])[0]
        if output_format not in OUTPUT_FORMATS:
            raise HTTPError(422, {"error": f"invalid output_format "
                                  f"{output_format!r}",
                                  "code": "VALIDATION_ERROR"})
        bbox = fields.get("bbox", ["true"])[0].lower() in ("true", "t", "1")
        # improvement over the reference, which accepts return_image but
        # ships it as a TODO (app/routers/v2.py:146,267 preview_image=None):
        # here it returns a base64 JPEG with the detected quads drawn.
        return_image = fields.get("return_image", ["false"])[0].lower() \
            in ("true", "t", "1")

        total_size = sum(len(f.data) for f in files)
        if total_size > settings.MAX_CONTENT_LENGTH:
            raise HTTPError(413, {
                "error": f"Total file size exceeds "
                         f"{settings.MAX_UPLOAD_MB}MB limit",
                "code": "FILE_TOO_LARGE"})

        engine = get_engine_manager()
        start_time = time.time()

        if len(files) == 1:
            up = files[0]
            if not up.content_type or not \
                    up.content_type.startswith("image/"):
                if not up.filename or not up.filename.lower().endswith(
                        (".jpg", ".jpeg", ".png", ".bmp", ".pdf")):
                    raise HTTPError(415, {"error": "Unsupported file type",
                                          "code": "UNSUPPORTED_MEDIA_TYPE"})
            if up.filename and up.filename.lower().endswith(".pdf"):
                # quirk #14: v2 rejects PDFs even though the batch layer
                # supports them (app/routers/v2.py:216-222)
                raise HTTPError(415, {
                    "error": "PDF processing not implemented yet",
                    "code": "UNSUPPORTED_MEDIA_TYPE"})
            img = _decode_image(up.data)
            if img is None:
                raise HTTPError(400, {"error": "Failed to decode image",
                                      "code": "VALIDATION_ERROR"})
            processing_time, result = await engine.run_ocr(
                img, model_name=model_name, conf_threshold=conf_threshold)
            results = _format_results(result, bbox=bbox)
            if output_format == "json":
                preview = _render_preview(img, result) if return_image \
                    else None
                return json_response({"processing_time": processing_time,
                                      "results": results,
                                      "preview_image": preview})
            if output_format == "text":
                return json_response({"text": results_to_text(results),
                                      "processing_time": processing_time})
            if output_format == "tsv":
                return json_response({"tsv": results_to_tsv(results),
                                      "processing_time": processing_time})
            return json_response({"hocr": results_to_hocr(results),
                                  "processing_time": processing_time})

        # multi-file
        timestamp = generate_timestamp()
        session_dir = os.path.join(settings.RESULTS_DIR, timestamp)
        os.makedirs(session_dir, exist_ok=True)
        items: List[Dict[str, Any]] = []
        for up in files:
            try:
                img = _decode_image(up.data)
                if img is None:
                    continue
                _, result = await engine.run_ocr(
                    img, model_name=model_name,
                    conf_threshold=conf_threshold)
                results = _format_results(result, bbox=bbox)
                if output_format == "text":
                    text_content = results_to_text(results)
                    items.append({"filename": up.filename,
                                  "text": text_content})
                    stem = os.path.splitext(os.path.basename(
                        up.filename or "file"))[0]
                    with open(os.path.join(session_dir, stem + ".txt"),
                              "w", encoding="utf-8") as f:
                        f.write(text_content)
                else:
                    items.append({"filename": up.filename,
                                  "results": results})
            except Exception as e:  # per-file isolation (v2.py:328-330)
                items.append({"filename": up.filename, "error": str(e)})

        zip_url = None
        if output_format == "text" and items:
            zip_path = os.path.join(session_dir,
                                    f"ocr_txt_{timestamp}.zip")
            with zipfile.ZipFile(zip_path, "w") as zf:
                for name in os.listdir(session_dir):
                    if name.endswith(".txt"):
                        zf.write(os.path.join(session_dir, name), name)
            zip_url = f"/download/{timestamp}"

        return json_response({
            "processing_time": time.time() - start_time,
            "items": items,
            "zip_url": zip_url,
        })

    @app.get("/api/v2/tasks/{task_id}")
    async def get_task(request: Request) -> Response:
        task_id = request.path_params["task_id"]
        if task_id not in task_store:
            raise HTTPError(404, {"error": "Task not found",
                                  "code": "NOT_FOUND"})
        return json_response(task_store[task_id])

    # ------------------------------------------------------------ download
    @app.get("/download/{timestamp}")
    async def download(request: Request) -> Response:
        ts = request.path_params["timestamp"]
        if "/" in ts or ".." in ts:
            raise HTTPError(400, {"error": "invalid timestamp"})
        session_dir = os.path.join(settings.RESULTS_DIR, ts)
        zip_path = os.path.join(session_dir, f"ocr_txt_{ts}.zip")
        if not os.path.exists(zip_path):
            raise HTTPError(404, {"error": "download not found"})
        return file_response(zip_path, "application/zip",
                             download_name=os.path.basename(zip_path))

    @app.get("/static/{filename}")
    async def static_file(request: Request) -> Response:
        name = request.path_params["filename"]
        if "/" in name or ".." in name:
            raise HTTPError(400, {"error": "invalid path"})
        root = os.environ.get("STATIC_DIR", "static")
        path = os.path.join(root, name)
        if not os.path.exists(path):
            raise HTTPError(404, {"error": "not found"})
        ctype = {"css": "text/css", "js": "application/javascript",
                 "html": "text/html", "png": "image/png",
                 "jpg": "image/jpeg"}.get(name.rsplit(".", 1)[-1],
                                          "application/octet-stream")
        return file_response(path, ctype)

    # ------------------------------------------------------------------ UI
    @app.get("/")
    async def index(request: Request) -> Response:
        from . import ui
        return text_response(ui.render_index(MODEL_NAMES),
                             content_type="text/html; charset=utf-8")

    return app

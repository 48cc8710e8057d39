"""Minimal asyncio HTTP framework (stdlib-only). Own copy of
onnxocr_tpu/service/http.py (importing that module would import JAX through
its package): the same routing, status lines, headers and JSON bodies.

The reference serves via FastAPI/uvicorn/gunicorn (app/main.py, Dockerfile);
neither is installable in this environment, so the service layer ships its
own small HTTP/1.1 server with the pieces the OCR API needs: routing with
path params, JSON bodies, multipart/form-data uploads, middleware
(request-ID propagation, access logs, exception normalization — mirroring
app/middleware.py), and an in-process TestClient for contract tests.
"""
from __future__ import annotations

import asyncio
import json
import logging
import re
import time
import traceback
import uuid
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlsplit

logger = logging.getLogger("onnxocr_tpu_torch.service")

REASONS = {200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request",
            404: "Not Found", 405: "Method Not Allowed",
            413: "Payload Too Large", 415: "Unsupported Media Type",
            422: "Unprocessable Entity", 500: "Internal Server Error",
            503: "Service Unavailable"}


class HTTPError(Exception):
    def __init__(self, status_code: int, detail: Any = None):
        self.status_code = status_code
        self.detail = detail
        super().__init__(str(detail))


class UploadFile:
    def __init__(self, name: str, filename: str, content_type: str,
                 data: bytes):
        self.name = name
        self.filename = filename
        self.content_type = content_type
        self.data = data

    def __repr__(self):
        return f"UploadFile({self.filename!r}, {len(self.data)}B)"


class Request:
    def __init__(self, method: str, target: str, headers: Dict[str, str],
                 body: bytes):
        self.method = method.upper()
        parts = urlsplit(target)
        self.path = unquote(parts.path)
        self.query: Dict[str, List[str]] = parse_qs(parts.query)
        self.headers = headers
        self.body = body
        self.path_params: Dict[str, str] = {}
        self.request_id: str = ""

    def query_one(self, key: str, default: Optional[str] = None):
        vals = self.query.get(key)
        return vals[0] if vals else default

    def json(self) -> Any:
        try:
            return json.loads(self.body.decode("utf-8") or "null")
        except (ValueError, UnicodeDecodeError) as e:
            raise HTTPError(400, {"error": f"invalid JSON body: {e}"})

    def form(self) -> Tuple[Dict[str, List[str]], List[UploadFile]]:
        ctype = self.headers.get("content-type", "")
        if ctype.startswith("application/x-www-form-urlencoded"):
            return parse_qs(self.body.decode("utf-8")), []
        if ctype.startswith("multipart/form-data"):
            m = re.search(r'boundary="?([^";]+)"?', ctype)
            if not m:
                raise HTTPError(400, {"error": "missing multipart boundary"})
            return parse_multipart(self.body, m.group(1).encode())
        return {}, []


def parse_multipart(body: bytes, boundary: bytes
                    ) -> Tuple[Dict[str, List[str]], List[UploadFile]]:
    fields: Dict[str, List[str]] = {}
    files: List[UploadFile] = []
    delim = b"--" + boundary
    segments = body.split(delim)
    for seg in segments[1:]:
        if seg in (b"--", b"--\r\n", b"", b"\r\n"):
            continue
        seg = seg.lstrip(b"\r\n")
        if seg.endswith(b"\r\n"):
            seg = seg[:-2]
        head, _, payload = seg.partition(b"\r\n\r\n")
        headers: Dict[str, str] = {}
        for line in head.split(b"\r\n"):
            k, _, v = line.partition(b":")
            headers[k.decode("latin1").strip().lower()] = \
                v.decode("latin1").strip()
        disp = headers.get("content-disposition", "")
        name_m = re.search(r'name="([^"]*)"', disp)
        file_m = re.search(r'filename="([^"]*)"', disp)
        name = name_m.group(1) if name_m else ""
        if file_m is not None:
            files.append(UploadFile(
                name, file_m.group(1),
                headers.get("content-type", "application/octet-stream"),
                payload))
        else:
            fields.setdefault(name, []).append(
                payload.decode("utf-8", "replace"))
    return fields, files


class Response:
    def __init__(self, body: bytes = b"", status: int = 200,
                 headers: Optional[Dict[str, str]] = None,
                 content_type: str = "application/octet-stream"):
        self.body = body
        self.status = status
        self.headers = dict(headers or {})
        self.headers.setdefault("content-type", content_type)

    @property
    def status_code(self) -> int:
        return self.status

    def json(self) -> Any:
        return json.loads(self.body.decode("utf-8"))

    @property
    def text(self) -> str:
        return self.body.decode("utf-8", "replace")


def json_response(obj: Any, status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(json.dumps(obj, ensure_ascii=False).encode("utf-8"),
                    status, headers, "application/json")


def text_response(text: str, status: int = 200,
                  content_type: str = "text/plain; charset=utf-8"
                  ) -> Response:
    return Response(text.encode("utf-8"), status, None, content_type)


def file_response(path: str, content_type: str = "application/octet-stream",
                  download_name: Optional[str] = None) -> Response:
    with open(path, "rb") as f:
        data = f.read()
    headers = {}
    if download_name:
        headers["content-disposition"] = \
            f'attachment; filename="{download_name}"'
    return Response(data, 200, headers, content_type)


Handler = Callable[[Request], Awaitable[Response]]


class App:
    """Routing + the reference's middleware semantics: X-Request-ID
    passthrough/generation, access logging with X-Process-Time, exceptions
    normalized to {"error", "code", "request_id"} 500s
    (app/middleware.py:18-123)."""

    def __init__(self):
        self._routes: List[Tuple[str, re.Pattern, Handler]] = []
        self.state: Dict[str, Any] = {}
        self._startup_hooks: List[Callable] = []

    def route(self, method: str, pattern: str):
        regex = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$")

        def deco(fn: Handler):
            self._routes.append((method.upper(), regex, fn))
            return fn
        return deco

    def get(self, pattern):
        return self.route("GET", pattern)

    def post(self, pattern):
        return self.route("POST", pattern)

    def on_startup(self, fn):
        self._startup_hooks.append(fn)
        return fn

    async def startup(self):
        for fn in self._startup_hooks:
            res = fn()
            if asyncio.iscoroutine(res):
                await res

    async def startup_background(self):
        """Run SYNC startup hooks (engine warmup: model init, the host
        libraries' and kernels' builds, first device ops) in a worker thread so
        the server socket binds immediately; /api/v2/readyz flips to 200
        only when warmup succeeds (engine.ready), /healthz answers
        throughout. Coroutine hooks still run on the loop."""
        loop = asyncio.get_event_loop()
        for fn in self._startup_hooks:
            if asyncio.iscoroutinefunction(fn):
                await fn()
            else:
                res = await loop.run_in_executor(None, fn)
                if asyncio.iscoroutine(res):
                    await res

    async def handle(self, request: Request) -> Response:
        request.request_id = request.headers.get("x-request-id") or \
            uuid.uuid4().hex
        start = time.time()
        try:
            response = await self._dispatch(request)
        except HTTPError as e:
            detail = e.detail if e.detail is not None else \
                {"error": REASONS.get(e.status_code, "error")}
            if not isinstance(detail, dict):
                detail = {"error": str(detail)}
            response = json_response({"detail": detail} if False else detail,
                                     e.status_code)
        except Exception as e:  # normalized 500 (middleware.py:97-123)
            logger.error("unhandled error: %s\n%s", e,
                         traceback.format_exc())
            response = json_response(
                {"error": str(e), "code": "INTERNAL_ERROR",
                 "request_id": request.request_id}, 500)
        dur = time.time() - start
        response.headers["x-request-id"] = request.request_id
        response.headers["x-process-time"] = f"{dur:.4f}"
        logger.info("%s %s -> %d (%.1fms)", request.method, request.path,
                    response.status, dur * 1000)
        return response

    async def _dispatch(self, request: Request) -> Response:
        allowed = []
        for method, regex, fn in self._routes:
            m = regex.match(request.path)
            if m:
                if method != request.method:
                    allowed.append(method)
                    continue
                request.path_params = m.groupdict()
                return await fn(request)
        if allowed:
            raise HTTPError(405, {"error": "method not allowed"})
        raise HTTPError(404, {"error": "not found"})


class TestClient:
    """In-process client for contract tests (no sockets)."""

    __test__ = False  # not a pytest class

    def __init__(self, app: App):
        self.app = app
        loop = asyncio.new_event_loop()
        self._loop = loop
        loop.run_until_complete(app.startup())

    def request(self, method: str, path: str, headers=None, body: bytes = b"",
                json_body=None, files=None, data=None) -> Response:
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        if json_body is not None:
            body = json.dumps(json_body).encode()
            headers["content-type"] = "application/json"
        elif files is not None or data is not None:
            boundary = uuid.uuid4().hex
            parts = []
            for k, v in (data or {}).items():
                parts.append(
                    f'--{boundary}\r\nContent-Disposition: form-data; '
                    f'name="{k}"\r\n\r\n{v}\r\n'.encode())
            for name, (filename, blob, ctype) in (files or []):
                parts.append(
                    f'--{boundary}\r\nContent-Disposition: form-data; '
                    f'name="{name}"; filename="{filename}"\r\n'
                    f'Content-Type: {ctype}\r\n\r\n'.encode() + blob +
                    b"\r\n")
            parts.append(f"--{boundary}--\r\n".encode())
            body = b"".join(parts)
            headers["content-type"] = \
                f"multipart/form-data; boundary={boundary}"
        req = Request(method, path, headers, body)
        return self._loop.run_until_complete(self.app.handle(req))

    def get(self, path, **kw):
        return self.request("GET", path, **kw)

    def post(self, path, **kw):
        return self.request("POST", path, **kw)


async def serve(app: App, host: str = "0.0.0.0", port: int = 5005,
                max_body: int = 256 * 1024 * 1024):
    # bind FIRST, warm up in the background: health endpoints must answer
    # while the engine builds and warms (reference uvicorn blocks on
    # startup, but an unreachable socket is indistinguishable from a crash)
    startup_task = asyncio.ensure_future(app.startup_background())

    def _log_startup_failure(t):
        if not t.cancelled() and t.exception() is not None:
            logging.getLogger("service").error(
                "startup hook failed: %r", t.exception())

    startup_task.add_done_callback(_log_startup_failure)

    async def client(reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter):
        try:
            while True:
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    break
                try:
                    method, target, _version = \
                        line.decode("latin1").strip().split(" ", 2)
                except ValueError:
                    break
                headers: Dict[str, str] = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode("latin1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                length = int(headers.get("content-length", "0") or 0)
                if length > max_body:
                    resp = json_response({"error": "body too large"}, 413)
                    await _write(writer, resp, close=True)
                    return
                body = await reader.readexactly(length) if length else b""
                request = Request(method, target, headers, body)
                response = await app.handle(request)
                keep = headers.get("connection", "keep-alive") != "close"
                await _write(writer, response, close=not keep)
                if not keep:
                    return
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    server = await asyncio.start_server(client, host, port)
    # the bound port: the one the system chose where port is 0
    logger.info("serving on %s:%d", host,
                server.sockets[0].getsockname()[1])
    async with server:
        await server.serve_forever()


async def _write(writer: asyncio.StreamWriter, resp: Response, close: bool):
    reason = REASONS.get(resp.status, "")
    head = [f"HTTP/1.1 {resp.status} {reason}"]
    resp.headers["content-length"] = str(len(resp.body))
    if close:
        resp.headers["connection"] = "close"
    for k, v in resp.headers.items():
        head.append(f"{k}: {v}")
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin1"))
    writer.write(resp.body)
    await writer.drain()

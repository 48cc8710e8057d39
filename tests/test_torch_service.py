"""The port's HTTP service (onnxocr_tpu_torch/service) vs the JAX package's
on the CPU.

* Contract: a FakeModel in both engines, as tests/test_service.py installs
  one; every request of tests/test_service.py and tests/test_engine.py (and
  a few more error paths, hostile uploads among them) goes to both
  TestClients, and the status, the content type and the body agree — JSON
  minus `processing_time` and `timestamp`, zip archives by their members,
  other bodies byte for byte (the v2 preview JPEG included). Uploads on
  which cv2 raises (an image larger than it reads, no bytes) get the JAX
  service's status and JSON structure on each route.
* The engine switches: `_get_model_kwargs` equals the JAX package's for
  every registry model under PIPELINE_MODE, WAVE_BATCH, MICRO_BATCH and
  DET_BATCH / REC_BATCH off (off the TPU the JAX engine serves staged, the
  port's default on every device).
* Real models: a JAX engine and a port engine (device "cpu") with both
  batchers, the untrained-classifier opt-in and the stand-in dictionary
  under an ONNXOCR_TPU_ASSETS root; v1 and v2 requests and 4 concurrent
  ones agree with the JAX service at texts equal, boxes within 2 px and
  confidences within 2e-3. MICRO_BATCH: the JAX engine raises TypeError on
  a page with text (its BatchedForward takes one argument, its recognizer
  passes two), the port's micro-batched engine equals the JAX package's
  unbatched `tpu_fused_cls_rec=False` model. save_crop_res writes the same
  file names as the JAX package, each file cv2.imwrite's bytes of the
  port's crop and decoding to the JAX package's file's values.
"""
import asyncio
import base64
import io
import json
import os
import struct
import threading
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
import torch

from onnxocr_tpu import ONNXPaddleOcr as JaxOcr
from onnxocr_tpu import config as jconfig
from onnxocr_tpu.service import engine as jengine
from onnxocr_tpu.service import routes as jroutes
from onnxocr_tpu.service.http import TestClient as JaxClient
from onnxocr_tpu.service.settings import settings as jsettings

from onnxocr_tpu_torch import ONNXPaddleOcr, config
from onnxocr_tpu_torch.parallel import mesh as port_mesh
from onnxocr_tpu_torch.service import engine, routes
from onnxocr_tpu_torch.service.http import TestClient
from onnxocr_tpu_torch.service.settings import settings
from onnxocr_tpu_torch.utils.png import read_bgr

HELDOUT = config.ASSETS.parent / "test_images_heldout"
# the JAX engine's own _maybe_shard_det, before serving_env patches it off
JAX_SHARD_DET = jengine.EngineManager.__dict__["_maybe_shard_det"]
SIDES = {"jax": (jengine, jroutes, JaxClient, jsettings),
         "port": (engine, routes, TestClient, settings)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Test processes run side by side on the machine's cores: two torch
    threads keep this module from oversubscribing them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ contract
class FakeModel:
    """Stands in for ONNXPaddleOcr: returns two fixed lines."""

    def ocr(self, img, det=True, rec=True, cls=True):
        box = [[10.0, 10.0], [100.0, 10.0], [100.0, 30.0], [10.0, 30.0]]
        return [[[box, ("hello", 0.95)], [box, ("world", 0.55)]]]


@pytest.fixture()
def clients(tmp_path, monkeypatch):
    """{"jax": client, "port": client}, each engine holding a FakeModel
    for every registry model and its own results directory."""
    made = {}
    for side, (eng, rts, client_cls, sets) in SIDES.items():
        monkeypatch.setattr(sets, "RESULTS_DIR", str(tmp_path / side))
        eng.reset_engine_manager()
        em = eng.get_engine_manager()
        for name in eng.MODEL_REGISTRY:
            em._models[name] = FakeModel()
        em._ready = True
        monkeypatch.setattr(eng.EngineManager, "warmup", lambda self: None)
        made[side] = (em, client_cls(rts.build_app()))
    yield made
    for eng, *_ in SIDES.values():
        eng.reset_engine_manager()


def _png(value=200, shape=(40, 60, 3)):
    ok, buf = cv2.imencode(".png", np.full(shape, value, np.uint8))
    assert ok
    return bytes(buf)


def _jpeg():
    rng = np.random.default_rng(0)
    img = cv2.GaussianBlur(rng.integers(0, 255, (48, 64, 3)).astype(
        np.uint8), (5, 5), 0)
    ok, buf = cv2.imencode(".jpg", img)
    return bytes(buf)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _hostile_jpeg():
    """A JPEG whose DC table 0 gives 255 codes of length 1 (refused by
    libjpeg; a decoder that entered it before checking it would write
    64 KB past its lookup table)."""
    jpeg = _jpeg()
    i = jpeg.index(b"\xff\xda")
    return jpeg[:i] + b"\xff\xc4" + struct.pack(">HB", 3 + 16 + 255, 0) + \
        bytes([255] + [0] * 15) + bytes(255) + jpeg[i:]


def _hostile_png(w=1 << 29, h=1, depth=16, ctype=6):
    """A PNG header of a huge image over one inflated byte."""
    return b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, 0)) + _chunk(
        b"IDAT", zlib.compress(b"\0")) + _chunk(b"IEND", b"")


def _file(name, blob, ctype="image/png", field="file"):
    return (field, (name, blob, ctype))


def _ready_false(sides):
    for em, _ in sides.values():
        em._ready = False


def _size_cap(sides):
    for _, _, _, sets in SIDES.values():
        sets.MAX_CONTENT_LENGTH = 10


# name → (method, path, request kwargs, setup(sides) or None, follow-up
# path taken from the JSON's zip_url)
CASES = {
    "v1_png": ("POST", "/ocr", dict(json_body={
        "image": base64.b64encode(_png()).decode()}), None),
    "v1_jpeg": ("POST", "/ocr", dict(json_body={
        "image": base64.b64encode(_jpeg()).decode()}), None),
    "v1_missing_image": ("POST", "/ocr", dict(json_body={}), None),
    "v1_bad_base64": ("POST", "/ocr", dict(json_body={
        "image": "!!!notbase64"}), None),
    "v1_undecodable": ("POST", "/ocr", dict(json_body={
        "image": base64.b64encode(b"not an image at all").decode()}), None),
    "v1_invalid_json": ("POST", "/ocr", dict(body=b"{nope"), None),
    "v2_single_json": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png())], data={"conf_threshold": "0.5"}),
        None),
    "v2_conf_0.9": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png())], data={"conf_threshold": "0.9"}),
        None),
    "v2_text": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png())], data={"output_format": "text"}),
        None),
    "v2_tsv": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png())], data={"output_format": "tsv"}),
        None),
    "v2_hocr": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png())], data={"output_format": "hocr"}),
        None),
    "v2_no_bbox": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.jpg", _jpeg(), "image/jpeg")],
        data={"bbox": "false"}), None),
    "v2_no_files": ("POST", "/api/v2/ocr", dict(
        data={"model_name": "PP-OCRv5"}), None),
    "v2_pdf": ("POST", "/api/v2/ocr", dict(
        files=[_file("doc.pdf", b"%PDF-1.4", "application/pdf")]), None),
    "v2_unsupported_type": ("POST", "/api/v2/ocr", dict(
        files=[_file("x.exe", b"MZ", "application/x-dos")]), None),
    "v2_octet_stream_png_name": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png(), "application/octet-stream")]), None),
    "v2_undecodable": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", b"\x89PNG\r\n\x1a\ntruncated")]), None),
    "v1_hostile_huffman_table": ("POST", "/ocr", dict(json_body={
        "image": base64.b64encode(_hostile_jpeg()).decode()}), None),
    "v2_hostile_png_width": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _hostile_png())]), None),
    "v2_multi_one_hostile": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png(), field="files"),
               _file("b.jpg", _hostile_jpeg(), "image/jpeg",
                     field="files")], data={"output_format": "text"}),
        None),
    "v2_size_cap": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png())]), _size_cap),
    "v2_invalid_model": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png())], data={"model_name": "nope"}), None),
    "v2_invalid_conf": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png())], data={"conf_threshold": "x"}),
        None),
    "v2_invalid_format": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png())], data={"output_format": "xml"}),
        None),
    "v2_model_v4": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png())], data={"model_name": "PP-OCRv4"}),
        None),
    "v2_multi_text_zip": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png(), field="files"),
               _file("b.png", _png(90), field="files")],
        data={"output_format": "text"}), None),
    "v2_multi_json": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png(), field="files"),
               _file("b.png", _png(), field="files")]), None),
    "v2_multi_one_undecodable": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png(), field="files"),
               _file("b.png", b"garbage", field="files")],
        data={"output_format": "text"}), None),
    "v2_return_image": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.png", _png(200, (60, 120, 3)))],
        data={"return_image": "true"}), None),
    "v2_return_image_jpeg": ("POST", "/api/v2/ocr", dict(
        files=[_file("a.jpg", _jpeg(), "image/jpeg")],
        data={"return_image": "1"}), None),
    "health": ("GET", "/health", {}, None),
    "healthz": ("GET", "/api/v2/healthz", {}, None),
    "readyz": ("GET", "/api/v2/readyz", {}, None),
    "readyz_503": ("GET", "/api/v2/readyz", {}, _ready_false),
    "task_404": ("GET", "/api/v2/tasks/nonexistent", {}, None),
    "request_id": ("GET", "/health", dict(
        headers={"X-Request-ID": "abc123"}), None),
    "ui_page": ("GET", "/", {}, None),
    "unknown_route_404": ("GET", "/nope", {}, None),
    "method_405": ("GET", "/ocr", {}, None),
    "download_404": ("GET", "/download/20000101_000000", {}, None),
    "download_bad_400": ("GET", "/download/..", {}, None),
    "static_404": ("GET", "/static/missing.css", {}, None),
}


def _strip(obj):
    """JSON without the run-dependent values: processing_time, timestamp
    and the session timestamp inside zip_url."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in ("processing_time", "timestamp"):
                continue
            if k == "zip_url" and isinstance(v, str):
                v = v.rsplit("/", 1)[0]
            out[k] = _strip(v)
        return out
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _body(resp):
    ctype = resp.headers["content-type"]
    if ctype == "application/json":
        return _strip(resp.json())
    if ctype == "application/zip":
        with zipfile.ZipFile(io.BytesIO(resp.body)) as zf:
            return {n: zf.read(n) for n in sorted(zf.namelist())}
    return resp.body


@pytest.mark.parametrize("case", list(CASES))
def test_http_contract_matches_jax(clients, monkeypatch, case):
    method, path, kw, setup = CASES[case]
    for _, _, _, sets in SIDES.values():
        monkeypatch.setattr(sets, "MAX_CONTENT_LENGTH",
                            sets.MAX_CONTENT_LENGTH)
    if setup is not None:
        setup(clients)
    got = {}
    for side, (_, client) in clients.items():
        resp = client.request(method, path, **kw)
        follow = None
        if resp.headers["content-type"] == "application/json":
            url = resp.json().get("zip_url") if isinstance(
                resp.json(), dict) else None
            if url:
                follow = client.get(url)
        got[side] = (resp, follow)
    for i in range(2):
        want, have = got["jax"][i], got["port"][i]
        if want is None:
            assert have is None
            continue
        assert have.status_code == want.status_code
        assert have.headers["content-type"] == want.headers["content-type"]
        assert set(have.headers) == set(want.headers)
        assert _body(have) == _body(want)
    if case == "request_id":
        assert got["port"][0].headers["x-request-id"] == "abc123"


def _keys(obj):
    """The JSON's structure: dict keys and list lengths, values dropped."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()
                if k not in ("processing_time", "timestamp", "request_id")}
    if isinstance(obj, list):
        return [_keys(v) for v in obj]
    return None


@pytest.mark.parametrize("route", ["v1", "v2", "v2_multi"])
@pytest.mark.parametrize("upload", ["oversized", "empty"])
def test_raising_uploads_answer_as_jax(clients, upload, route):
    """Uploads on which cv2.imdecode raises, as the codec does: a 40000 x
    40000 PNG header (1.6 G pixels; validateInputImageSize) and no bytes
    at all. Each route answers with the JAX service's status, content
    type and JSON structure (cv2's messages are its own): for the
    oversized image v1 400, v2 500 (an unhandled error), a multi-file item
    its error, the codec's message naming cv2's check."""
    blob = b"" if upload == "empty" else _hostile_png(40000, 40000, 8, 2)
    got = {}
    for side, (_, client) in clients.items():
        if route == "v1":
            resp = client.post("/ocr", json_body={
                "image": base64.b64encode(blob).decode()})
        else:
            field = "files" if route == "v2_multi" else "file"
            files = [_file("a.png", blob, field=field)]
            if route == "v2_multi":
                files.append(_file("b.png", _png(), field=field))
            resp = client.post("/api/v2/ocr", files=files)
        got[side] = resp
    want, have = got["jax"], got["port"]
    assert have.status_code == want.status_code
    assert have.headers["content-type"] == want.headers["content-type"]
    assert _keys(have.json()) == _keys(want.json())
    if upload == "oversized":
        errors = [r.json()["items"][0]["error"] if route == "v2_multi"
                  else r.json()["error"] for r in (want, have)]
        assert all("validateInputImageSize" in e for e in errors), errors
        assert want.status_code == {"v1": 400, "v2": 500,
                                    "v2_multi": 200}[route]


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


class CountingModel:
    def __init__(self):
        self.calls = 0

    def ocr(self, img, det=True, rec=True, cls=True):
        self.calls += 1
        box = [[0.0, 0.0], [10.0, 0.0], [10.0, 5.0], [0.0, 5.0]]
        return [[[box, ("high", 0.9)], [box, ("low", 0.3)]]]


def _engine_case_run_ocr(em):
    t, result = _run(em.run_ocr(np.zeros((10, 10, 3), np.uint8)))
    assert t >= 0
    return result


def _engine_case_threshold(em):
    img = np.zeros((10, 10, 3), np.uint8)
    return [_run(em.run_ocr(img, conf_threshold=c))[1]
            for c in (0.5, None, 0.95)]


def _engine_case_cache(em):
    return em.get_model("PP-OCRv5") is em.get_model("PP-OCRv5")


def _engine_case_semaphore(em):
    active, peak = [], []
    lock = threading.Lock()
    orig = em._sync_ocr

    def slow(img, model_name=None, conf_threshold=None):
        with lock:
            active.append(1)
            peak.append(len(active))
        time.sleep(0.05)
        with lock:
            active.pop()
        return orig(img, model_name, conf_threshold)

    em._sync_ocr = slow
    img = np.zeros((4, 4, 3), np.uint8)

    async def fire():
        return await asyncio.gather(*[em.run_ocr(img) for _ in range(6)])

    results = _run(fire())
    assert max(peak) <= em.concurrency
    return [r[1] for r in results]


ENGINE_CASES = {"run_ocr": _engine_case_run_ocr,
                "conf_threshold": _engine_case_threshold,
                "model_cache": _engine_case_cache,
                "semaphore": _engine_case_semaphore}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_contract_matches_jax(case):
    """tests/test_engine.py's engine calls on both engines give the same
    results."""
    got = {}
    for side, (eng, *_rest) in SIDES.items():
        eng.reset_engine_manager()
        em = eng.EngineManager(concurrency=2)
        fake = CountingModel()
        for name in eng.MODEL_REGISTRY:
            em._models[name] = fake
        got[side] = ENGINE_CASES[case](em)
        eng.reset_engine_manager()
    assert got["port"] == got["jax"]


# ------------------------------------------------------ engine switches
SWITCHES = {
    "defaults": {},
    "staged": {"PIPELINE_MODE": "staged"},
    "onecall": {"PIPELINE_MODE": "onecall"},
    "onecall_waves": {"PIPELINE_MODE": "onecall", "WAVE_BATCH": "1"},
    "micro_batch": {"MICRO_BATCH": "1"},
    "batchers_off": {"DET_BATCH": "0", "REC_BATCH": "0"},
    "micro_batch_onecall": {"MICRO_BATCH": "true",
                            "PIPELINE_MODE": "onecall"},
}


@pytest.mark.parametrize("switch", list(SWITCHES))
@pytest.mark.parametrize("model_name", list(engine.MODEL_REGISTRY))
def test_model_kwargs_match_jax(monkeypatch, model_name, switch):
    """The same ONNXPaddleOcr kwargs as the JAX engine off the TPU (whose
    default mode there is staged, the port's on every device); the port's
    engine runs on settings.DEVICE."""
    monkeypatch.setattr(jconfig, "_ASSET_SEARCH_PATHS",
                        ["", str(jconfig._PKG_DIR / "assets")])
    monkeypatch.delenv("ONNXOCR_TPU_ASSETS", raising=False)
    for key in ("PIPELINE_MODE", "WAVE_BATCH", "MICRO_BATCH", "DET_BATCH",
                "REC_BATCH"):
        monkeypatch.delenv(key, raising=False)
    for key, value in SWITCHES[switch].items():
        monkeypatch.setenv(key, value)
    port = engine.EngineManager(concurrency=4)
    ref = jengine.EngineManager(concurrency=4)
    assert port._get_model_kwargs(model_name) == \
        ref._get_model_kwargs(model_name)
    assert port._pipeline_mode == ref._pipeline_mode == \
        SWITCHES[switch].get("PIPELINE_MODE", "staged")
    assert port.device == settings.DEVICE == "cuda"


# --------------------------------------------------------- real models
@pytest.fixture(scope="module")
def assets_root(tmp_path_factory):
    """An ONNXOCR_TPU_ASSETS root holding the stand-in v5 dictionary
    (18383 unique entries; the trained-support sidecar is found by its
    name)."""
    root = tmp_path_factory.mktemp("assets")
    (root / "ppocrv5").mkdir()
    (root / "ppocrv5" / "ppocrv5_dict.txt").write_text(
        "".join(f"<{i}>\n" for i in range(18383)))
    return root


@pytest.fixture(scope="module")
def serving_env(assets_root):
    """The environment of both engines: the asset root (the JAX package
    reads its search path at import, so its list is patched), the
    untrained-classifier opt-in, and the default switches."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ONNXOCR_TPU_ASSETS", str(assets_root))
    mp.setenv("ONNXOCR_TPU_ALLOW_UNTRAINED", "1")
    for key in ("PIPELINE_MODE", "WAVE_BATCH", "MICRO_BATCH", "DET_BATCH",
                "REC_BATCH", "WARMUP_SRC_BUCKETS"):
        mp.delenv(key, raising=False)
    mp.setattr(jconfig, "_ASSET_SEARCH_PATHS",
               [str(assets_root), str(jconfig._PKG_DIR / "assets")])
    # tests/conftest.py gives JAX 8 virtual CPU devices, on which the JAX
    # engine shards its det batch over a mesh; the cases here serve one
    # device on both sides (the port's CPU engine does not shard), and
    # test_sharded_engines_match lets both shard
    mp.setattr(jengine.EngineManager, "_maybe_shard_det",
               staticmethod(lambda model: None))
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def served(serving_env, tmp_path_factory):
    """{"jax": client, "port": client} over real engines (both batchers on,
    the untrained classifier), warmed up; the port's on the CPU."""
    out = {}
    serving_env.setattr(jsettings, "RESULTS_DIR",
                        str(tmp_path_factory.mktemp("jax_results")))
    serving_env.setattr(settings, "RESULTS_DIR",
                        str(tmp_path_factory.mktemp("port_results")))
    managers = {"jax": jengine.EngineManager(concurrency=4),
                "port": engine.EngineManager(concurrency=4, device="cpu")}
    for side, (eng, rts, client_cls, _) in SIDES.items():
        serving_env.setattr(eng, "_engine_manager", managers[side])
        out[side] = client_cls(rts.build_app())
        assert managers[side].ready
    assert managers["port"].warmup_error is None
    yield out
    managers["port"].close()
    for eng, *_ in SIDES.values():
        eng.reset_engine_manager()


def _page_png(name):
    ok, buf = cv2.imencode(".png", read_bgr(str(HELDOUT / f"{name}.png")))
    return bytes(buf)


def _page_jpeg(name):
    ok, buf = cv2.imencode(".jpg", read_bgr(str(HELDOUT / f"{name}.png")))
    return bytes(buf)


def _assert_close(got, want):
    assert [r["text"] for r in got] == [r["text"] for r in want]
    assert len(got) > 4
    for g, w in zip(got, want):
        assert np.abs(np.asarray(g["bounding_box"], np.float64) -
                      np.asarray(w["bounding_box"], np.float64)).max() <= 2.0
        assert abs(g["confidence"] - w["confidence"]) < 2e-3


def test_served_pages_match_jax(served):
    """v1 on synth_00_doc as PNG, v2 json on synth_08_table as a
    cv2-written JPEG, then 4 concurrent v1 requests on each side."""
    v1 = {"image": base64.b64encode(_page_png("synth_00_doc")).decode()}
    v2 = dict(files=[("file", ("t.jpg", _page_jpeg("synth_08_table"),
                               "image/jpeg"))],
              data={"conf_threshold": "0.5"})
    got = {side: (c.post("/ocr", json_body=v1),
                  c.post("/api/v2/ocr", **v2)) for side, c in served.items()}
    for i in range(2):
        want, have = got["jax"][i], got["port"][i]
        assert have.status_code == want.status_code == 200
        _assert_close(have.json()["results"], want.json()["results"])
    pages = ["synth_00_doc", "synth_03_doc", "synth_07_table",
             "synth_08_table"]
    bodies = [json.dumps({"image": base64.b64encode(_page_png(n)).decode()}
                         ).encode() for n in pages]
    burst = {}
    for side, client in served.items():
        request = jroutes.Request if side == "jax" else routes.Request

        async def gather(app=client.app, request=request):
            return await asyncio.gather(*[app.handle(request(
                "POST", "/ocr", {"content-type": "application/json"}, body))
                for body in bodies])

        burst[side] = client._loop.run_until_complete(gather())
    for have, want in zip(burst["port"], burst["jax"]):
        assert have.status_code == want.status_code == 200
        _assert_close(have.json()["results"], want.json()["results"])


def test_sharded_engines_match(serving_env, monkeypatch):
    """Both engines shard the det page batch (DET_BATCH on by default): the
    JAX engine's own _maybe_shard_det over conftest's 8 virtual CPU
    devices, the port's over a 4 × 1 'cpu' grid through its mesh factory.
    On either side the mesh turns the bitmap wire into the maps wave, so
    the staged route takes the map route's det step; 8 concurrent
    requests agree (texts equal, boxes within 2 px, confidences within
    2e-3)."""
    monkeypatch.setattr(jengine.EngineManager, "_maybe_shard_det",
                        JAX_SHARD_DET)
    monkeypatch.setattr(
        engine.EngineManager, "_det_mesh",
        lambda self: port_mesh.make_mesh(4, devices=["cpu"] * 4))
    jem = jengine.EngineManager(concurrency=4)
    pem = engine.EngineManager(concurrency=4, device="cpu")
    try:
        jpb = jem.get_model().text_detector._page_batcher
        assert jpb.wire == "maps" and jpb.batcher.batch_ladder == (8,)
        model = pem.get_model()
        pb = model.text_detector._page_batcher
        assert pb.mode == "maps" and pb.mesh.shape == {"data": 4,
                                                       "model": 1}
        assert pb.batcher.batch_ladder == (4, 8) and model.route == "map"
        names = ["synth_00_doc", "synth_03_doc", "synth_07_table",
                 "synth_08_table"] * 2
        pages = [read_bgr(str(HELDOUT / f"{n}.png")) for n in names]
        got = {}
        for side, em in (("jax", jem), ("port", pem)):
            with ThreadPoolExecutor(8) as pool:
                got[side] = list(pool.map(lambda p, em=em: em._sync_ocr(p),
                                          pages))
        for (_, have), (_, want) in zip(got["port"], got["jax"]):
            _assert_close(routes._format_results(have),
                          jroutes._format_results(want))
    finally:
        pem.close()


@pytest.fixture(scope="module")
def page():
    return read_bgr(str(HELDOUT / "synth_00_doc.png"))


def test_micro_batch_matches_jax_unbatched(serving_env, page, monkeypatch):
    """MICRO_BATCH=1: the JAX engine's BatchedForward takes one argument
    while its recognizer passes two (crops and token counts), so its
    model raises TypeError on a page with text — a fault on the reference
    side, recorded, not ported. The port's BatchedForward batches every
    positional argument; its engine equals the JAX package's unbatched
    `tpu_fused_cls_rec=False` model."""
    monkeypatch.setenv("MICRO_BATCH", "1")
    jem = jengine.EngineManager(concurrency=4)
    with pytest.raises(TypeError):
        jem._sync_ocr(page)
    pem = engine.EngineManager(concurrency=4, device="cpu")
    try:
        model = pem.get_model()
        assert type(model.text_recognizer.forward).__name__ == \
            "BatchedForward" and model.route == "map"
        with ThreadPoolExecutor(2) as pool:
            got = [f.result() for f in [pool.submit(pem._sync_ocr, page)
                                        for _ in range(2)]]
        kw = jem._get_model_kwargs("PP-OCRv5")
        kw.pop("tpu_det_microbatch")
        kw.pop("tpu_rec_microbatch")
        want = JaxOcr(**kw).ocr(page)
        for _, res in got:
            _assert_close(routes._format_results(res),
                          jroutes._format_results(want))
    finally:
        pem.close()


def test_save_crop_res_matches_jax(serving_env, page, tmp_path):
    """save_crop_res: the same mg_crop_<n>.jpg names as the JAX package
    (n counting on across calls), each crop within the codec test's
    tolerance of the JAX package's cv2.imwrite of its own crop."""
    kw = dict(save_crop_res=True, rec_char_dict_path=config.find_asset(
                  "ppocrv5/ppocrv5_dict.txt"))
    port = ONNXPaddleOcr(device="cpu", crop_res_save_dir=str(tmp_path / "p"),
                         **kw)
    ref = JaxOcr(crop_res_save_dir=str(tmp_path / "j"), **kw)
    written = []
    draw = port.draw_crop_rec_res
    port.draw_crop_rec_res = lambda d, crops, res: written.extend(crops) \
        or draw(d, crops, res)
    crop = page[:240]
    for _ in range(2):
        got, want = port.ocr(crop), ref.ocr(crop)
        _assert_close(routes._format_results(got),
                      jroutes._format_results(want))
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == names and len(names) > 4
    assert len(written) == len(names)
    diff, n_values = [], 0
    for i, crop_i in enumerate(written):
        blob = (tmp_path / "p" / f"mg_crop_{i}.jpg").read_bytes()
        # the writer's bytes are cv2.imwrite's of the same crop
        ok, buf = cv2.imencode(".jpg", crop_i, [cv2.IMWRITE_JPEG_QUALITY, 95])
        assert blob == bytes(buf)
        a = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
        b = cv2.imread(str(tmp_path / "j" / f"mg_crop_{i}.jpg"))
        assert a.shape == b.shape
        diff.append(np.abs(a.astype(int) - b.astype(int)))
        n_values += a.size
    diff = np.concatenate([d.ravel() for d in diff])
    print(f"save_crop_res: {int((diff > 0).sum())} of {n_values} decoded "
          f"values differ, by at most {int(diff.max())}")
    # the host crops equal the JAX package's cv2 crops on this page, and
    # the writer's bytes are cv2.imwrite's: the files decode alike
    assert diff.max() == 0

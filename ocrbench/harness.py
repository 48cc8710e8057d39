"""The system under test and the measured window.

`build(cell, device, extra)` builds the port's serving engine
(onnxocr_tpu_torch/service/engine.EngineManager at its default mode: the
staged bitmap wire behind the det page batcher and the rec crop batcher)
for the cell's configuration, with the settings the configuration and the
traffic fix (the engine's registry gives the model directories; the
benchmark gives the dictionary stand-in, the det sizing and the classifier
switch). `Probe` wraps a few of the model's calls: always to keep the det
maps of the requests the check samples, and in a traced run to count the
work of each layer and time its host spans. `closed_loop` drives a window:
`in_flight` requests outstanding, each answered before its slot sends
the next, pages decoded by the port's codec and answered by
`EngineManager.run_ocr`, line requests by the model's
`ocr(lines, det=False, cls=False)`."""
from __future__ import annotations

import asyncio
import concurrent.futures
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .spec import ROOT

WORK = os.path.join(ROOT, "build", "ocrbench")


def standin_dict(name: str, lines: int) -> str:
    """A dictionary of `lines` placeholder entries "<i>", under the
    checkpoint's dictionary name (the name its trained-support sidecar is
    found by): the texts are placeholders, the work is the same."""
    path = os.path.join(WORK, "dicts", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    body = "".join(f"<{i}>\n" for i in range(lines))
    if not os.path.exists(path) or open(path).read() != body:
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(body)
        os.replace(tmp, path)
    return path


def build(cell, device: str, extra: Optional[dict] = None):
    """→ (engine, model, model name). The engine keeps its own
    concurrency (MODEL_CONCURRENCY, by default as many requests inside the
    pipeline as the host has cores, at most 8); the rest of the loop's
    requests wait at its gate, as a batch job's queue does."""
    from onnxocr_tpu_torch.service.engine import EngineManager

    overrides = dict(cell.config["program"])
    overrides.update(cell.traffic.get("program", {}))
    rec = cell.config["rec"]
    overrides["rec_char_dict_path"] = standin_dict(rec["dict_name"],
                                                   rec["dict_lines"])
    overrides.update(extra or {})

    class BenchEngine(EngineManager):
        def _get_model_kwargs(self, model_name):
            kwargs = super()._get_model_kwargs(model_name)
            kwargs.update(overrides)
            return kwargs

    engine = BenchEngine(device=device)
    name = cell.config["engine_model"]
    return engine, engine.get_model(name), name


@dataclass
class Counts:
    """What a traced window counted, on the host's wall clock (ns)."""
    det_waves: List[tuple] = field(default_factory=list)
    rec_calls: List[tuple] = field(default_factory=list)
    ctc_launches: List[tuple] = field(default_factory=list)
    spans: Dict[str, List[tuple]] = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock)

    def span(self, name: str, a: int, b: int):
        with self.lock:
            self.spans.setdefault(name, []).append((a, b))


class Probe:
    """Wrappers on the model's calls. `sample` holds the request numbers
    whose det map is kept (`maps[i] = (map on the device, (rh, rw))`);
    `counting` turns the layer counters on."""

    def __init__(self, model, sample=()):
        self.model = model
        self.sample = set(sample)
        self.maps: Dict[int, tuple] = {}
        self.request_of: Dict[int, int] = {}
        self.counts: Optional[Counts] = None
        self._tl = threading.local()
        self._restore = []
        self._wrap_ocr()
        det_b = model.text_detector._page_batcher
        if det_b is not None:
            self._wrap_det(det_b)

    def _patch(self, obj, name, fn):
        had = name in vars(obj)
        old = vars(obj).get(name)
        setattr(obj, name, fn)
        self._restore.append((obj, name, had, old))

    def close(self):
        for obj, name, had, old in reversed(self._restore):
            if had:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self._restore.clear()

    def _wrap_ocr(self):
        orig = self.model.ocr

        def ocr(img, *a, **kw):
            self._tl.req = self.request_of.get(id(img))
            return orig(img, *a, **kw)

        self._patch(self.model, "ocr", ocr)

    def _keep(self, prob, rh, rw):
        req = getattr(self._tl, "req", None)
        if req is not None and req in self.sample:
            self.maps[req] = (prob.clone(), (int(rh), int(rw)))

    def _wrap_det(self, det_b):
        for name in ("submit_bits_dev", "submit_bits"):
            orig = getattr(det_b, name)

            def call(*a, _orig=orig, **kw):
                bitmap, prob, (rh, rw), info = _orig(*a, **kw)
                self._keep(prob, rh, rw)
                return bitmap, prob, (rh, rw), info

            self._patch(det_b, name, call)

    def count(self):
        """Turn the layer counters on (a traced run)."""
        self.counts = c = Counts()
        m = self.model
        det_b = m.text_detector._page_batcher
        if det_b is not None:
            fn = det_b.batcher.fn

            def wave(batch, _fn=fn):
                a = time.time_ns()
                out = _fn(batch)
                b = time.time_ns()
                rhw = np.asarray(batch["rhw"])
                c.det_waves.append((a, b, rhw[rhw[:, 0] > 0].tolist(),
                                    len(rhw)))
                c.span("det wave call (host side)", a, b)
                return out

            self._patch(det_b.batcher, "fn", wave)
        if m._fused is not None:
            for name in ("call_multi_scored", "call_multi", "call_scored"):
                orig = getattr(m._fused, name)

                def rec(*args, _orig=orig, _name=name, **kw):
                    a = time.time_ns()
                    out = _orig(*args, **kw)
                    b = time.time_ns()
                    # (…, rec_valid, out_h, out_w): the host arrays
                    valid = np.asarray(args[-3]).reshape(-1)
                    c.rec_calls.append((a, b, valid[valid > 0].tolist(),
                                        len(valid), int(args[-1])))
                    c.span("rec group call (host side)", a, b)
                    return out

                self._patch(m._fused, name, rec)
        recog = m.text_recognizer
        orig_chunk = recog._decode_chunk

        def chunk(crops, valid_ws, n_real, _orig=orig_chunk):
            a = time.time_ns()
            out = _orig(crops, valid_ws, n_real)
            b = time.time_ns()
            v = np.asarray(valid_ws).reshape(-1)
            c.rec_calls.append((a, b, v[:n_real].tolist(), len(v),
                                int(crops.shape[2])))
            c.span("rec call (host side)", a, b)
            return out

        self._patch(recog, "_decode_chunk", chunk)
        from onnxocr_tpu_torch.ops.kernels import ctc_head
        orig_head = ctc_head.ctc_head_reduce_batched

        def head(feats, w_split, b, _orig=orig_head):
            n, t, d = feats.shape
            c.ctc_launches.append((time.time_ns(), n * t, d,
                                   w_split.shape[1]))
            return _orig(feats, w_split, b)

        self._patch(ctc_head, "ctc_head_reduce_batched", head)


@dataclass
class Answer:
    index: int
    t_sent: float
    t_done: float
    result: object = None
    error: Optional[str] = None


@dataclass
class Window:
    """The measured span of a closed loop (perf_counter seconds; `t0_ns`
    on time.time_ns) and the number of its first request."""
    t0: float = 0.0
    t_end: float = 0.0
    t0_ns: int = 0
    first: int = 0


async def closed_loop(engine, model, model_name, traffic, kind: str,
                      in_flight: int, *, seconds: float, warm: bool = True,
                      probe=None, on_window=None,
                      decode_threads: int = 8):
    """Keep `in_flight` requests outstanding, numbered from 0 and cycling
    through the traffic's pool. With `warm`, the window opens once every
    request of the pool has been answered, so that no shape the traffic
    takes meets its first use inside the window and the window starts from
    the loop's steady state; it lasts `seconds`; then no request is sent
    but the kept ones a window too short for the depth did not reach (an
    answer after the close counts for no rate, and is judged all the
    same), and those outstanding are answered. on_window(first request
    number) runs as the window opens and gives the request numbers whose
    answers are kept. → (answers, Window)."""
    from onnxocr_tpu_torch.utils import imcodec
    loop = asyncio.get_running_loop()
    decode_pool = concurrent.futures.ThreadPoolExecutor(decode_threads)
    pool = traffic.payloads
    answers: List[Answer] = []
    next_index = [0]
    win = Window()
    keep = set()
    unanswered = set(range(len(pool)))
    opened = asyncio.Event()

    def open_window():
        win.t0, win.t0_ns = time.perf_counter(), time.time_ns()
        win.t_end = win.t0 + seconds
        win.first = next_index[0]
        if on_window is not None:
            keep.update(on_window(win.first))
        opened.set()

    def ocr_lines(lines):
        with torch.inference_mode():
            return model.ocr(lines, det=False, cls=False)

    async def slot():
        while True:
            if opened.is_set() and time.perf_counter() >= win.t_end \
                    and next_index[0] > max(keep, default=-1):
                return
            i = next_index[0]
            next_index[0] += 1
            ans = Answer(i, time.perf_counter(), 0.0)
            try:
                if kind == "pages":
                    a = time.time_ns()
                    img = await loop.run_in_executor(
                        decode_pool, imcodec.imdecode, pool[i % len(pool)])
                    b = time.time_ns()
                    if probe is not None:
                        if probe.counts is not None:
                            probe.counts.span("page decode", a, b)
                        probe.request_of[id(img)] = i
                    _, res = await engine.run_ocr(img, model_name)
                    if probe is not None:
                        probe.request_of.pop(id(img), None)
                else:
                    res = await loop.run_in_executor(
                        None, ocr_lines, pool[i % len(pool)])
                if i in keep:
                    ans.result = res
            except Exception as e:  # counted as failed, the run goes on
                ans.error = f"{type(e).__name__}: {e}"
            ans.t_done = time.perf_counter()
            answers.append(ans)
            unanswered.discard(i % len(pool))
            if not opened.is_set() and not unanswered:
                open_window()

    try:
        if not warm:
            open_window()
        await asyncio.gather(*[slot() for _ in range(in_flight)])
    finally:
        decode_pool.shutdown(wait=True)
    return answers, win

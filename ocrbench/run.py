"""Run one cell of the benchmark once, on the machine it starts on.

    python3 -m ocrbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (from the process's start to the window's): the cell's traffic
made from the seed, the port's serving engine built for the cell's
configuration, its warm-up, and the closed loop (harness.closed_loop)
answering the traffic's pool once, so that every shape the window meets
was met before and the window opens on the loop's steady state. The
window: the next `seconds` of that loop. With --trace 1 the window runs under the
device trace and the layer counters, and the result holds the cell's
per-layer metrics instead of its end-to-end ones. After the window the
program's state is freed and the reference judges the sampled answers
(check.py). The last line of standard output is the result, as JSON; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.

It exits with 3, and prints no result, without CUDA or with fewer cards
than the cell asks for, and with 4 when the JAX package was loaded."""
from __future__ import annotations

import os
import time

T_START = time.perf_counter()

# one process drives the card with a thread a request in flight: the
# numerical libraries' own thread pools would only contend with them
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import asyncio  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

import numpy as np  # noqa: E402

from . import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "onnxocr_tpu")


def note(msg: str):
    print(f"[ocrbench {time.perf_counter() - T_START:7.2f}s] {msg}",
          file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_note() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def prepare_process():
    """Fixed cache directories inside the checkout, TF32 off (both
    configurations are float32; kernel 1 takes its own 3×TF32 path)."""
    work = os.path.join(spec.ROOT, "build", "ocrbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(work, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(work, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sample_of(cell, seed: int):
    """The sampled requests' places after the window's first, drawn from
    the seed among its first `in_flight` (at 1 page/s the window sends
    them within its first 32 s; a window too short for them sends them
    after its close, harness.closed_loop, and every one is answered)."""
    chk = cell.traffic["check"]
    slots = int(cell.traffic["load"]["in_flight"])
    rng = np.random.default_rng([seed, 7])
    return sorted(int(i) for i in rng.choice(
        min(chk["from_first"], slots), size=chk["requests"], replace=False))


class Session:
    """One built engine for a cell, reusable across runs of one process
    (the control script's seeds); `extra` overrides model settings."""

    def __init__(self, cell, extra: Optional[dict] = None,
                 device: str = "cuda"):
        from . import harness
        self.cell = cell
        self.device = device
        self.kind = cell.traffic["kind"]
        self.in_flight = int(cell.traffic["load"]["in_flight"])
        if self.kind == "pages":
            pg = cell.traffic["page"]
            os.environ["WARMUP_SRC_BUCKETS"] = f"{pg['height']}x{pg['width']}"
        self.engine, self.model, self.name = harness.build(cell, device,
                                                           extra)
        self.warm = False

    def warm_up(self, traffic):
        """Once a session: the engine's own warm-up (readiness on a blank
        page, the canonical multi-page rec shapes of the traffic's source
        bucket) and every rung of the det wave ladder at the traffic's det
        size. The window's loop then answers the pool once before the
        window opens."""
        if not self.warm:
            self.engine.warmup()
            if not self.engine.ready:
                raise RuntimeError(f"warm-up failed: "
                                   f"{self.engine.warmup_error!r}")
            self._warm_ladder(traffic)
            self.warm = True

    def _warm_ladder(self, traffic):
        import torch
        det_b = self.model.text_detector._page_batcher
        if det_b is None or self.kind != "pages":
            return
        from .reference.ocr import det_target, round_up
        h, w = traffic.images[0].shape[:2]
        rh, rw = det_target(h, w, det_b.limit_side_len)
        if det_b.canvas is not None:
            ch, cw = det_b.canvas
            make = lambda n: torch.zeros((n, ch, cw, 3),  # noqa: E731
                                         device=self.device)
        else:
            ch, cw = round_up(rh, det_b.bucket), round_up(rw, det_b.bucket)
            make = lambda n: np.zeros((n, ch, cw, 3), np.uint8)  # noqa
        with torch.inference_mode():
            for n in det_b.batcher.batch_ladder:
                det_b.batcher.fn({"pages": make(n), "rhw": np.tile(
                    np.array([[rh, rw]], np.int32), (n, 1))})
        if self.device == "cuda":
            torch.cuda.synchronize()

    async def _loop(self, fn, traffic, **kw):
        import concurrent.futures
        loop = asyncio.get_running_loop()
        ex = concurrent.futures.ThreadPoolExecutor(self.in_flight)
        loop.set_default_executor(ex)
        # the engine's gate binds to the event loop it first blocks in; a
        # session runs one loop a window
        self.engine._semaphore = asyncio.Semaphore(self.engine.concurrency)
        try:
            return await fn(self.engine, self.model, self.name, traffic,
                            self.kind, self.in_flight, **kw)
        finally:
            ex.shutdown(wait=True)

    def window(self, traffic, seconds: float, offsets, trace: bool,
               warm: bool = True):
        """→ (answers, harness.Window, probe, Trace or None). The requests
        `offsets` after the window's first are the sampled ones; `warm`
        as harness.closed_loop's."""
        import torch
        from . import harness
        from .trace import Trace
        from onnxocr_tpu_torch.utils import profiling
        probe = harness.Probe(self.model)
        tr = [None]
        if trace:
            probe.count()

        def on_window(first):
            ids = {first + k for k in offsets}
            probe.sample.update(ids)
            if trace:
                profiling.GLOBAL.reset()
                profiling.GLOBAL.enabled = True
                tr[0] = Trace().__enter__()
            return ids

        try:
            answers, win = asyncio.run(self._loop(
                harness.closed_loop, traffic, seconds=seconds, probe=probe,
                on_window=on_window, warm=warm))
        finally:
            if tr[0] is not None:
                tr[0].__exit__(None, None, None)
            profiling.GLOBAL.enabled = False
            if self.device == "cuda":
                torch.cuda.synchronize()
        return answers, win, probe, tr[0]

    def close(self):
        self.engine.close()


def layer_numbers(cell, traffic, answers, win, seconds, probe, tr,
                  kind_name: str):
    from onnxocr_tpu_torch.utils import profiling
    from .metrics import Run
    t1_ns = win.t0_ns + int(seconds * 1e9)
    c = probe.counts
    summary = tr.summary(win.t0_ns, t1_ns, c.spans)
    ok = [a for a in answers if a.error is None and a.t_done >= win.t0]
    run = Run(cell=cell, seconds=seconds, kind=kind_name,
              answered=[a for a in ok if a.t_done <= win.t_end],
              answered_all=ok,
              requests_lines=_request_lines(cell, traffic),
              stages=profiling.GLOBAL.summary(), counts=c, trace=tr,
              t0_ns=win.t0_ns, t1_ns=t1_ns, busy_s=summary["busy_s"])
    values = {}
    for m in cell.per_layer:
        v = spec.reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return values, summary


def _request_lines(cell, traffic):
    if traffic.kind == "lines":
        return [len(r) for r in traffic.payloads]
    return None


def answered_in(answers, win):
    """The requests answered, without failing, within the window."""
    return [a for a in answers
            if a.error is None and win.t0 <= a.t_done <= win.t_end]


def end_to_end(cell, answers, win, seconds: float, setup_s: float,
               pool) -> dict:
    """The cell's end-to-end metrics: the work answered within the window
    over the whole window, and the set-up's seconds."""
    done = answered_in(answers, win)
    values = {"setup_s": lambda: setup_s,
              "pages_per_s": lambda: len(done) / seconds,
              "lines_per_s": lambda: sum(len(pool[a.index % len(pool)])
                                         for a in done) / seconds}
    return {m["name"]: {"value": values[m["name"]](), "unit": m["unit"]}
            for m in cell.end_to_end}


def run_once(cell, seed: int, seconds: float, trace: bool,
             session: Optional[Session] = None, judge: bool = True,
             device: str = "cuda", warm: bool = True):
    """One run → (result dict, the compared numbers, the end-to-end
    metrics, which a traced result leaves out). `device` 'cpu' is for the
    tests: no trace, no memory reading. warm=False opens the window at
    once (readings of `correct` alone, ocrbench/control.py)."""
    import torch
    from . import check
    from .gen import traffic as gen
    cuda = device == "cuda"
    kind_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    traffic = gen.make(cell.traffic, seed)
    note(f"traffic made in {traffic.make_s:.2f} s "
         f"({len(traffic.payloads)} requests in the pool)")
    own = session is None
    if own:
        session = Session(cell, device=device)
    note("engine built")
    session.warm_up(traffic)
    note("engine warmed up; the pool's pass and the window follow")
    offsets = sample_of(cell, seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    answers, win, probe, tr = session.window(traffic, seconds, offsets,
                                             trace, warm)
    setup_s = win.t0 - T_START
    note(f"window opened at {setup_s:.2f} s")
    done = answered_in(answers, win)
    failed = [a for a in answers if a.error is not None]
    for a in failed[:3]:
        note(f"request {a.index} failed: {a.error}")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    card = {"platform": "gpu", "kind": kind_name,
            "count": int(cell.workload["chips"]),
            "memory_peak_bytes": peak}
    e2e = end_to_end(cell, answers, win, seconds, setup_s, traffic.payloads)
    metrics, breakdown = e2e, None
    if trace:
        metrics, summary = layer_numbers(cell, traffic, answers, win,
                                         seconds, probe, tr, kind_name)
        card["busy_s"] = summary["busy_s"]
        card["window_s"] = summary["window_s"]
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
    maps, probe_sample = probe.maps, set(probe.sample)
    probe.close()
    numbers = {}
    if judge:
        if own:
            session.close()
            del session
        del probe
        check.free_cuda()
        t_ref = time.perf_counter()
        if cell.traffic["kind"] == "pages":
            numbers = check.judge_pages(cell, traffic, answers, maps,
                                        sorted(probe_sample), device)
        else:
            numbers = check.judge_lines(cell, traffic, answers,
                                        sorted(probe_sample), device)
        note(f"reference took {time.perf_counter() - t_ref:.2f} s")
    ok, rows = check.verdict(numbers, cell.limits)
    result = {"correct": bool(ok and not failed and done),
              "attempted": sum(a.index >= win.first and a.t_sent < win.t_end
                               for a in answers),
              "failed": len(failed),
              "metrics": metrics, "device": card}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked"] = {n: {"value": v, "limit": lim}
                         for n, v, lim in rows}
    return result, numbers, e2e


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    import torch
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ocrbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    prepare_process()
    note(f"card: {card_note()}")
    # the port prints a notice on each page it reads without the angle
    # classifier; the result line has to be standard output's last
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        result, _, _ = run_once(cell, args.seed, args.seconds,
                                bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"ocrbench: loaded {bad}, which the benchmark may not load",
              file=sys.stderr)
        return 4
    for name, c in result["checked"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

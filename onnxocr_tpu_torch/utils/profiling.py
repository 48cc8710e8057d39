"""Per-stage timing, program capture and device traces. Counterpart of
onnxocr_tpu/utils/profiling.py.

* StageTimer — per-stage host wall-clock aggregation, enabled by
  ONNXOCR_TPU_PROFILE=1 at import or by `.enabled`, queryable as a dict.
  `GLOBAL` is the one the pipeline's stages hook into ("img_upload",
  "det", "cls_rec_fused", "onecall", "cls", "rec", opened where the JAX
  package's pipeline/system.py opens them, route by route).
* ProgramCapture — the last (callable, arguments) of each named device
  program ("det_bits", "fused_scored", "onecall", "det_pages_b<B>", the
  rec batcher's "rec_multi…" groups), replayed back to back to measure
  what the device does per call. `CAPTURE` is the process-wide one.
* trace(log_dir) — a torch.profiler trace (CPU and, where there is one,
  CUDA activity) around a block, written as a chrome trace to log_dir.

Disabled, a stage hook costs one attribute check and a capture hook holds
no tensor.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

_OFF = contextlib.nullcontext()


class StageTimer:
    """Thread-safe accumulator of stage wall times (host clock)."""

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("ONNXOCR_TPU_PROFILE", "") in (
                "1", "true")
        self.enabled = enabled
        self._lock = threading.Lock()
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    def stage(self, name: str):
        """A context manager that adds the block's wall time to `name`;
        a shared no-op one while disabled."""
        if not self.enabled:
            return _OFF
        return self._timed(name)

    @contextlib.contextmanager
    def _timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._total[name] += dt
                self._count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "total_ms": round(self._total[name] * 1000, 2),
                    "count": self._count[name],
                    "mean_ms": round(
                        self._total[name] / max(self._count[name], 1) * 1000,
                        2),
                }
                for name in self._total
            }

    def reset(self):
        with self._lock:
            self._total.clear()
            self._count.clear()


# process-wide default timer (pipeline stages hook into this)
GLOBAL = StageTimer()


def _first_device(tree):
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for t in tree:
            dev = _first_device(t)
            if dev is not None:
                return dev
    return None


def _resident(tree, device):
    """numpy arrays of the tree → tensors on `device`; the rest as is."""
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree).to(device)
    if isinstance(tree, dict):
        return {k: _resident(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_resident(t, device) for t in tree)
    return tree


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ProgramCapture:
    """The last (callable, example arguments) per named device program, so
    that a benchmark can measure device-busy time: replay the programs back
    to back on device-resident arguments and divide."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._calls: Dict[str, tuple] = {}

    def record(self, name: str, fn, args: tuple):
        if not self.enabled:
            return
        with self._lock:
            self._calls[name] = (fn, args)

    def names(self):
        with self._lock:
            return sorted(self._calls)

    def _entry(self, name: str):
        with self._lock:
            entry = self._calls.get(name)
        if entry is None:
            return None, None, None
        fn, args = entry
        device = _first_device(args) or torch.device(
            "cuda" if torch.cuda.is_available() else "cpu")
        return fn, _resident(args, device), device

    def replay_ms(self, name: str, n: int = 5) -> Optional[float]:
        """Mean ms a call of n back-to-back runs of the captured program on
        device-resident arguments (numpy arguments are uploaded once,
        first), after one warm run; the device is synchronised once, at the
        end. None when nothing was captured under `name`."""
        fn, args, device = self._entry(name)
        if fn is None:
            return None
        with torch.inference_mode():
            fn(*args)
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(n):
                fn(*args)
            _sync(device)
        return (time.perf_counter() - t0) / n * 1000.0

    def flops(self, name: str) -> Optional[float]:
        """The FLOPs of one call of the captured program, counted by
        torch.utils.flop_counter.FlopCounterMode: the matmuls and
        convolutions that run as PyTorch operators (2 per multiply-add),
        and nothing else — no elementwise work, and no hand-written kernel
        (the CTC head's product is not counted). XLA's cost analysis, the
        JAX package's count, counts every op. None when nothing was
        captured under `name` or nothing was counted."""
        from torch.utils.flop_counter import FlopCounterMode
        fn, args, _ = self._entry(name)
        if fn is None:
            return None
        with torch.inference_mode(), FlopCounterMode(display=False) as fc:
            fn(*args)
        return float(fc.get_total_flops()) or None


CAPTURE = ProgramCapture()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A torch.profiler trace (CPU activity, and CUDA's where CUDA is
    available) around a block, written to `log_dir`/trace.json (default:
    onnxocr_tpu_trace under the temporary directory) as a chrome trace."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "onnxocr_tpu_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

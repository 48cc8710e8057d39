"""The device trace of a `--trace 1` window: torch.profiler with CUDA
activity alone (CUPTI; no host operators are recorded, so the program's
host work is not slowed), read back as the device's operations (kernels,
copies, sets) with their names and times on the host's wall clock
(`time.time_ns`, the clock the benchmark's own spans use).

`Trace.summary(spans)` merges the operations into busy intervals and gives
the busy seconds, the operations that took most time by name, and the idle
gaps, each named by the host span that overlapped it most."""
from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import numpy as np
import torch

TOP = 10


class Trace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.ops: List[Tuple[str, int, int]] = []   # (name, start, end) ns

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        cuda = torch.autograd.DeviceType.CUDA
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() == cuda and ev.duration_ns() > 0:
                self.ops.append((ev.name(), ev.start_ns(), ev.end_ns()))
        return False

    def in_window(self, t0_ns: int, t1_ns: int):
        """The operations clipped to [t0, t1]."""
        out = []
        for name, a, b in self.ops:
            a, b = max(a, t0_ns), min(b, t1_ns)
            if b > a:
                out.append((name, a, b))
        return out

    def device_seconds(self, t0_ns: int, t1_ns: int, part: str) -> float:
        """Summed time of the operations whose name holds `part` (a
        kernel's name may come mangled or with its signature)."""
        return sum(b - a for n, a, b in self.in_window(t0_ns, t1_ns)
                   if part in n) / 1e9

    def summary(self, t0_ns: int, t1_ns: int,
                spans: Dict[str, List[Tuple[int, int]]]) -> dict:
        ops = self.in_window(t0_ns, t1_ns)
        by_name: Dict[str, float] = collections.defaultdict(float)
        for name, a, b in ops:
            by_name[name[:96]] += (b - a) / 1e9
        busy = _merge([(a, b) for _, a, b in ops])
        busy_ns = sum(b - a for a, b in busy)
        gaps = _gaps(busy, t0_ns, t1_ns)
        merged = {k: _merge(v) for k, v in spans.items() if v}
        by_gap: Dict[str, float] = collections.defaultdict(float)
        for a, b in gaps:
            best, best_ns = "no span of the benchmark open", 0
            for k, iv in merged.items():
                ov = _overlap(iv, a, b)
                if ov > best_ns:
                    best, best_ns = k, ov
            by_gap[best] += (b - a) / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:TOP]
        return {"busy_s": busy_ns / 1e9,
                "window_s": (t1_ns - t0_ns) / 1e9,
                "device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in idle]}


def _merge(iv):
    if not iv:
        return []
    iv = sorted(iv)
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _gaps(busy, t0, t1):
    out, cur = [], t0
    for a, b in busy:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        out.append((cur, t1))
    return out


def _overlap(merged, a, b) -> int:
    if not merged:
        return 0
    starts = np.array([x for x, _ in merged])
    ends = np.array([y for _, y in merged])
    return int(np.clip(np.minimum(ends, b) - np.maximum(starts, a), 0,
                       None).sum())

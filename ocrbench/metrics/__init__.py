"""Per-layer metrics: one reader a metric, in a file named after it
(`<name>.py`, found by spec.reader), each `read(run) -> float | None`.
A reader that finds nothing to read returns None and the harness leaves
the metric out of the line. `Run` is what a traced window gives them."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

from .. import flops


@dataclass
class Run:
    cell: object
    seconds: float          # the traced window
    kind: str               # torch.cuda.get_device_name()
    answered: list          # harness.Answer of the requests done in it
    answered_all: list      # and of those the window's close drained
    requests_lines: Optional[List[int]]   # lines a request (line traffic)
    stages: dict            # utils/profiling.GLOBAL.summary()
    counts: object          # harness.Counts
    trace: object           # trace.Trace
    t0_ns: int
    t1_ns: int
    busy_s: float

    def within(self, t_ns: int) -> bool:
        return self.t0_ns <= t_ns < self.t1_ns

    @property
    def pages(self) -> int:
        return len(self.answered) if self.cell.traffic["kind"] == "pages" \
            else 0

    @property
    def lines(self) -> int:
        if self.requests_lines is None:
            return 0
        n = len(self.requests_lines)
        return sum(self.requests_lines[a.index % n] for a in self.answered)

    def rec_calls(self):
        return [r for r in self.counts.rec_calls if self.within(r[0])]

    def det_waves(self):
        return [w for w in self.counts.det_waves if self.within(w[0])]

    def model_flops(self) -> float:
        """Det forwards at each real page's (rh, rw) and rec forwards of
        each real row at the width its model reads (the masked SVTR: its
        valid width rounded up to 8; the CRNN: its bucket)."""
        cfg = self.cell.config
        det, rec = cfg["det"], cfg["rec"]
        total = 0.0
        for _, _, pages, _ in self.det_waves():
            for rh, rw in pages:
                total += flops.det_flops(det["params"], det["arch"],
                                         int(rh), int(rw))
        for _, _, valid, _, width in self.rec_calls():
            for vw in valid:
                w = 8 * math.ceil(vw / 8) if rec["arch"] == "svtr" \
                    else width
                total += flops.rec_flops(rec["params"], rec["arch"], w)
        return total

    def rec_fill(self) -> Optional[float]:
        calls = self.rec_calls()
        padded = sum(c[3] for c in calls)
        return 100.0 * sum(len(c[2]) for c in calls) / padded if padded \
            else None

    def mfu(self) -> Optional[float]:
        pk = flops.peaks(self.kind)
        f = self.model_flops()
        if pk is None or not f:
            return None
        return 100.0 * f / self.seconds / pk["fp32"]

    def idle_share(self) -> Optional[float]:
        return 100.0 * (1.0 - self.busy_s / self.seconds) \
            if self.seconds else None

    def ctc_head_roofline(self) -> Optional[float]:
        launches = [x for x in self.counts.ctc_launches
                    if self.within(x[0])]
        dev = self.trace.device_seconds(self.t0_ns, self.t1_ns, "ctc_head_")
        if not launches or dev <= 0:
            return None
        least = [flops.ctc_head_least_s(m, d, v, self.kind)
                 for _, m, d, v in launches]
        if any(x is None for x in least):
            return None
        return 100.0 * sum(least) / dev

    def stage_ms(self, stage: str) -> Optional[float]:
        # the stage timer ran until the last drained request was done
        s = self.stages.get(stage)
        if not s or not self.answered_all:
            return None
        return s["total_ms"] / len(self.answered_all)

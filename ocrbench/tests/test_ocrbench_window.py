"""Rates are all the work answered in the window over the whole window;
the closed loop keeps its depth and sends nothing once the window is
over; the trace's busy and idle arithmetic."""
import asyncio
import threading
from types import SimpleNamespace

from ocrbench import harness, run, spec
from ocrbench.trace import _gaps, _merge


def _ans(i, done, err=None):
    return harness.Answer(i, 0.0, done, None, err)


def test_rates_count_the_whole_window():
    cell = spec.load("v5-scans")
    answers = [_ans(0, 1.0), _ans(1, 9.9), _ans(2, 10.5),
               _ans(3, 5.0, "RuntimeError: x")]
    win = harness.Window(t0=0.5, t_end=10.0)
    m = run.end_to_end(cell, answers, win, seconds=9.5, setup_s=30.0,
                       pool=[b"x"])
    # two done within the window, over all of its 9.5 s: not over the
    # time to the last answer, and the failed one counts for nothing
    assert m["pages_per_s"]["value"] == 2 / 9.5
    assert m["setup_s"]["value"] == 30.0
    assert set(m) == {"pages_per_s", "setup_s"}


def test_lines_rate_counts_lines():
    cell = spec.load("v5-scans")
    cell.end_to_end = [{"name": "lines_per_s", "unit": "lines/s"}]
    pool = [[0] * 64, [0] * 32]
    m = run.end_to_end(cell, [_ans(0, 1.0), _ans(1, 2.0), _ans(2, 3.0)],
                       harness.Window(t0=0.0, t_end=4.0), seconds=4.0,
                       setup_s=1.0, pool=pool)
    assert m["lines_per_s"]["value"] == (64 + 32 + 64) / 4.0


class _Engine:
    """Stands in for EngineManager.run_ocr: a fixed service time."""

    def __init__(self, delay):
        self.delay = delay
        self.active = 0
        self.peak = 0
        self.lock = threading.Lock()

    async def run_ocr(self, img, name):
        with self.lock:
            self.active += 1
            self.peak = max(self.peak, self.active)
        await asyncio.sleep(self.delay)
        with self.lock:
            self.active -= 1
        return 0.0, [[]]


def test_closed_loop_keeps_its_depth_and_stops_at_the_end(monkeypatch):
    from onnxocr_tpu_torch.utils import imcodec
    monkeypatch.setattr(imcodec, "imdecode", lambda b: object())
    eng = _Engine(0.05)
    traffic = SimpleNamespace(payloads=[b"a", b"b", b"c"])
    opened = []

    def on_window(first):
        opened.append(first)
        return {first, first + 1}

    answers, win = asyncio.run(harness.closed_loop(
        eng, None, "m", traffic, "pages", 4, seconds=0.5,
        on_window=on_window))
    assert eng.peak == 4
    # the window opens once each page of the pool was answered
    assert opened == [win.first]
    before = {a.index % 3 for a in answers if a.t_done <= win.t0}
    assert before == {0, 1, 2}
    assert all(a.t_sent < win.t_end for a in answers)
    assert all(a.error is None for a in answers)
    done = run.answered_in(answers, win)
    # 4 slots of 50 ms over 0.5 s: about 40 answers in the window
    assert 30 <= len(done) <= 44
    assert sorted(a.index for a in answers) == list(range(len(answers)))
    kept = [a for a in answers if a.result is not None]
    assert sorted(a.index for a in kept) == [win.first, win.first + 1]


def test_a_short_window_still_sends_the_kept_requests(monkeypatch):
    """A window that closes before the loop reaches a kept request sends
    it after the close, so it is answered and judged; what is answered
    after the close counts for no rate."""
    from onnxocr_tpu_torch.utils import imcodec
    monkeypatch.setattr(imcodec, "imdecode", lambda b: object())
    eng = _Engine(0.05)
    traffic = SimpleNamespace(payloads=[b"a", b"b", b"c"])
    answers, win = asyncio.run(harness.closed_loop(
        eng, None, "m", traffic, "pages", 2, seconds=0.04,
        on_window=lambda first: {first + 9}))
    late = [a for a in answers if a.index == win.first + 9]
    assert len(late) == 1 and late[0].result is not None
    assert late[0].t_sent >= win.t_end
    assert max(a.index for a in answers) <= win.first + 10
    assert len(run.answered_in(answers, win)) <= 2


def test_busy_and_gaps():
    busy = _merge([(0, 10), (5, 20), (30, 40)])
    assert busy == [(0, 20), (30, 40)]
    assert _gaps(busy, 0, 50) == [(20, 30), (40, 50)]

"""The port's stage timer and program capture (onnxocr_tpu_torch/utils/
profiling.py) against the JAX package's on the CPU.

* StageTimer: on the same stages timed by one fake clock, the summaries
  (total_ms, count, mean_ms and their rounding) are equal; 8 threads
  opening 200 stages each lose no count on either side; disabled, a stage
  records nothing and is one shared no-op context.
* The hooks: one ocr() of a held-out page part on each of routes C (the
  staged bitmap wire), B (one-call) and A (staged, device det postprocess,
  classifier on) opens the same stages, as many times, as the JAX
  package's pipeline; with CAPTURE enabled both record the same program
  names ("det_bits", "fused_scored", "onecall"); disabled, CAPTURE holds
  nothing; replay_ms and flops of the captured programs give numbers.
"""
import threading

import numpy as np
import pytest
import torch

from onnxocr_tpu import ONNXPaddleOcr as JaxOcr
from onnxocr_tpu.utils import profiling as jprof

from onnxocr_tpu_torch import ONNXPaddleOcr, config
from onnxocr_tpu_torch.utils import profiling
from onnxocr_tpu_torch.utils.png import read_bgr

HELDOUT = config.ASSETS.parent / "test_images_heldout"
ROUTES = {
    "C": dict(),
    "B": dict(tpu_pipeline="onecall", use_angle_cls=False),
    "A": dict(tpu_det_postprocess="device", use_angle_cls=True,
              tpu_allow_untrained=True),
}
CLS = {"C": False, "B": False, "A": True}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Test processes run side by side on the machine's cores: two torch
    threads keep this module from oversubscribing them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class _Clock:
    """perf_counter stand-in: each read advances by the next step."""

    def __init__(self, steps):
        self.t = 100.0
        self.steps = iter(steps)

    def __call__(self):
        self.t += next(self.steps, 0.0)
        return self.t


def _run_stages(timer, monkeypatch, module):
    steps = [0.0, 0.0123456, 0.0, 0.001, 0.0, 0.25, 0.0, 0.0000049,
             0.0, 0.3333333]
    monkeypatch.setattr(module.time, "perf_counter", _Clock(steps))
    for name in ("det", "rec", "det", "onecall", "rec"):
        with timer.stage(name):
            pass
    return timer.summary()


def test_stage_timer_matches_jax(monkeypatch):
    got = _run_stages(profiling.StageTimer(True), monkeypatch, profiling)
    want = _run_stages(jprof.StageTimer(True), monkeypatch, jprof)
    assert got == want
    assert got["det"] == {"total_ms": 262.35, "count": 2, "mean_ms": 131.17}


@pytest.mark.parametrize("module", [profiling, jprof],
                         ids=["port", "jax"])
def test_stage_timer_threads(module):
    timer = module.StageTimer(True)

    def work(i):
        for _ in range(200):
            with timer.stage(f"s{i % 2}"):
                pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    summary = timer.summary()
    assert {k: v["count"] for k, v in summary.items()} == {"s0": 800,
                                                          "s1": 800}
    timer.reset()
    assert timer.summary() == {}


def test_stage_timer_switches(monkeypatch):
    monkeypatch.setenv("ONNXOCR_TPU_PROFILE", "1")
    assert profiling.StageTimer().enabled and jprof.StageTimer().enabled
    monkeypatch.setenv("ONNXOCR_TPU_PROFILE", "0")
    off = profiling.StageTimer()
    assert not off.enabled and not jprof.StageTimer().enabled
    assert off.stage("a") is off.stage("b")
    with off.stage("a"):
        pass
    assert off.summary() == {}


@pytest.fixture(scope="module")
def page():
    return np.ascontiguousarray(
        read_bgr(str(HELDOUT / "synth_00_doc.png"))[0:320, 0:640])


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("dict") / "ppocrv5_dict.txt"
    path.write_text("".join(f"<{i}>\n" for i in range(18383)))
    kw = dict(rec_char_dict_path=str(path), det_limit_side_len=640)
    out = {r: (ONNXPaddleOcr(device="cpu", **kw, **extra),
               JaxOcr(**kw, **extra)) for r, extra in ROUTES.items()}
    yield out
    for port, _ in out.values():
        port.close()


@pytest.fixture
def hooks_on():
    """Both packages' GLOBAL and CAPTURE enabled and empty for one test,
    disabled and emptied after it."""
    for mod in (profiling, jprof):
        mod.GLOBAL.reset()
        mod.CAPTURE._calls.clear()
        mod.GLOBAL.enabled = mod.CAPTURE.enabled = True
    yield
    for mod in (profiling, jprof):
        mod.GLOBAL.enabled = mod.CAPTURE.enabled = False
        mod.GLOBAL.reset()
        mod.CAPTURE._calls.clear()


def _counts(timer):
    return {k: v["count"] for k, v in timer.summary().items()}


@pytest.mark.parametrize("route", ROUTES)
def test_stages_and_programs_match_jax(models, page, hooks_on, route):
    port, ref = models[route]
    assert port.route == {"C": "bitmap", "B": "onecall",
                          "A": "device"}[route]
    port.ocr(page, cls=CLS[route])
    ref.ocr(page, cls=CLS[route])
    got, want = _counts(profiling.GLOBAL), _counts(jprof.GLOBAL)
    assert got == want and got
    assert all(v["mean_ms"] >= 0 for v in
               profiling.GLOBAL.summary().values())
    assert profiling.CAPTURE.names() == jprof.CAPTURE.names()
    names = profiling.CAPTURE.names()
    assert names == {"C": ["det_bits", "fused_scored"], "B": ["onecall"],
                     "A": []}[route]
    for name in names:
        ms = profiling.CAPTURE.replay_ms(name, n=2)
        assert ms is not None and ms > 0
        flops = profiling.CAPTURE.flops(name)
        assert flops is not None and flops > 1e6
    assert profiling.CAPTURE.replay_ms("absent") is None
    assert profiling.CAPTURE.flops("absent") is None


def test_disabled_capture_holds_nothing(models, page):
    assert not profiling.CAPTURE.enabled and not profiling.GLOBAL.enabled
    profiling.CAPTURE._calls.clear()
    for route, (port, _) in models.items():
        port.ocr(page, cls=CLS[route])
    assert profiling.CAPTURE.names() == []
    assert profiling.GLOBAL.summary() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as log_dir:
        torch.ones(4) @ torch.ones(4)
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    assert log_dir == str(tmp_path / "t")

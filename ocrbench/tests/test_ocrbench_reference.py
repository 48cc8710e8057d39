"""The reference against the port on the CPU at a tiny page size: each
configuration's run comes out correct; the same run with the timed path
broken underneath comes out not correct; and so does the control, the
program at bfloat16."""
import numpy as np
import pytest
import torch

from ocrbench import run, spec
from conftest import tiny

SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def _float32():
    run.prepare_process()
    torch.manual_seed(0)


def _cell(workload):
    """A cell of BENCHMARK.json; "server-scans", which has no cell yet,
    from its files: the ResNet18-vd DBNet and CRNN configuration on the
    same scans, under its own limits."""
    if workload != "server-scans":
        return spec.load(workload)
    import json
    from conftest import ROOT
    cell = spec.load("v5-scans")
    for attr, path in (("config", "configs/r18vd-db-crnn256.json"),
                       ("limits", "limits/server-scans.json")):
        with open(f"{ROOT}/ocrbench/{path}") as f:
            setattr(cell, attr, json.load(f))
    return cell


def _run(workload, seconds=5.0, extra=None):
    cell = tiny(_cell(workload))
    session = run.Session(cell, extra, device="cpu")
    try:
        return run.run_once(cell, SEED, seconds, False, session=session,
                            device="cpu")[:2]
    finally:
        session.close()


@pytest.mark.parametrize("workload", ["v5-scans", "server-scans"])
def test_port_matches_the_reference(workload):
    res, nums = _run(workload)
    assert res["correct"], nums
    assert nums["lines_compared"] >= 2
    assert nums["det_prob_gap"] < 1e-4
    assert nums["box_gap_px"] == 0.0
    assert nums["rec_gap"] < 1e-4
    assert list(res)[-1] == "checked"


def test_line_requests_match_the_reference():
    """The line traffic (ocrbench/traffic/lines-mixed.json, no cell yet)
    through `ocr(lines, det=False, cls=False)` against the reference."""
    import json
    from conftest import ROOT
    cell = spec.load("v5-scans")
    with open(f"{ROOT}/ocrbench/traffic/lines-mixed.json") as f:
        cell.traffic = json.load(f)
    cell.end_to_end = [{"name": "lines_per_s", "unit": "lines/s"}]
    cell.limits = {"rec_gap": cell.limits["rec_gap"]}  # rec alone
    cell = tiny(cell)
    session = run.Session(cell, device="cpu")
    try:
        res, nums, e2e = run.run_once(cell, SEED, 5.0, False,
                                      session=session, device="cpu")
    finally:
        session.close()
    assert res["correct"], nums
    assert nums["lines_compared"] >= 8 and nums["rec_gap"] < 1e-4
    assert e2e["lines_per_s"]["value"] > 0


def _break_token(monkeypatch):
    from onnxocr_tpu_torch.ops import ctc
    orig = ctc.CTCLabelDecode.decode_indices

    def altered(self, idx, prob=None, *a, **kw):
        idx = np.array(idx, copy=True)
        idx[:, :1] = 5  # the first step of every row reads class 5
        return orig(self, idx, prob, *a, **kw)

    monkeypatch.setattr(ctc.CTCLabelDecode, "decode_indices", altered)


def _break_box(monkeypatch):
    from onnxocr_tpu_torch.pipeline import system
    orig = system.TextSystem.__call__

    def shifted(self, img, cls=True):
        boxes, rec = orig(self, img, cls)
        return [np.asarray(b) + 4.0 for b in boxes], rec

    monkeypatch.setattr(system.TextSystem, "__call__", shifted)


def _break_map(monkeypatch):
    from onnxocr_tpu_torch.pipeline import detector
    orig = detector.TextDetector._pages_forward

    def damped(self, batch):
        return orig(self, batch) * 0.97

    monkeypatch.setattr(detector.TextDetector, "_pages_forward", damped)


@pytest.mark.parametrize("fault", [_break_token, _break_box, _break_map])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res, nums = _run("v5-scans")
    assert not res["correct"], nums


def test_the_control_is_not_correct():
    """The program's own bfloat16 path in the float32 configuration's
    place, at the tiny size."""
    res, nums = _run("v5-scans", extra={"tpu_dtype": "bfloat16"})
    assert not res["correct"], nums


def test_control_readings_carry_the_verdict():
    """ocrbench/control.py judges each reading by the cell's limits
    (`verdict`), apart from whether its short window answered a page:
    the float32 program passes, the bfloat16 control fails."""
    from ocrbench import control
    cell = tiny(spec.load("v5-scans"))
    prog, = control.readings(cell, [SEED], 5.0, device="cpu")
    ctrl, = control.readings(cell, [SEED], 5.0, control.CONTROL,
                             device="cpu")
    assert prog["verdict"] and prog["numbers"]["lines_compared"] >= 2, prog
    assert not ctrl["verdict"], ctrl
    assert prog["answered"] >= 0 and ctrl["answered"] >= 0

"""The port's goldens (tests/goldens_torch.json, written by
`python -m onnxocr_tpu_torch.tools.make_goldens` on the CPU with the
stand-in dictionary, the seeded classifier and the six DejaVu faces).

* Every captured seed replays on the CPU: texts equal, boxes within 1 px,
  scores within 1e-3 (`make_goldens.replay`).
* The port's capture of one seed equals the JAX tool's capture of that
  seed (tools/make_goldens.py's model and tools/eval_e2e.render_page,
  imported by path) on the same stand-in and faces: the same truths, the
  same texts, boxes within 1 px, scores within 1e-3.
* The file says what it was captured on, so that it is captured again
  once ppocrv5_dict.txt is committed.
"""
import importlib.util
import json
import os
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from onnxocr_tpu import config as jconfig
from onnxocr_tpu.train import synth as jsynth

from onnxocr_tpu_torch.tools import make_goldens

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def goldens():
    return json.loads(Path(make_goldens.GOLDEN_PATH).read_text(
        encoding="utf-8"))


@pytest.fixture(scope="module")
def model():
    return make_goldens.build_model(make_goldens.standin_dict(), "cpu")


def test_goldens_record_their_capture(goldens):
    meta = goldens["captured_on"]
    assert meta["device"] == "cpu" and "stand-in" in meta["dictionary"]
    assert "ppocrv5_dict.txt" in meta["dictionary"]
    assert meta["fonts"] == [os.path.basename(p) for p in
                             make_goldens.golden_fonts()]
    assert sorted(goldens["pages"]) == [str(s) for s in make_goldens.SEEDS]
    assert all(g["results"] for g in goldens["pages"].values())


@pytest.mark.parametrize("seed", [str(s) for s in make_goldens.SEEDS])
def test_goldens_replay_on_the_cpu(goldens, model, seed):
    assert make_goldens.replay(goldens, seed, model) == []


def test_capture_equals_the_jax_tools(tmp_path, model, monkeypatch):
    """Seed 101 through both tools: the JAX tool's model (its capture()'s
    kwargs) on the JAX render_page with the same stand-in and faces."""
    dict_path = make_goldens.standin_dict(
        str(tmp_path / "ppocrv5" / "ppocrv5_dict.txt"))
    monkeypatch.setenv("ONNXOCR_TPU_ALLOW_UNTRAINED", "1")
    monkeypatch.setattr(jconfig, "_ASSET_SEARCH_PATHS",
                        [str(tmp_path)] + list(jconfig._ASSET_SEARCH_PATHS))
    monkeypatch.setitem(jconfig.DEFAULTS, "rec_char_dict_path", dict_path)
    monkeypatch.setattr(jsynth, "FONTS", make_goldens.golden_fonts())
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location(
        "jax_make_goldens", str(REPO / "tools" / "make_goldens.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    from onnxocr_tpu import ONNXPaddleOcr
    from tools.eval_e2e import render_page
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmodel = ONNXPaddleOcr(use_angle_cls=True, use_gpu=False,
                               drop_score=0.3, det_limit_side_len=640,
                               tpu_det_bucket=320)
    assert jtool.GOLDEN_PATH.endswith(os.path.join("tests", "goldens.json"))
    page, truths = render_page(101)
    res = jmodel.ocr(page)
    ref = {"truths": [t for t, _ in truths],
           "results": [{"box": line[0], "text": line[1][0],
                        "score": round(float(line[1][1]), 4)}
                       for line in res[0]]}
    got = make_goldens.page_results(model, 101, dict_path)
    assert got["truths"] == ref["truths"]
    assert [r["text"] for r in got["results"]] == [
        r["text"] for r in ref["results"]] and got["results"]
    for g, r in zip(got["results"], ref["results"]):
        assert np.abs(np.asarray(g["box"]) - np.asarray(
            r["box"], np.float64)).max() <= 1.0
        assert abs(g["score"] - r["score"]) <= 1e-3

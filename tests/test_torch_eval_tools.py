"""The port's corpus and eval tools (onnxocr_tpu_torch/tools/
{make_test_corpus, eval_heldout, eval_corpus, evalgate, eval_e2e}) against
the JAX package's tools/ of the same names, imported by path, on the CPU
with the same stand-in dictionary (make_goldens.standin_dict, through
ONNXOCR_TPU_ASSETS and the JAX config's search path) and pinned lexicon.

* `similarity`, `edit_distance` and `aabb_iou` agree on seeded cases.
* `compose` renders one doc page and one hard page at reduced shapes: the
  ground truth equal, the doc page equal array for array, the hard page
  within the bound of ROADMAP §3.3 (its cv2.resize INTER_CUBIC background
  is the port's twin: at most 0.5 % of values off, by at most 8 levels).
* `render_page` equal array for array, with its truths, on two seeds.
* `eval_corpus --json` on a two-page corpus and `eval_heldout --json` on
  two held-out pages (each tool's corpus / synth directory pointed at a
  temporary copy; the real set's directory is absent for both) print
  the same summary and per-image rows, key for key and value for value.
* `evalgate log` appends the same line but `ts` and `git_head`, each to
  its own temporary ledger.
* `make_test_corpus` writes every page and gt.json under --out; no tool's
  default output is a path the JAX tool writes or a committed file; the
  tools exit without CUDA unless --device cpu is given.
"""
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from onnxocr_tpu import config as jconfig
from onnxocr_tpu.train import synth as jsynth

from onnxocr_tpu_torch.tools import (eval_corpus, eval_e2e, eval_heldout,
                                     evalgate, make_goldens, make_test_corpus)
from onnxocr_tpu_torch.train import synth

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))


def _load(name, path=None):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", str(path or REPO / "tools" / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """An asset root holding the stand-in ppocrv5/ppocrv5_dict.txt."""
    root = tmp_path_factory.mktemp("assets")
    make_goldens.standin_dict(str(root / "ppocrv5" / "ppocrv5_dict.txt"))
    return root


@pytest.fixture()
def standin(assets, monkeypatch):
    """Both packages pointed at the stand-in, the seeded classifier
    allowed, one lexicon."""
    monkeypatch.setenv("ONNXOCR_TPU_ASSETS", str(assets))
    monkeypatch.setenv("ONNXOCR_TPU_ALLOW_UNTRAINED", "1")
    monkeypatch.setattr(jconfig, "_ASSET_SEARCH_PATHS",
                        [str(assets)] + list(jconfig._ASSET_SEARCH_PATHS))
    lexicon = jsynth._lexicon()
    monkeypatch.setattr(jsynth, "_LEXICON_CACHE", list(lexicon))
    monkeypatch.setattr(synth, "_LEXICON_CACHE", list(lexicon))
    return assets / "ppocrv5" / "ppocrv5_dict.txt"


def _run_main(mod, argv, capsys, monkeypatch):
    """A tool's main() with argv, → its last printed line as JSON."""
    monkeypatch.setattr(sys, "argv", [mod.__name__] + argv)
    capsys.readouterr()
    mod.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_metrics_equal_the_jax_tools():
    jheld, jcorpus = _load("eval_heldout"), _load("eval_corpus")
    rng = np.random.default_rng(61)
    alphabet = list("abcxyz ü0%<>")
    for _ in range(300):
        a, b = ("".join(rng.choice(alphabet, int(rng.integers(0, 9))))
                for _ in range(2))
        assert eval_heldout.edit_distance(a, b) == jheld.edit_distance(a, b)
        assert eval_heldout.similarity(a, b) == jheld.similarity(a, b)
    for _ in range(300):
        qa, qb = (rng.integers(0, 60, (4, 2)).tolist() for _ in range(2))
        assert eval_corpus.aabb_iou(qa, qb) == jcorpus.aabb_iou(qa, qb)
    assert eval_corpus.aabb_iou([[0, 0], [4, 0], [4, 4], [0, 4]],
                                [[2, 2], [6, 2], [6, 6], [2, 6]]) == 4 / 28


@pytest.mark.parametrize("style", ["doc", "hard"])
def test_compose_equals_the_jax_tools(standin, style):
    jtool = _load("make_test_corpus")
    jc2i = jsynth.charset_from_dict(str(standin))
    c2i = synth.charset_from_dict(str(standin))
    shape, n_lines, hrange = ((150, 260), 4, (18, 30)) if style == "doc" \
        else ((170, 300), 3, (28, 44))
    ref = jtool.compose(jsynth.TextRenderer(char_to_idx=jc2i, seed=5),
                        np.random.default_rng(5), shape, n_lines, style,
                        hrange)
    got = make_test_corpus.compose(synth.TextRenderer(char_to_idx=c2i,
                                                      seed=5),
                                   np.random.default_rng(5), shape, n_lines,
                                   style, hrange)
    assert got[1] == ref[1] and len(ref[1]) >= 2
    assert got[0].shape == ref[0].shape and got[0].dtype == np.uint8
    diff = np.abs(got[0].astype(int) - ref[0].astype(int))
    if style == "doc":
        np.testing.assert_array_equal(got[0], ref[0])
    else:
        print(f"hard page: {np.count_nonzero(diff)} of {diff.size} values "
              f"off, by at most {diff.max()}")
        assert np.count_nonzero(diff) <= 0.005 * diff.size
        assert diff.max() <= 8


@pytest.mark.parametrize("seed", [100, 103])
def test_render_page_equals_the_jax_tools(standin, seed):
    jtool = _load("eval_e2e")
    ref_page, ref_truths = jtool.render_page(seed)
    page, truths = eval_e2e.render_page(seed)
    np.testing.assert_array_equal(page, ref_page)
    assert truths == ref_truths and len(truths) >= 3


@pytest.fixture(scope="module")
def corpus_copy(tmp_path_factory):
    """Two pages of the committed corpus and their ground truth."""
    root = tmp_path_factory.mktemp("corpus")
    src = REPO / "onnxocr_tpu" / "test_images"
    gt = json.loads((src / "gt.json").read_text())
    keep = {k: gt[k] for k in ("card.jpg", "ticket.jpg")}
    for name in keep:
        shutil.copy(src / name, root / name)
    (root / "gt.json").write_text(json.dumps(keep))
    return root


@pytest.fixture(scope="module")
def heldout_tree(tmp_path_factory):
    """A tree in the JAX layout holding a copy of tools/eval_heldout.py and
    two held-out pages with their ground truth (the JAX tool finds the
    synth set beside its own file)."""
    root = tmp_path_factory.mktemp("heldout")
    (root / "tools").mkdir()
    shutil.copy(REPO / "tools" / "eval_heldout.py", root / "tools")
    src = REPO / "onnxocr_tpu" / "test_images_heldout"
    dst = root / "onnxocr_tpu" / "test_images_heldout"
    dst.mkdir(parents=True)
    gt = json.loads((src / "gt.json").read_text())
    keep = {k: gt[k] for k in ("synth_00_doc.png", "synth_12_scan.png")}
    for name in keep:
        shutil.copy(src / name, dst / name)
    (dst / "gt.json").write_text(json.dumps(keep))
    return root


def test_eval_corpus_json_equals_the_jax_tools(standin, corpus_copy,
                                               capsys, monkeypatch):
    jtool = _load("eval_corpus")
    monkeypatch.setattr(jtool, "CORPUS", str(corpus_copy))
    monkeypatch.setattr(eval_corpus, "CORPUS", str(corpus_copy))
    ref = _run_main(jtool, ["--json"], capsys, monkeypatch)
    got = _run_main(eval_corpus, ["--json", "--device", "cpu"], capsys,
                    monkeypatch)
    assert got == ref
    assert ref["summary"]["gt_lines"] == 7 and set(ref["per_image"]) == {
        "card.jpg", "ticket.jpg"}


def test_eval_heldout_json_equals_the_jax_tools(standin, heldout_tree,
                                                tmp_path, capsys,
                                                monkeypatch):
    jtool = _load("eval_heldout", heldout_tree / "tools" / "eval_heldout.py")
    monkeypatch.setattr(eval_heldout, "SYNTH_DIR", str(
        heldout_tree / "onnxocr_tpu" / "test_images_heldout"))
    # the port reads the real set inside its own checkout; here that set
    # is absent for both tools, so its pages are skipped
    assert Path(eval_heldout.REF_IMAGES) == \
        REPO / "build" / "reference" / "onnxocr" / "test_images"
    missing = str(tmp_path / "reference" / "onnxocr" / "test_images")
    monkeypatch.setattr(jtool, "REF_IMAGES", missing)
    monkeypatch.setattr(eval_heldout, "REF_IMAGES", missing)
    ref = _run_main(jtool, ["--json"], capsys, monkeypatch)
    got = _run_main(eval_heldout, ["--json", "--device", "cpu"], capsys,
                    monkeypatch)
    assert got == ref
    summary = ref["summary"]
    assert summary["subtotals"]["real"]["gt_lines"] == 0
    assert summary["subtotals"]["synth"]["gt_lines"] == summary[
        "gt_lines"] > 0


def test_evalgate_log_equals_the_jax_tools(tmp_path, capsys, monkeypatch):
    jtool = _load("evalgate")
    payload = {"summary": {"model": "PP-OCRv5", "gt_lines": 12,
                           "line_recall@0.5": 0.5, "char_accuracy": 0.25,
                           "exact_match": 1, "subtotals": {"synth": {
                               "gt_lines": 12}}}, "per_image": {}}
    src = tmp_path / "eval.json"
    src.write_text("noise\n" + json.dumps(payload) + "\n")
    det = str(REPO / "onnxocr_tpu" / "assets" / "ppocrv5" / "det" /
              "det.onnx")
    argv = ["log", "--name", "gate_a", "--from-json", str(src), "--det-dir",
            det, "--set", "drop_score=0.4", "--decision", "adopt",
            "--notes", "n"]
    monkeypatch.setattr(jtool, "LEDGER", str(tmp_path / "jax.jsonl"))
    _run_main(jtool, argv, capsys, monkeypatch)
    _run_main(evalgate, argv + ["--ledger", str(tmp_path / "port.jsonl")],
              capsys, monkeypatch)
    ref, = [json.loads(x) for x in (tmp_path / "jax.jsonl").open()]
    got, = [json.loads(x) for x in (tmp_path / "port.jsonl").open()]
    for entry in (ref, got):
        entry.pop("ts")
        entry.pop("git_head")
    assert got == ref and ref["checkpoints"]["det"]["sha256"]
    assert evalgate.LEDGER == str(REPO / "evalgates_torch.jsonl")


def test_make_test_corpus_writes_every_page(standin, tmp_path):
    manifest = make_test_corpus.main(["--out", str(tmp_path)])
    names = [n + ".jpg" for n, *_ in make_test_corpus.PAGES]
    assert sorted(manifest) == sorted(names) and sum(map(len,
                                                         manifest.values()))
    assert json.loads((tmp_path / "gt.json").read_text()) == manifest
    from onnxocr_tpu_torch.utils import imcodec
    for (name, shape, *_) in make_test_corpus.PAGES:
        page = imcodec.imdecode((tmp_path / f"{name}.jpg").read_bytes())
        assert page.shape == shape + (3,)
    assert make_test_corpus.SEED == 20260817
    assert [p[:2] for p in make_test_corpus.PAGES] == [
        p[:2] for p in _load("make_test_corpus").PAGES]


def test_default_outputs_are_the_ports_own():
    committed = subprocess.run(["git", "ls-files"], cwd=REPO,
                               capture_output=True, text=True).stdout
    assert Path(make_test_corpus.DEFAULT_OUT) == REPO / "build" / \
        "test_images"
    assert Path(evalgate.LEDGER).name == "evalgates_torch.jsonl"
    assert Path(make_goldens.GOLDEN_PATH).name == "goldens_torch.json"
    assert str(Path(make_goldens.STANDIN_PATH).relative_to(REPO)).startswith(
        "build")
    for path in (make_test_corpus.DEFAULT_OUT, make_goldens.STANDIN_PATH):
        assert str(Path(path).relative_to(REPO)) not in committed


@pytest.mark.parametrize("tool", ["eval_heldout", "eval_corpus", "eval_e2e"])
def test_tools_exit_without_cuda(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", f"onnxocr_tpu_torch.tools.{tool}"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr

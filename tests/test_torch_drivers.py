"""The port's last drivers (onnxocr_tpu_torch/tools/{bench_det_variants,
service_check, make_support, grow_rec}, onnxocr_tpu_torch/{test_ocr, webui,
app_service}) against the JAX package's (tools/*.py and the root scripts,
imported or run by path) on the CPU, with the stand-in dictionary of
make_goldens.standin_dict through ONNXOCR_TPU_ASSETS and the seeded
classifier allowed.

* grow_rec writes the JAX tool's tree for the same --src, --seed and
  --add-depth 1 (equal npz leaves), and the grown SVTR's logits equal the
  donor's.
* make_support's sidecar equals what the JAX package's
  synth.charset_from_dict + TextRenderer give on the stand-in; a missing
  dictionary prints "skip (missing)".
* bench_det_variants --rounds 1 --max-images 1 prints the JAX tool's keys
  and the device, and each variant's box count is the JAX package's
  ONNXPaddleOcr's under the same setting on that page.
* service_check boots the port's server on the CPU and ends with SERVICE
  CHECK OK; test_ocr runs under the opt-in and writes its overlay under
  build/ and nowhere else, and without the classifier's weights fails as
  the JAX script does; the launchers build the app and serve it on the
  reference's ports (or --port's); every driver exits without CUDA unless the CPU is
  asked for.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from onnxocr_tpu import ONNXPaddleOcr as JaxOcr
from onnxocr_tpu.train import synth as jsynth

from onnxocr_tpu_torch import app_service, test_ocr, webui
from onnxocr_tpu_torch.service import http as http_mod
from onnxocr_tpu_torch.tools import (bench_det_variants, grow_rec,
                                     make_goldens, make_support,
                                     service_check, time_imdecode)
from onnxocr_tpu_torch.utils import imcodec, params_io

REPO = Path(__file__).resolve().parents[1]
REC_CKPT = REPO / "onnxocr_tpu" / "assets" / "ppocrv5" / "rec" / \
    "native_params.npz"


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
    monkeypatch.setenv("ONNXOCR_TPU_ASSETS", str(assets))
    monkeypatch.setenv("ONNXOCR_TPU_ALLOW_UNTRAINED", "1")
    return assets / "ppocrv5" / "ppocrv5_dict.txt"


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(**extra):
    """This process's environment less the classifier opt-in, the
    checkout on PYTHONPATH, then `extra`."""
    env = dict(os.environ)
    env.pop("ONNXOCR_TPU_ALLOW_UNTRAINED", None)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.update(extra)
    return env


def test_grow_rec_equals_the_jax_tool(tmp_path, monkeypatch, capsys):
    jtool = _load(REPO / "tools" / "grow_rec.py", "jax_grow_rec")
    jout, out = tmp_path / "jax.npz", tmp_path / "port.npz"
    argv = ["--src", str(REC_CKPT), "--seed", "5001", "--add-depth", "1"]
    monkeypatch.setattr(sys, "argv", ["grow_rec", *argv, "--out", str(jout)])
    jtool.main()
    err = grow_rec.main([*argv, "--out", str(out), "--device", "cpu"])
    assert err == 0.0
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("donor: depth=6 dim=192") for line in lines) \
        == 2
    assert any(line == f"wrote {out}: depth=7" for line in lines)
    with np.load(jout) as j, np.load(out) as p:
        assert sorted(j.files) == sorted(p.files)
        for k in j.files:
            assert j[k].dtype == p[k].dtype, k
            np.testing.assert_array_equal(j[k], p[k], err_msg=k)
    grown = params_io.load_tree(str(out))
    assert not grown["mixer"][-1]["proj"]["w"].any()
    assert not grown["mixer"][-1]["fc2"]["w"].any()


def test_make_support_equals_the_jax_package(standin, tmp_path, capsys):
    c2i = jsynth.charset_from_dict(str(standin), charset=None)
    r = jsynth.TextRenderer(char_to_idx=c2i)
    indices = sorted({0} | {c2i[c] for c in r.charset})
    want = {"dict": "ppocrv5/ppocrv5_dict.txt", "n": len(indices),
            "indices": indices, "chars": "".join(sorted(r.charset))}
    assert make_support.support(str(standin), want["dict"]) == want
    make_support.main(["--out-dir", str(tmp_path), "--device", "cpu"])
    side = tmp_path / "ppocrv5" / "ppocrv5_dict.txt.trained_support.json"
    assert json.loads(side.read_text()) == want
    out = capsys.readouterr().out
    assert "skip (missing): ch_ppocr_server_v2.0/ppocr_keys_v1.txt" in out
    assert Path(make_support.OUT_DIR).is_relative_to(REPO / "build")


def test_bench_det_variants_counts_the_jax_boxes(standin, tmp_path,
                                                 monkeypatch, capsys):
    """One corpus page, one round: the JAX tool's keys plus the device; the
    three variants' box counts are the JAX package's under the same
    settings; the launches side file holds each variant."""
    side = tmp_path / "launches.json"
    monkeypatch.setenv("BENCH_LAUNCHES_OUT", str(side))
    out = bench_det_variants.main(["--rounds", "1", "--max-images", "1",
                                   "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(out) == {"metric", "images", "rounds", "variants", "device"}
    assert out["metric"] == "e2e_ms_per_page_by_det_wire"
    assert (out["images"], out["rounds"]) == (1, 1)
    assert set(out["variants"]) == {"maps", "bitmap", "device"}
    assert out["device"] == {"name": "cpu", "power_limit_w": None,
                             "count": 0}
    assert set(json.loads(side.read_text())["launches_per_page"]) == \
        set(out["variants"])
    first = sorted((REPO / "onnxocr_tpu" / "test_images").glob("*.jpg"))[0]
    page = cv2.imread(str(first))
    np.testing.assert_array_equal(bench_det_variants.load_images(1)[0],
                                  page)
    for name, kw in bench_det_variants.VARIANTS.items():
        jmodel = JaxOcr(use_angle_cls=True, use_gpu=False, drop_score=0.0,
                        rec_char_dict_path=str(standin),
                        tpu_allow_untrained=True, **kw)
        try:
            boxes = len(jmodel.ocr(page)[0] or [])
        finally:
            close = getattr(jmodel, "close", None)
            if close is not None:
                close()
        v = out["variants"][name]
        assert v["mean_boxes"] == boxes, (name, v, boxes)
        assert v["median_ms"] > 0


def test_service_check_passes_on_the_cpu(assets):
    """WARMUP=false in the caller's environment: the tool sets WARMUP=true
    for its server, as the JAX tool does."""
    proc = subprocess.run(
        [sys.executable, "-m", "onnxocr_tpu_torch.tools.service_check",
         "--device", "cpu"], cwd=str(REPO), capture_output=True, text=True,
        timeout=600, env=_env(DEVICE="cpu", WARMUP="false",
                              ONNXOCR_TPU_ASSETS=str(assets),
                              ONNXOCR_TPU_ALLOW_UNTRAINED="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("ready after ")
    assert lines[1].startswith("v1 status 200 results: [")
    assert lines[2].startswith("v2 status 200 results: [")
    assert lines[3].startswith("truths: [") and lines[4] == "UI: 200"
    assert lines[-1] == "SERVICE CHECK OK"
    page = imcodec.imdecode((service_check.OUT_DIR /
                             "tests_page.png").read_bytes())
    assert page.shape == (640, 640, 3)
    assert Path(service_check.OUT_DIR).is_relative_to(REPO / "build")


def test_test_ocr_writes_its_overlay_under_build(assets, tmp_path):
    overlay = test_ocr.OUT
    before = overlay.stat().st_mtime_ns if overlay.exists() else -1
    proc = subprocess.run(
        [sys.executable, "-m", "onnxocr_tpu_torch.test_ocr", "--device",
         "cpu"], cwd=str(tmp_path), capture_output=True, text=True,
        timeout=600, env=_env(ONNXOCR_TPU_ASSETS=str(assets),
                              ONNXOCR_TPU_ALLOW_UNTRAINED="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("total time: ")
    assert lines[1].startswith("result: [[[[")
    assert lines[-1] == "saved build/test_ocr/draw_ocr.jpg"
    assert overlay.stat().st_mtime_ns > before
    assert overlay.is_relative_to(REPO / "build")
    assert list(tmp_path.iterdir()) == []        # nothing in the cwd
    img = imcodec.imdecode(overlay.read_bytes())   # boxes + text panel
    assert img is not None and img.shape[1] > img.shape[0]


def test_test_ocr_without_the_classifier_fails_as_jax(assets, tmp_path):
    """No cls weights and no opt-in: both scripts raise FileNotFoundError
    before they read a page."""
    env = _env(ONNXOCR_TPU_ASSETS=str(assets), JAX_PLATFORMS="cpu")
    for argv in ([str(REPO / "test_ocr.py")],
                 ["-m", "onnxocr_tpu_torch.test_ocr", "--device", "cpu"]):
        proc = subprocess.run([sys.executable, *argv], cwd=str(tmp_path),
                              capture_output=True, text=True, timeout=600,
                              env=env)
        assert proc.returncode != 0
        assert "FileNotFoundError" in proc.stderr, proc.stderr[-2000:]
        assert "total time" not in proc.stdout
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("module,argv,port", [
    (webui, [], 5000), (app_service, [], 5005),
    (webui, ["--port", "0"], 0), (app_service, ["--port", "5123"], 5123)])
def test_launchers_serve_the_reference_ports(module, argv, port,
                                             monkeypatch):
    """The reference's ports by default; --port overrides them (0: the
    system's choice)."""
    from onnxocr_tpu_torch.service.settings import settings
    seen = []

    async def fake_serve(app, host, port):
        seen.append((app, host, port))

    monkeypatch.setattr(webui, "serve", fake_serve)
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    module.main(argv)
    assert len(seen) == 1
    app, host, bound = seen[0]
    assert isinstance(app, http_mod.App)
    assert (host, bound) == ("0.0.0.0", port)


@pytest.mark.parametrize("entry", [
    "bench_det_variants", "service_check", "make_support", "grow_rec",
    "test_ocr", "webui", "time_imdecode"])
def test_drivers_exit_without_cuda(entry, monkeypatch):
    from onnxocr_tpu_torch.service.settings import settings
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(settings, "DEVICE", "cuda")
    monkeypatch.delenv("DEVICE", raising=False)
    mains = {
        "bench_det_variants": lambda: bench_det_variants.main([]),
        "service_check": lambda: service_check.main([]),
        "make_support": lambda: make_support.main([]),
        "grow_rec": lambda: grow_rec.main(["--src", "a", "--out", "b"]),
        "test_ocr": lambda: test_ocr.main([]),
        "webui": lambda: webui.main([]),
        "time_imdecode": lambda: time_imdecode.main(["a.jpg"]),
    }
    with pytest.raises(SystemExit) as e:
        mains[entry]()
    assert e.value.code not in (0, None)


def test_time_imdecode_times_each_root(capsys):
    """One JSON line: a run a root in the order given, each file's shape
    (the decoded image's) and its median and minimum milliseconds."""
    samples = REPO / "onnxocr_tpu_torch" / "assets" / "samples"
    files = [str(samples / "sample_arith.jpg"), str(samples / "sample_anim.gif")]
    time_imdecode.main(files + ["--roots", str(REPO), str(REPO),
                                "--rounds", "2", "--device", "cpu"])
    runs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["runs"]
    assert [r["root"] for r in runs] == [str(REPO)] * 2
    for run in runs:
        assert list(run["files"]) == files
        for path, rec in run["files"].items():
            assert rec["shape"] == list(imcodec.imdecode(
                Path(path).read_bytes()).shape)
            assert 0 < rec["ms_min"] <= rec["ms_median"]

"""Nothing the benchmark loads is JAX or the JAX package, compared by the
whole top-level name (the port's name begins with the JAX package's); the
reference loads nothing of the program either."""
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "onnxocr_tpu"}

PROBE = r"""
import sys, json
for m in MODULES:
    __import__(m)
from ocrbench import spec
for name in NAMES:
    spec.reader(name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(modules, names=()):
    code = PROBE.replace("MODULES", repr(list(modules))).replace(
        "NAMES", repr(list(names)))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": ROOT})
    assert out.returncode == 0, out.stderr
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_benchmark_loads_no_jax():
    import json
    with open(f"{ROOT}/BENCHMARK.json") as f:
        names = [m["name"] for m in json.load(f)["per_layer"]]
    tops = _top_level(["ocrbench.run", "ocrbench.harness", "ocrbench.check",
                       "ocrbench.control", "ocrbench.trace",
                       "ocrbench.flops", "ocrbench.gen.traffic",
                       "onnxocr_tpu_torch.service.engine",
                       "onnxocr_tpu_torch.pipeline.api"], names)
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert "onnxocr_tpu_torch" in tops


def test_reference_loads_nothing_of_the_program():
    tops = _top_level(["ocrbench.reference.ocr", "ocrbench.reference.nets",
                       "ocrbench.flops"])
    assert not tops & (FORBIDDEN | {"onnxocr_tpu_torch"})


def test_the_check_compares_whole_names():
    from ocrbench import run
    saved = dict(sys.modules)
    try:
        sys.modules["onnxocr_tpu_torch_x"] = sys
        assert "onnxocr_tpu" not in run.forbidden_modules()
        sys.modules["onnxocr_tpu.pipeline"] = sys
        assert "onnxocr_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)

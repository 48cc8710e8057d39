"""Import rules of the PyTorch port, checked on the syntax tree: no module
of onnxocr_tpu_torch, and none of chip_smoke.py, ab_torch_kernels.py,
ab_warp.py, ab_mesh.py and ab_batcher.py, imports jax, the onnxocr_tpu
package or its onnxocr shim (which imports onnxocr_tpu, and so jax), cv2,
PIL, fitz, fontTools or matplotlib (the machine with the GPU has none of
them)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "onnxocr_tpu", "onnxocr", "cv2", "PIL", "fitz",
             "fontTools", "matplotlib")
FILES = sorted((ROOT / "onnxocr_tpu_torch").rglob("*.py")) + [
    ROOT / name for name in ("chip_smoke.py", "ab_torch_kernels.py",
                             "ab_warp.py", "ab_mesh.py", "ab_batcher.py")]


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", "") == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_files_exist():
    assert len(FILES) > 20 and all(p.exists() for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_walk_covers_the_reference_layout_subpackage():
    """onnxocr_tpu_torch/onnxocr/ (the port's reference-layout shim) is
    walked like every other module of the port."""
    shim = ROOT / "onnxocr_tpu_torch" / "onnxocr"
    walked = [p for p in FILES if p.parent == shim]
    assert sorted(walked) == sorted(shim.glob("*.py")) and len(walked) == 15


@pytest.mark.parametrize("source,caught", [
    ("from . import operators", False),
    ("from .utils import infer_args", False),
    ("from ..onnxocr import utils", False),
    ("from onnxocr_tpu_torch.onnxocr import utils", False),
    ("import onnxocr_tpu_torch.onnxocr.utils", False),
    ("import onnxocr", True),
    ("import onnxocr.utils", True),
    ("from onnxocr.utils import infer_args", True),
    ("from onnxocr import utils", True),
    ("__import__('onnxocr.utils')", True),
])
def test_walk_tells_the_port_shim_from_the_reference_shim(tmp_path, source,
                                                          caught):
    """A subpackage named onnxocr inside the port, reached relatively or by
    its full name, is not the forbidden top-level onnxocr; a real import
    of that is still caught."""
    path = tmp_path / "module.py"
    path.write_text(source + "\n")
    tops = {name.split(".")[0] for name in _imported(path)}
    assert bool(tops & set(FORBIDDEN)) == caught

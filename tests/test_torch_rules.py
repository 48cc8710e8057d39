"""Import rules of the PyTorch port, checked on the syntax tree: no module
of onnxocr_tpu_torch, and none of chip_smoke.py, ab_torch_kernels.py,
ab_warp.py and ab_mesh.py, imports jax, the onnxocr_tpu package, cv2, PIL
or fitz (the machine with the GPU has none of them)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "onnxocr_tpu", "cv2", "PIL", "fitz")
FILES = sorted((ROOT / "onnxocr_tpu_torch").rglob("*.py")) + [
    ROOT / name for name in ("chip_smoke.py", "ab_torch_kernels.py",
                             "ab_warp.py", "ab_mesh.py")]


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

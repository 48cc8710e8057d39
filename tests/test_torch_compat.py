"""The port's reference-layout shim (onnxocr_tpu_torch/onnxocr/) against
the JAX package's (onnxocr/) on the CPU: every reference import path of
tests/test_compat.py under onnxocr_tpu_torch.onnxocr, the same 14 modules
with the same public names, infer_args() dest for dest and default for
default (the output dirs under the port's package), the preprocessing
chain transform(create_operators(...)) on a seeded image within 1e-6
(DetResizeForTest's cv2.resize is the port's twin, value-equal), and the
session layer on a small graph."""
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_compat import REFERENCE_IMPORTS

torch.set_num_threads(2)

MODULES = ["onnx_paddleocr", "predict_system", "predict_det", "predict_rec",
           "predict_cls", "predict_base", "db_postprocess",
           "rec_postprocess", "cls_postprocess", "operators", "imaug",
           "ocr_images_pdfs", "utils", "logger"]


def _port(module: str):
    return importlib.import_module("onnxocr_tpu_torch." + module)


@pytest.mark.parametrize("module,names", REFERENCE_IMPORTS)
def test_reference_import_paths(module, names):
    mod = _port(module)
    for name in names:
        assert hasattr(mod, name), f"onnxocr_tpu_torch.{module}.{name}"


@pytest.mark.parametrize("module", MODULES)
def test_modules_mirror_the_jax_shim(module):
    """Module for module, the JAX shim's public names, each from the port
    (never from onnxocr_tpu)."""
    ref = importlib.import_module("onnxocr." + module)
    mod = _port("onnxocr." + module)
    names = getattr(ref, "__all__", None) or [
        n for n in vars(ref) if not n.startswith("_") and
        getattr(vars(ref)[n], "__module__", "").startswith("onnxocr")]
    assert set(names) <= set(dir(mod))
    for name in names:
        owner = getattr(getattr(mod, name), "__module__", "") or ""
        assert not owner.startswith(("onnxocr_tpu.", "onnxocr.")), \
            (module, name, owner)


def test_shim_has_every_module_of_the_jax_shim():
    root = Path(__file__).resolve().parents[1]
    ref = sorted(p.stem for p in (root / "onnxocr").glob("*.py"))
    port = sorted(p.stem for p in (
        root / "onnxocr_tpu_torch" / "onnxocr").glob("*.py"))
    assert port == ref and len(ref) == 15   # 14 modules and __init__


def test_infer_args_equals_the_jax_shims():
    from onnxocr.utils import infer_args as jinfer_args
    from onnxocr_tpu_torch.onnxocr.utils import infer_args
    ref = {a.dest: (a.default, a.type) for a in jinfer_args()._actions}
    got = {a.dest: (a.default, a.type) for a in infer_args()._actions}
    assert sorted(got) == sorted(ref) and len(ref) == 115
    own = {"crop_res_save_dir", "draw_img_save_dir", "save_log_path"}
    for dest, (default, kind) in ref.items():
        if dest in own:  # output dirs: the port's package, never the JAX's
            assert default.replace("onnxocr_tpu", "onnxocr_tpu_torch", 1) \
                == got[dest][0], dest
            continue
        assert got[dest][0] == default, dest
        assert getattr(got[dest][1], "__name__", None) == getattr(
            kind, "__name__", None), dest
    d = {k: v[0] for k, v in got.items()}
    assert d["det_limit_side_len"] == 960.0 and d["drop_score"] == 0.5
    assert d["rec_image_shape"] == "3, 48, 320"
    assert d["label_list"] == ["0", "180"]


_OPS = [
    [{"DetResizeForTest": {"limit_side_len": 960, "limit_type": "max"}},
     {"NormalizeImage": {"std": [0.229, 0.224, 0.225],
                         "mean": [0.485, 0.456, 0.406],
                         "scale": "1./255.", "order": "hwc"}},
     {"ToCHWImage": None}, {"KeepKeys": {"keep_keys": ["image", "shape"]}}],
    [{"DetResizeForTest": {"resize_long": 320}},
     {"NormalizeImage": {"scale": 0.5, "order": "hwc"}},
     {"ToCHWImage": None}, {"KeepKeys": {"keep_keys": ["image", "shape"]}}],
    [{"DetResizeForTest": {"image_shape": [64, 96], "keep_ratio": True}},
     {"NormalizeImage": {"order": "hwc"}}, {"ToCHWImage": None},
     {"KeepKeys": {"keep_keys": ["image", "shape"]}}],
]


@pytest.mark.parametrize("config", range(len(_OPS)))
@pytest.mark.parametrize("hw", [(203, 157), (20, 30)])
def test_transform_equals_the_jax_shims(config, hw):
    """transform(create_operators(ops)) on a seeded page: the three resize
    modes (a tiny page padded first), a string scale, CHW, KeepKeys."""
    from onnxocr import imaug as jimaug
    from onnxocr_tpu_torch.onnxocr import imaug
    rng = np.random.default_rng(config * 7 + hw[0])
    img = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    ref = jimaug.transform({"image": img.copy()},
                           jimaug.create_operators(_OPS[config]))
    got = imaug.transform({"image": img.copy()},
                          imaug.create_operators(_OPS[config]))
    assert len(got) == len(ref) == 2
    assert got[0].shape == ref[0].shape and got[0].dtype == ref[0].dtype
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], ref[1])


def test_create_operators_refuses_as_the_jax_shim():
    from onnxocr import imaug as jimaug
    from onnxocr_tpu_torch.onnxocr import imaug, operators
    for bad, err in (({"NormalizeImage": {}}, TypeError),
                     ([{"Nope": {}}], KeyError),
                     ([{"A": {}, "B": {}}], ValueError)):
        for shim in (jimaug, imaug):
            with pytest.raises(err):
                shim.create_operators(bad)
    assert sorted(imaug.OP_REGISTRY) == sorted(jimaug.OP_REGISTRY)
    with pytest.raises(ValueError):  # no eval: a scale is arithmetic only
        operators.NormalizeImage(scale="__import__('os')")


def test_predict_base_session_on_the_named_device(tmp_path):
    """get_onnx_session gives the port's executor on the device named (the
    CPU here; CUDA by default), and the name helpers keep the reference's
    shapes; the outputs equal the JAX shim's session."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from onnx_builder import build_model, node_bytes
    from onnxocr.predict_base import PredictBase as JPredictBase
    from onnxocr_tpu_torch.onnxocr.predict_base import PredictBase
    w = np.random.default_rng(3).standard_normal((4, 3)).astype(np.float32)
    path = tmp_path / "g.onnx"
    path.write_bytes(build_model([node_bytes("MatMul", ["x", "w"], ["y"]),
                                  node_bytes("Relu", ["y"], ["z"])],
                                 ["x"], ["z"], {"w": w}))
    base, jbase = PredictBase(), JPredictBase()
    sess = base.get_onnx_session(str(path), use_gpu=True, device="cpu")
    jsess = jbase.get_onnx_session(str(path))
    assert base.get_input_name(sess) == jbase.get_input_name(jsess) == ["x"]
    assert base.get_output_name(sess) == jbase.get_output_name(jsess) == [
        "z"]
    x = np.random.default_rng(4).standard_normal((2, 4)).astype(np.float32)
    feed = base.get_input_feed(base.get_input_name(sess), x)
    assert list(feed) == ["x"]
    got = sess.run(None, feed)[0]
    ref = jsess.run(None, jbase.get_input_feed(["x"], x))[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            base.get_onnx_session(str(path))


def test_logger_is_a_working_logger():
    from onnxocr_tpu_torch.onnxocr.logger import GetLog, Logger
    log = GetLog("onnxocr-port-test")
    assert log is Logger("onnxocr-port-test").get() and log.handlers

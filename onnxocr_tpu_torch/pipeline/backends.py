"""Native checkpoint loading and its load-time adjustments. Port of the
parts of onnxocr_tpu/pipeline/backends.py the ported paths read:
the architecture of a stage, the committed `native_params.npz` beside a
stage's model path (or the family fallback), the det
`calibration.json` sidecar, the CTC-head decode-support mask read from
the committed `<dict>.trained_support.json` sidecar, and the angle
classifier's weight resolution.
"""
from __future__ import annotations

import glob
import json
import os
import warnings
from typing import Optional, Tuple

import numpy as np

from .. import config
from ..models import cls as cls_model
from ..utils.params_io import load_tree


def pick_arch(kind: str, model_path: str, algorithm: str = "") -> str:
    """SVTR vs CRNN rec, MobileNetV3 vs ResNet18-vd det (JAX rules)."""
    if kind == "rec":
        if "CRNN" in (algorithm or "") or "server" in (model_path or ""):
            return "crnn"
        return "svtr"
    return "resnet18" if "server" in (model_path or "") else "mbv3"


def load_native_params(kind: str, model_path: str, arch: str,
                       allow_untrained: bool = False
                       ) -> Tuple[dict, str, str]:
    """→ (parameter tree, npz path actually loaded, architecture) from
    <dir of model_path>/native_params.npz, resolved as the JAX package
    resolves a native det / rec stage: a missing mbv3 / svtr checkpoint
    falls back to the ppocrv5 family's of the same stage, and a missing
    server (resnet18) det checkpoint to the ppocrv5 mbv3 detector, each
    with a warning; the calibration sidecar follows the path loaded. The
    ONNX graph executor is not ported, so an existing .onnx model file
    cannot be run, and the seeded untrained init (`tpu_allow_untrained`)
    is not ported for det and rec."""
    if model_path and os.path.exists(model_path) and \
            model_path.endswith(".onnx"):
        raise NotImplementedError(
            f"{kind}: running an .onnx model ({model_path}) needs the graph "
            "executor, which is not ported; only native checkpoints run")
    path = os.path.join(os.path.dirname(model_path), "native_params.npz")
    if os.path.exists(path):
        return load_tree(path), path, arch
    fb = config.find_asset(f"ppocrv5/{kind}/native_params.npz")
    if arch in ("mbv3", "svtr") and os.path.exists(fb) and \
            os.path.abspath(fb) != os.path.abspath(path):
        warnings.warn(f"{kind}: no checkpoint at {path}; using the "
                      f"ppocrv5 family checkpoint {fb}")
        return load_tree(fb), fb, arch
    if kind == "det" and arch == "resnet18" and os.path.exists(fb):
        warnings.warn("det: no server (resnet18) checkpoint; falling back "
                      "to the trained mbv3 detector")
        return load_tree(fb), fb, "mbv3"
    if allow_untrained or \
            os.environ.get("ONNXOCR_TPU_ALLOW_UNTRAINED", "") in ("1", "true"):
        raise NotImplementedError(
            f"{kind}: the untrained {arch} init (tpu_allow_untrained) is "
            "not ported; only native checkpoints run")
    raise FileNotFoundError(f"{kind}: no native checkpoint at {path}")


def load_cls_params(model_path: str, allow_untrained: bool = False) -> dict:
    """The angle classifier's parameter tree, resolved as the reference
    does: a model file is lifted into the native model (`lift_cls`, not
    ported, so a present cls.onnx raises), else the native checkpoint beside
    it, else — only under `allow_untrained` or
    ONNXOCR_TPU_ALLOW_UNTRAINED=1 — the seeded untrained tree, with a
    warning. Without any of these it fails loudly."""
    allow_untrained = allow_untrained or \
        os.environ.get("ONNXOCR_TPU_ALLOW_UNTRAINED", "") in ("1", "true")
    if model_path and os.path.exists(model_path):
        raise NotImplementedError(
            f"cls: lifting {model_path} into the native classifier needs "
            "lift_cls and the ONNX reader, which are not ported")
    if model_path:
        path = os.path.join(os.path.dirname(model_path), "native_params.npz")
        if os.path.exists(path):
            return load_tree(path)
    if not allow_untrained:
        raise FileNotFoundError(
            f"cls: no weights found — neither a model file at "
            f"{model_path!r} nor a native checkpoint "
            "(native_params.npz) next to it. Stage assets (see "
            "tools/fetch_assets.py), train with "
            "tools/train_synthetic.py, or opt in to untrained "
            "weights with tpu_allow_untrained=True / "
            "ONNXOCR_TPU_ALLOW_UNTRAINED=1.")
    warnings.warn(
        f"cls: no weights at {model_path!r}; using randomly "
        "initialized native model (functional pipeline, untrained "
        "outputs).")
    return cls_model.init_tree(0)


def checkpoint_calibration(ckpt_path: str) -> dict:
    """Flag-name → value pairs from <ckpt dir>/calibration.json ({} if none
    or unreadable)."""
    cal = os.path.join(os.path.dirname(ckpt_path), "calibration.json")
    if not os.path.exists(cal):
        return {}
    try:
        with open(cal) as f:
            return dict(json.load(f))
    except (ValueError, OSError):
        return {}


def trained_support(dict_path: str) -> Optional[np.ndarray]:
    """Dictionary indices the native checkpoints were trained on (blank
    included), from the committed sidecar `<dict>.trained_support.json`
    next to the dictionary or, by the dictionary's file name, anywhere under
    the committed asset tree. None when there is no sidecar (no masking)."""
    candidates = [dict_path + ".trained_support.json"]
    candidates += sorted(glob.glob(os.path.join(
        str(config.ASSETS), "**",
        os.path.basename(dict_path) + ".trained_support.json"),
        recursive=True))
    for sidecar in candidates:
        if not os.path.exists(sidecar):
            continue
        try:
            with open(sidecar) as f:
                return np.asarray(sorted(set(json.load(f)["indices"]) | {0}),
                                  np.int64)
        except (ValueError, KeyError, OSError):
            continue
    return None


def apply_support_bias(params: dict, support: np.ndarray) -> dict:
    """b[v] −= 1e30 for vocab v outside the support: argmax never picks an
    untrained glyph and the max-prob renormalizes over the support."""
    head = params.get("head")
    if not isinstance(head, dict) or "b" not in head:
        return params
    b = np.asarray(head["b"], np.float32)
    mask = np.full(b.shape, -1e30, np.float32)
    mask[support[support < b.shape[0]]] = 0.0
    out = dict(params)
    out["head"] = dict(head)
    out["head"]["b"] = (b + mask).astype(np.asarray(head["b"]).dtype)
    return out

"""Backend resolution and the native checkpoints' load-time adjustments.
Port of onnxocr_tpu/pipeline/backends.py's `resolve_backend` and what it
reads: the architecture of a stage, the ONNX graph a stage may run
(`tpu_backend` 'graph', or 'auto' for a det / rec file that exists), the
angle classifier lifted from its graph (models/lift.py), the committed
`native_params.npz` beside a stage's model path (or the family fallback),
the seeded untrained init under `tpu_allow_untrained`, the det
`calibration.json` sidecar, the CTC-head decode-support mask read
from the committed `<dict>.trained_support.json` sidecar, and a stage's
compute dtype. The graph and
native forwards themselves are the stages' (pipeline/detector.py,
classifier.py, recognizer.py).
"""
from __future__ import annotations

import glob
import json
import os
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .. import config
from ..models import cls as cls_model
from ..models import crnn, dbnet, lift, svtr
from ..onnx import ir
from ..utils.params_io import load_tree


def pick_arch(kind: str, model_path: str, algorithm: str = "") -> str:
    """SVTR vs CRNN rec, MobileNetV3 vs ResNet18-vd det (JAX rules)."""
    if kind == "rec":
        if "CRNN" in (algorithm or "") or "server" in (model_path or ""):
            return "crnn"
        return "svtr"
    if kind == "det":
        return "resnet18" if "server" in (model_path or "") else "mbv3"
    return "mbv3"


def stage_dtype(backend: str, args, kind: str) -> torch.dtype:
    """The compute dtype of a stage ('det', 'cls' or 'rec'), by the JAX
    stages' rule: tpu_det_dtype, else tpu_dtype, for the det; tpu_dtype for
    the others; float32 for a graph, which ignores the dtype (its
    `resolve_backend` casts native trees only)."""
    name = (kind == "det" and getattr(args, "tpu_det_dtype", "")) or \
        getattr(args, "tpu_dtype", "float32")
    if backend == "native" and name == "bfloat16":
        return torch.bfloat16
    return torch.float32


def _native_checkpoint(model_path: str, kind: str, arch: str
                       ) -> Tuple[Optional[dict], str]:
    """<dir of model_path>/native_params.npz, else for an mbv3 / svtr
    det / rec stage the ppocrv5 family checkpoint of the stage (with a
    warning) → (tree or None, the npz path loaded or '')."""
    path = os.path.join(os.path.dirname(model_path), "native_params.npz")
    if os.path.exists(path):
        return load_tree(path), path
    if kind in ("det", "rec") and arch in ("mbv3", "svtr"):
        fb = config.find_asset(f"ppocrv5/{kind}/native_params.npz")
        if os.path.exists(fb) and os.path.abspath(fb) != os.path.abspath(path):
            warnings.warn(f"{kind}: no checkpoint at {path}; using the "
                          f"ppocrv5 family checkpoint {fb}")
            return load_tree(fb), fb
    return None, ""


def _untrained(kind: str, arch: str, vocab_size: int) -> dict:
    """The seeded (seed 0) untrained tree of a stage, equal to the JAX
    package's."""
    if kind == "det":
        return dbnet.init(0, backbone_arch=arch)
    if kind == "cls":
        return cls_model.init_tree(0)
    if arch == "crnn":
        return crnn.init(0, vocab_size)
    return svtr.init(0, vocab_size)


def _resolve(kind: str, model_path: str, requested: str, vocab_size: int,
             arch: str, allow_untrained: bool):
    """resolve_backend's branches → (backend, tree, arch, npz path loaded
    or '')."""
    allow_untrained = allow_untrained or \
        os.environ.get("ONNXOCR_TPU_ALLOW_UNTRAINED", "") in ("1", "true")
    have_file = bool(model_path) and os.path.exists(model_path)
    if requested == "graph" or (requested == "auto" and have_file
                                and kind != "cls"):
        if not have_file:
            raise FileNotFoundError(
                f"{kind} model not found: {model_path}. Stage the .onnx "
                "into onnxocr_tpu/assets/ (see tools/fetch_assets.py) or "
                "use tpu_backend='native'.")
        return "graph", None, arch, ""
    tree, ckpt = None, ""
    if have_file and kind == "cls":
        try:
            tree = lift.lift_cls(ir.load_model(model_path))
        except ValueError:
            # not a MobileNetV3-small-0.35 export: run the graph itself
            return "graph", None, arch, ""
    if tree is None and model_path:
        tree, ckpt = _native_checkpoint(model_path, kind, arch)
    if tree is None and kind == "det" and arch == "resnet18":
        # no trained server-det checkpoint: the trained mobile detector
        fb = config.find_asset("ppocrv5/det/native_params.npz")
        if os.path.exists(fb):
            warnings.warn("det: no server (resnet18) checkpoint; falling "
                          "back to the trained mbv3 detector")
            tree, ckpt, arch = load_tree(fb), fb, "mbv3"
    if tree is None:
        if requested != "native" and have_file:
            return "graph", None, arch, ""
        if not allow_untrained:
            raise FileNotFoundError(
                f"{kind}: no weights found — neither a model file at "
                f"{model_path!r} nor a native checkpoint "
                "(native_params.npz) next to it. Stage assets (see "
                "tools/fetch_assets.py), train with "
                "tools/train_synthetic.py, or opt in to untrained "
                "weights with tpu_allow_untrained=True / "
                "ONNXOCR_TPU_ALLOW_UNTRAINED=1.")
        tree = _untrained(kind, arch, vocab_size)
        warnings.warn(
            f"{kind}: no weights at {model_path!r}; using randomly "
            "initialized native model (functional pipeline, untrained "
            "outputs).")
    return "native", tree, arch, ckpt


def resolve_backend(kind: str, model_path: str, requested: str,
                    vocab_size: int = 0, arch: str = "mbv3",
                    allow_untrained: bool = False):
    """The backend of one stage (kind 'det', 'cls' or 'rec'), in the JAX
    package's branch order. `requested` ∈ {auto, native, graph}:

    * the ONNX graph when requested, or under auto for a det / rec file
      that exists (FileNotFoundError when 'graph' finds no file);
    * a cls file is lifted into the native classifier, or runs as a graph
      when it is not a MobileNetV3-small-0.35 export;
    * the native checkpoint beside the model path, the ppocrv5 family's
      for an mbv3 / svtr stage without one, the mbv3 detector for a
      server det without one;
    * the seeded untrained init, only under `allow_untrained` /
      ONNXOCR_TPU_ALLOW_UNTRAINED=1, where 'native' was requested or no
      file exists; otherwise the graph of an existing file, or
      FileNotFoundError.

    → (backend 'graph' | 'native', model_path, tree (None for a graph),
    arch, calibration): the calibration sidecar of the checkpoint loaded,
    empty for graph, lifted and untrained stages."""
    backend, tree, arch, ckpt = _resolve(kind, model_path, requested,
                                         vocab_size, arch, allow_untrained)
    return backend, model_path, tree, arch, checkpoint_calibration(ckpt)


def load_native_params(kind: str, model_path: str, arch: str,
                       allow_untrained: bool = False, vocab_size: int = 0
                       ) -> Tuple[dict, str, str]:
    """The native branches alone (tpu_backend='native') → (tree, npz path
    loaded or '', architecture)."""
    _, tree, arch, ckpt = _resolve(kind, model_path, "native", vocab_size,
                                   arch, allow_untrained)
    return tree, ckpt, arch


def checkpoint_calibration(ckpt_path: str) -> dict:
    """Flag-name → value pairs from <ckpt dir>/calibration.json ({} if no
    checkpoint, none or unreadable)."""
    if not ckpt_path:
        return {}
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

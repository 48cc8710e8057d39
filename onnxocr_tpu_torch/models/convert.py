"""JAX parameter trees → PyTorch state_dicts and built models.

The input is a nested dict/list of numpy arrays as utils/params_io.load_tree
returns it (or as the JAX `init()` functions build it). Each tensor of the
model is looked up by its module path (`mixer.3.qkv.weight` ↔
`mixer/#3/qkv/w`) and re-laid out by module type:

* Conv2d weight: HWIO → OIHW (depthwise (k, k, 1, C) → (C, 1, k, k));
* ConvTranspose2d weight: (2, 2, I, O) flipped on both spatial axes →
  (I, O, 2, 2) (JAX's conv_transpose does not flip the kernel, torch's
  transposed conv does);
* Linear weight: (in, out) → (out, in);
* LSTM (the CRNN's): the JAX (2, 4H, ·) stacks `wi`, `wh`, `b` split by
  direction into weight_ih_l0[_reverse], weight_hh_l0[_reverse] and
  bias_ih_l0[_reverse] as they are (same gate order i, f, g, o);
  bias_hh is zero (`build_crnn`);
* everything else (batch-norm and LayerNorm leaves, the CTC head's (D, V)
  w and (V,) b) as it is.

Every tree leaf must be used and every model tensor filled, with its shape.
`tree_from_model` is the inverse: a model's parameters (or their
gradients) → a tree in the JAX layout, each transform undone.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from . import cls, crnn, dbnet, svtr
from . import common as cm
from ..utils import params_io


def flatten(tree) -> Dict[str, np.ndarray]:
    """Tree → {'mixer/#3/qkv/w': numpy leaf, ...}."""
    return {k: np.asarray(v) for k, v in params_io.flatten(tree).items()}


def state_dict_from_tree(tree, model: nn.Module) -> Dict[str, torch.Tensor]:
    flat = flatten(tree)
    modules = dict(model.named_modules())
    sd: Dict[str, torch.Tensor] = {}
    for key, ref in model.state_dict().items():
        mod_name, _, leaf = key.rpartition(".")
        mod = modules[mod_name]
        path = "/".join("#" + p if p.isdigit() else p
                        for p in mod_name.split("."))
        layer = isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))
        jleaf = {"weight": "w", "bias": "b"}[leaf] if layer else leaf
        jkey = f"{path}/{jleaf}"
        if jkey not in flat:
            raise KeyError(f"checkpoint has no {jkey!r} for {key!r}")
        arr = flat.pop(jkey).astype(np.float32)
        if leaf == "weight" and isinstance(mod, nn.Conv2d):
            arr = arr.transpose(3, 2, 0, 1)
        elif leaf == "weight" and isinstance(mod, nn.ConvTranspose2d):
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
        elif leaf == "weight" and isinstance(mod, nn.Linear):
            arr = arr.T
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{jkey}: shape {arr.shape} does not fit "
                             f"{key} {tuple(ref.shape)}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    if flat:
        raise ValueError(f"unused checkpoint leaves: {sorted(flat)[:8]}")
    return sd


def _built(model: nn.Module, tree, device, dtype) -> nn.Module:
    """Load the tree, freeze, move, cast (`tree_cast`, the JAX backends'
    cast of a native stage's tree) and set inference mode."""
    model.load_state_dict(state_dict_from_tree(tree, model))
    return cm.tree_cast(model.requires_grad_(False).to(device).eval(), dtype)


def build_dbnet(tree, device="cpu", arch: str = "mbv3",
                dtype=torch.float32) -> dbnet.DBNet:
    """The DBNet on the `arch` backbone: 'mbv3' or 'resnet18'."""
    return _built(dbnet.DBNet(backbone_arch=arch), tree, device, dtype)


def build_cls(tree, device="cpu", dtype=torch.float32) -> cls.Cls:
    """The angle classifier, its class count from the `fc` linear."""
    return _built(cls.Cls(num_classes=tree["fc"]["w"].shape[1]), tree,
                  device, dtype)


def build_svtr(tree, device="cpu", dtype=torch.float32) -> svtr.SVTR:
    """SVTR sized from the tree: vocab and dim from the head, depth from the
    mixer list, channel width from the stem, MLP ratio from fc1. The head's
    kernel operand is split here, once, on `device`, after the cast."""
    dim, vocab = tree["head"]["w"].shape
    mixer = tree["mixer"]
    mlp_ratio = mixer[0]["fc1"]["w"].shape[1] // dim if mixer else 2
    width_mult = tree["stem"]["conv"]["w"].shape[-1] / 32.0
    model = _built(svtr.SVTR(vocab, dim=dim, depth=len(mixer),
                             width_mult=width_mult, mlp_ratio=mlp_ratio),
                   tree, device, dtype)
    model.head.prepare()
    return model


def _lstm_leaves(p: dict) -> Dict[str, np.ndarray]:
    """One JAX BiLSTM tree {wi, wh, b: (2, 4H, ·)} → nn.LSTM's leaves by
    name (direction 0 forward, 1 reverse); bias_hh is zero."""
    p = dict(p)
    wi, wh, b = p.pop("wi"), p.pop("wh"), p.pop("b")
    if p:
        raise ValueError(f"unused LSTM leaves: {sorted(p)}")
    out = {}
    for d, sfx in enumerate(("", "_reverse")):
        out[f"weight_ih_l0{sfx}"] = np.asarray(wi[d])
        out[f"weight_hh_l0{sfx}"] = np.asarray(wh[d])
        out[f"bias_ih_l0{sfx}"] = np.asarray(b[d])
        out[f"bias_hh_l0{sfx}"] = np.zeros_like(np.asarray(b[d]))
    return out


def build_crnn(tree, device="cpu", dtype=torch.float32) -> crnn.CRNN:
    """The CRNN, its vocabulary from the head."""
    tree = dict(tree, lstm1=_lstm_leaves(tree["lstm1"]),
                lstm2=_lstm_leaves(tree["lstm2"]))
    return _built(crnn.CRNN(vocab=tree["head"]["w"].shape[1]), tree, device,
                  dtype)


def tree_from_model(model: nn.Module, grads: bool = False):
    """The model's parameters (or, with `grads`, their gradients, None
    where a leaf has none) as a float32 numpy tree in the JAX layout: the
    inverse of `state_dict_from_tree` (OIHW → HWIO, the transposed conv's
    flip undone, (out, in) → (in, out) linears) and of `_lstm_leaves` (the
    two directions stacked; b = bias_ih + bias_hh, whose gradient is
    bias_ih's: the trainers keep bias_hh frozen at zero)."""
    modules = dict(model.named_modules())
    flat: Dict[str, np.ndarray] = {}
    lstm: Dict[str, Dict[str, np.ndarray]] = {}
    for key, p in model.named_parameters():
        t = p.grad if grads else p
        arr = None if t is None else np.array(t.detach().float().cpu())
        mod_name, _, leaf = key.rpartition(".")
        mod = modules[mod_name]
        path = "/".join("#" + q if q.isdigit() else q
                        for q in mod_name.split("."))
        if isinstance(mod, nn.LSTM):
            lstm.setdefault(path, {})[leaf] = arr
            continue
        layer = isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))
        jleaf = {"weight": "w", "bias": "b"}[leaf] if layer else leaf
        if arr is not None and leaf == "weight":
            if isinstance(mod, nn.Conv2d):
                arr = arr.transpose(2, 3, 1, 0)
            elif isinstance(mod, nn.ConvTranspose2d):
                arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
            elif isinstance(mod, nn.Linear):
                arr = arr.T
        flat[f"{path}/{jleaf}"] = None if arr is None else \
            np.ascontiguousarray(arr)
    for path, d in lstm.items():
        def both(name):
            return np.stack([d[f"{name}_l0"], d[f"{name}_l0_reverse"]])
        flat[f"{path}/wi"] = both("weight_ih")
        flat[f"{path}/wh"] = both("weight_hh")
        flat[f"{path}/b"] = both("bias_ih") if grads else \
            both("bias_ih") + both("bias_hh")
    return params_io.unflatten(flat)

"""Text-angle classifier (NCHW): MobileNetV3-small(0.35) → 2×2 max-pool →
global mean → linear → softmax over ["0", "180"]. Counterpart of
onnxocr_tpu/models/cls.py.

`init_tree(seed)` is the port's own copy of the reference's `cls.init`: it
draws the same numpy stream (seeded generators spawned in the same order,
He-normal conv kernels, normal(0, sqrt(1/cin)) linear weights), so the
untrained classifier has the same weights on both sides.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import common as cm
from . import mobilenetv3 as mbv3


class Cls(nn.Module):
    def __init__(self, num_classes: int = 2):
        super().__init__()
        self.backbone = mbv3.MobileNetV3("small", 0.35)
        self.fc = nn.Linear(self.backbone.last.conv.out_channels,
                            num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, 3, 48, 192) in [−1, 1] → (N, 2) softmax probabilities."""
        f = self.backbone(x)[-1]
        f = F.max_pool2d(f, 2, 2)
        return torch.softmax(self.fc(f.mean(dim=(2, 3))), dim=-1)


# ----------------------------------------------------------- seeded weights
def _rng(rng) -> np.random.Generator:
    if isinstance(rng, np.random.Generator):
        return rng
    return np.random.default_rng(int(rng))


def _conv_init(rng, k: int, cin: int, cout: int, groups: int = 1,
               bias: bool = False) -> Dict[str, Any]:
    std = math.sqrt(2.0 / (k * k * cin // groups))
    p = {"w": _rng(rng).normal(0.0, std, (k, k, cin // groups, cout))
         .astype(np.float32)}
    if bias:
        p["b"] = np.zeros((cout,), np.float32)
    return p


def _convbn_init(rng, k: int, cin: int, cout: int, groups: int = 1):
    return {"conv": _conv_init(rng, k, cin, cout, groups),
            "bn": {"scale": np.ones((cout,), np.float32),
                   "bias": np.zeros((cout,), np.float32),
                   "mean": np.zeros((cout,), np.float32),
                   "var": np.ones((cout,), np.float32)}}


def _se_init(rng, c: int):
    r1, r2 = _rng(rng).spawn(2)
    return {"reduce": _conv_init(r1, 1, c, c // 4, bias=True),
            "expand": _conv_init(r2, 1, c // 4, c, bias=True)}


def _backbone_init(rng, cfg_name: str, scale: float) -> Dict[str, Any]:
    table, last_ch = mbv3.CONFIGS[cfg_name]
    cfg = mbv3.scaled_cfg(table, scale)
    stem_ch = cm.make_divisible(16 * scale)
    # generators are taken in order (a block without SE takes three of its
    # four); the last conv takes the final one
    spawned = _rng(rng).spawn(4 * len(cfg) + 2)
    keys = iter(spawned)
    params: Dict[str, Any] = {
        "stem": _convbn_init(next(keys), 3, 3, stem_ch), "blocks": []}
    cin = stem_ch
    for k, exp, cout, se, _act, _s in cfg:
        blk = {"expand": _convbn_init(next(keys), 1, cin, exp),
               "dw": _convbn_init(next(keys), k, exp, exp, groups=exp),
               "project": _convbn_init(next(keys), 1, exp, cout)}
        if se:
            blk["se"] = _se_init(next(keys), exp)
        params["blocks"].append(blk)
        cin = cout
    params["last"] = _convbn_init(spawned[-1], 1, cin,
                                  cm.make_divisible(last_ch * scale))
    return params


def init_tree(seed=0, num_classes: int = 2) -> Dict[str, Any]:
    """Seeded parameter tree in the reference's layout (HWIO conv kernels,
    (in, out) linear), equal leaf for leaf to the reference's cls.init(seed)."""
    r1, r2 = _rng(seed).spawn(2)
    backbone = _backbone_init(r1, "small", 0.35)
    last_ch = backbone["last"]["conv"]["w"].shape[-1]
    std = math.sqrt(1.0 / last_ch)
    return {"backbone": backbone,
            "fc": {"w": _rng(r2).normal(0.0, std, (last_ch, num_classes))
                   .astype(np.float32),
                   "b": np.zeros((num_classes,), np.float32)}}

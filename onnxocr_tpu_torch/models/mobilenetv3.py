"""MobileNetV3 backbone (NCHW), PaddleOCR channel scheme. Counterpart of
onnxocr_tpu/models/mobilenetv3.py: `large` at scale 0.5 with square strides
is the det backbone (feature taps for the DB FPN); `small` at scale 0.35
with height-only (2, 1) strides and a 576-wide last conv is the angle
classifier's.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch.nn as nn

from . import common as cm

# (kernel, expand, out, use_se, act, (stride_h, stride_w))
SMALL_CFG = [
    (3, 16, 16, True, "relu", (2, 1)),
    (3, 72, 24, False, "relu", (2, 1)),
    (3, 88, 24, False, "relu", (1, 1)),
    (5, 96, 40, True, "hswish", (2, 1)),
    (5, 240, 40, True, "hswish", (1, 1)),
    (5, 240, 40, True, "hswish", (1, 1)),
    (5, 120, 48, True, "hswish", (1, 1)),
    (5, 144, 48, True, "hswish", (1, 1)),
    (5, 288, 96, True, "hswish", (2, 1)),
    (5, 576, 96, True, "hswish", (1, 1)),
    (5, 576, 96, True, "hswish", (1, 1)),
]

LARGE_CFG = [
    (3, 16, 16, False, "relu", (1, 1)),
    (3, 64, 24, False, "relu", (2, 2)),
    (3, 72, 24, False, "relu", (1, 1)),
    (5, 72, 40, True, "relu", (2, 2)),
    (5, 120, 40, True, "relu", (1, 1)),
    (5, 120, 40, True, "relu", (1, 1)),
    (3, 240, 80, False, "hswish", (2, 2)),
    (3, 200, 80, False, "hswish", (1, 1)),
    (3, 184, 80, False, "hswish", (1, 1)),
    (3, 184, 80, False, "hswish", (1, 1)),
    (3, 480, 112, True, "hswish", (1, 1)),
    (3, 672, 112, True, "hswish", (1, 1)),
    (5, 672, 160, True, "hswish", (2, 2)),
    (5, 960, 160, True, "hswish", (1, 1)),
    (5, 960, 160, True, "hswish", (1, 1)),
]
# config name → (block table, width of the last conv before scaling)
CONFIGS = {"small": (SMALL_CFG, 576), "large": (LARGE_CFG, 960)}


def scaled_cfg(cfg, scale: float):
    return [(k, cm.make_divisible(exp * scale), cm.make_divisible(c * scale),
             se, act, s) for k, exp, c, se, act, s in cfg]


def init(rng, cfg_name: str = "small", scale: float = 0.35,
         in_ch: int = 3) -> Dict[str, Any]:
    """Seeded tree of the JAX package's `mobilenetv3.init`: one generator a
    layer, spawned in layer order (a block without SE takes three of its
    four; the last conv takes the final one)."""
    table, last_ch = CONFIGS[cfg_name]
    cfg = scaled_cfg(table, scale)
    stem_ch = cm.make_divisible(16 * scale)
    keys = cm.split_rng(rng, 4 * len(cfg) + 2)
    ki = iter(keys)
    params: Dict[str, Any] = {
        "stem": cm.convbn_init(next(ki), 3, in_ch, stem_ch), "blocks": []}
    cin = stem_ch
    for k, exp, cout, se, _act, _s in cfg:
        blk = {"expand": cm.convbn_init(next(ki), 1, cin, exp),
               "dw": cm.convbn_init(next(ki), k, exp, exp, groups=exp),
               "project": cm.convbn_init(next(ki), 1, exp, cout)}
        if se:
            blk["se"] = cm.se_init(next(ki), exp)
        params["blocks"].append(blk)
        cin = cout
    params["last"] = cm.convbn_init(keys[-1], 1, cin,
                                    cm.make_divisible(last_ch * scale))
    return params


class Block(nn.Module):
    def __init__(self, cin, k, exp, cout, se, act, stride):
        super().__init__()
        self.expand = cm.ConvBN(1, cin, exp, act=act)
        self.dw = cm.ConvBN(k, exp, exp, stride=stride, groups=exp, act=act)
        self.se = cm.SE(exp, exp // 4) if se else None
        self.project = cm.ConvBN(1, exp, cout)
        self.residual = tuple(stride) == (1, 1) and cin == cout


class MobileNetV3(nn.Module):
    def __init__(self, cfg_name: str = "large", scale: float = 0.5):
        super().__init__()
        table, last_ch = CONFIGS[cfg_name]
        self.cfg = scaled_cfg(table, scale)
        stem_ch = cm.make_divisible(16 * scale)
        self.stem = cm.ConvBN(3, 3, stem_ch, stride=2, act="hswish")
        blocks = []
        cin = stem_ch
        for k, exp, cout, se, act, s in self.cfg:
            blocks.append(Block(cin, k, exp, cout, se, act, s))
            cin = cout
        self.blocks = nn.ModuleList(blocks)
        self.last = cm.ConvBN(1, cin, cm.make_divisible(last_ch * scale),
                              act="hswish")

    def forward(self, x, feature_taps: Sequence[int] = (),
                valid_hw: Optional[tuple] = None) -> List:
        """x (N, 3, H, W) → the block inputs at `feature_taps` plus the
        post-`last` map. valid_hw = (vh, vw) valid extent at input
        resolution, ints or (N,) int tensors (one extent per sample): every
        stage is re-zeroed beyond ceil(v / stride) and the SE pools see only
        that region (JAX mobilenetv3.apply)."""

        def strided(sh, sw):
            if valid_hw is None:
                return None
            return (valid_hw[0] + sh - 1) // sh, (valid_hw[1] + sw - 1) // sw

        def mask(x, sh, sw):
            if valid_hw is None:
                return x
            return cm.mask_valid_(x, *strided(sh, sw))

        x = mask(self.stem(x), 2, 2)
        sh = sw = 2                      # cumulative stride after the stem
        feats = []
        for i, blk in enumerate(self.blocks):
            if i in feature_taps:
                feats.append(x)
            y = blk.expand(x)
            y = blk.dw(y)
            sh, sw = sh * blk.dw.conv.stride[0], sw * blk.dw.conv.stride[1]
            if blk.se is not None:
                y = blk.se(y, strided(sh, sw))
            y = blk.project(y)
            if blk.residual:
                y = y + x
            x = mask(y, sh, sw)
        x = mask(self.last(x), sh, sw)
        feats.append(x)
        return feats

"""ResNet18-vd backbone (NCHW) of the ch_ppocr_server_v2.0 detector.
Counterpart of onnxocr_tpu/models/resnet.py (`apply`, depth 18).

The -vd form: a stem of three 3×3 ConvBN + ReLU (the first with stride 2),
then a 2×2/2 max pool (VALID; the JAX docstring says 3×3, its code pools
2×2), then four stages of basic blocks whose downsampling shortcut is a
2×2/2 average pool (VALID) followed by a 1×1 ConvBN where the channel
count changes. Module names mirror the JAX tree (`stem/#i/...`,
`stages/#s/#b/{conv1,conv2,short}/...`).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import common as cm

DEPTHS = (2, 2, 2, 2)
STAGE_CH = (64, 128, 256, 512)


def init(rng, in_ch: int = 3) -> Dict[str, Any]:
    """Seeded tree of the JAX package's `resnet.init(rng, 18)`. SkipInit:
    each block's `conv2` BN scale is zero, so every block starts as the
    identity."""
    keys = iter(cm.split_rng(rng, 3 + 2 * sum(DEPTHS) * 2 + 8))
    p: Dict[str, Any] = {
        "stem": [cm.convbn_init(next(keys), 3, in_ch, 32),
                 cm.convbn_init(next(keys), 3, 32, 32),
                 cm.convbn_init(next(keys), 3, 32, 64)],
        "stages": []}
    cin = 64
    for n_blocks, cout in zip(DEPTHS, STAGE_CH):
        stage = []
        for _ in range(n_blocks):
            blk = {"conv1": cm.convbn_init(next(keys), 3, cin, cout),
                   "conv2": cm.convbn_init(next(keys), 3, cout, cout)}
            blk["conv2"]["bn"]["scale"] = np.zeros((cout,), np.float32)
            if cin != cout:
                blk["short"] = cm.convbn_init(next(keys), 1, cin, cout)
            stage.append(blk)
            cin = cout
        p["stages"].append(stage)
    return p


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = cm.ConvBN(3, cin, cout, stride, act="relu")
        self.conv2 = cm.ConvBN(3, cout, cout)
        self.short = cm.ConvBN(1, cin, cout) if cin != cout else None

    def forward(self, x):
        short = x
        if self.stride != 1:
            short = F.avg_pool2d(short, 2, 2)
        if self.short is not None:
            short = self.short(short)
        return cm.relu(self.conv2(self.conv1(x)) + short)


class ResNet18vd(nn.Module):
    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.stem = nn.ModuleList([
            cm.ConvBN(3, in_ch, 32, 2, act="relu"),
            cm.ConvBN(3, 32, 32, act="relu"),
            cm.ConvBN(3, 32, 64, act="relu")])
        stages = []
        cin = 64
        for si, (n_blocks, cout) in enumerate(zip(DEPTHS, STAGE_CH)):
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if si > 0 and bi == 0 else 1
                blocks.append(BasicBlock(cin, cout, stride))
                cin = cout
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (N, 3, H, W) → the four stage outputs at 1/4, 1/8, 1/16,
        1/32."""
        for conv in self.stem:
            x = conv(x)
        x = F.max_pool2d(x, 2, 2)
        feats = []
        for stage in self.stages:
            for blk in stage:
                x = blk(x)
            feats.append(x)
        return feats

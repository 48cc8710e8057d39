"""Text-angle classifier (NCHW): MobileNetV3-small(0.35) → 2×2 max-pool →
global mean → linear → softmax over ["0", "180"]. Counterpart of
onnxocr_tpu/models/cls.py.

`init_tree(seed)` is the port's own copy of the reference's `cls.init`: it
draws the same numpy stream (models/common.py's seeded init helpers), so
the untrained classifier has the same weights on both sides.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import common as cm
from . import mobilenetv3 as mbv3


class Cls(nn.Module):
    def __init__(self, num_classes: int = 2):
        super().__init__()
        self.backbone = mbv3.MobileNetV3("small", 0.35)
        self.fc = cm.Linear(self.backbone.last.conv.out_channels,
                            num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, 3, 48, 192) in [−1, 1] → (N, 2) softmax probabilities."""
        f = self.backbone(x)[-1]
        f = F.max_pool2d(f, 2, 2)
        return torch.softmax(self.fc(f.mean(dim=(2, 3))), dim=-1)


def init_tree(seed=0, num_classes: int = 2) -> Dict[str, Any]:
    """Seeded parameter tree in the reference's layout (HWIO conv kernels,
    (in, out) linear), equal leaf for leaf to the reference's cls.init(seed)."""
    r1, r2 = cm.split_rng(seed, 2)
    backbone = mbv3.init(r1, "small", 0.35)
    last_ch = backbone["last"]["conv"]["w"].shape[-1]
    return {"backbone": backbone,
            "fc": cm.linear_init(r2, last_ch, num_classes)}

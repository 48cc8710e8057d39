"""DBNet text detector (NCHW): a MobileNetV3-large (the PP-OCR mobile
families) or ResNet18-vd (ch_ppocr_server_v2.0) backbone + DB FPN +
binarization head. Counterpart of onnxocr_tpu/models/dbnet.py.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from . import common as cm
from . import mobilenetv3 as mbv3
from . import resnet

# backbone taps at 1/4, 1/8, 1/16; the post-`last` map is 1/32
_TAPS = (3, 6, 12)


def init(rng, scale: float = 0.5, inner: int = 96, out: int = 24,
         backbone_arch: str = "mbv3") -> Dict[str, Any]:
    """Seeded tree of the JAX package's `dbnet.init` (16 generators: the
    backbone, 5 laterals, smooth convs from the 7th, the head's conv and
    two transposed convs)."""
    keys = cm.split_rng(rng, 16)
    if backbone_arch == "resnet18":
        backbone = resnet.init(keys[0])
        in_chs = list(resnet.STAGE_CH)
    else:
        backbone = mbv3.init(keys[0], "large", scale)
        cfg = mbv3.scaled_cfg(mbv3.LARGE_CFG, scale)
        in_chs = [cfg[i - 1][2] for i in _TAPS] + \
            [backbone["last"]["conv"]["w"].shape[-1]]
    p: Dict[str, Any] = {"backbone": backbone}
    p["lateral"] = [cm.conv_init(keys[1 + i], 1, c, inner)
                    for i, c in enumerate(in_chs)]
    p["smooth"] = [cm.conv_init(keys[6 + i], 3, inner, out)
                   for i in range(4)]
    p["head"] = {
        "conv": cm.convbn_init(keys[11], 3, out * 4, out),
        "up1": {"w": cm.as_rng(keys[12]).normal(0, 0.1, (2, 2, out, out))
                .astype(np.float32), "b": np.zeros((out,), np.float32)},
        "bn1": cm.bn_init(out),
        "up2": {"w": cm.as_rng(keys[13]).normal(0, 0.1, (2, 2, out, 1))
                .astype(np.float32), "b": np.zeros((1,), np.float32)},
    }
    return p


class DBNet(nn.Module):
    def __init__(self, scale: float = 0.5, inner: int = 96, out: int = 24,
                 backbone_arch: str = "mbv3"):
        super().__init__()
        self.arch = backbone_arch
        if backbone_arch == "resnet18":
            self.backbone = resnet.ResNet18vd()
            in_chs = list(resnet.STAGE_CH)
        elif backbone_arch == "mbv3":
            self.backbone = mbv3.MobileNetV3("large", scale)
            cfg = self.backbone.cfg
            in_chs = [cfg[i - 1][2] for i in _TAPS] + \
                [self.backbone.last.conv.out_channels]
        else:
            raise ValueError(f"unknown det backbone {backbone_arch!r}")
        self.lateral = nn.ModuleList(
            [cm.conv(1, c, inner) for c in in_chs])
        self.smooth = nn.ModuleList(
            [cm.conv(3, inner, out) for _ in range(4)])
        self.head = nn.Module()
        self.head.conv = cm.ConvBN(3, out * 4, out, act="relu")
        self.head.up1 = cm.ConvTranspose2d(out, out, 2, stride=2)
        self.head.bn1 = cm.BatchNorm(out)
        self.head.up2 = cm.ConvTranspose2d(out, 1, 2, stride=2)

    def forward(self, x: torch.Tensor,
                valid_hw: Optional[tuple] = None) -> torch.Tensor:
        """x (N, 3, H, W) ImageNet-normalized → (N, H, W) shrink-prob map.
        valid_hw = (vh, vw), ints or (N,) int tensors (one extent per
        sample), makes the map over the valid region independent of the
        canvas padding (JAX dbnet.apply). The ResNet backbone ignores
        valid_hw, as the JAX package's does: its map depends on the
        canvas."""
        if self.arch == "resnet18":
            valid_hw = None
            feats = self.backbone(x)
        else:
            if valid_hw is not None:
                x = cm.mask_valid_(x.clone(), *valid_hw)
            feats = self.backbone(x, _TAPS, valid_hw)
        lat = [conv(f) for f, conv in zip(feats, self.lateral)]
        for i in range(len(lat) - 1, 0, -1):
            up = lat[i]
            while up.shape[2] < lat[i - 1].shape[2]:
                up = cm.upsample_nearest_2x(up)
            lat[i - 1] = lat[i - 1] + up
        outs = [conv(f) for f, conv in zip(lat, self.smooth)]
        ups = []
        for o in outs:
            while o.shape[2] < outs[0].shape[2]:
                o = cm.upsample_nearest_2x(o)
            ups.append(o)
        fused = torch.cat(ups, dim=1)
        if valid_hw is not None:
            cm.mask_valid_(fused, (valid_hw[0] + 3) // 4,
                           (valid_hw[1] + 3) // 4)
        h = self.head
        y = h.conv(fused)
        y = cm.relu(h.bn1(h.up1(y)))
        return torch.sigmoid(h.up2(y)[:, 0])

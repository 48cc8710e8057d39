"""NCHW building blocks for the ported models.

Counterpart of onnxocr_tpu/models/common.py. Module and parameter names
mirror the JAX parameter trees (`conv/w` → `conv.weight`, `bn/scale` →
`bn.scale`, ...) so models/convert.py can map a checkpoint onto a model by
name. Arithmetic follows the JAX forms where PyTorch's built-ins differ:
hardsigmoid is clip(0.2x + 0.5) (ONNX's default, not torch's x/6 + 0.5),
batch norm is x·inv + (bias − mean·inv) with eps 1e-5, convolutions pad
k//2 on both sides, and the 2x transposed conv takes the JAX kernel flipped
on both spatial axes (models/convert.py does the flip).

The seeded init helpers (`as_rng` … `linear_init`) build numpy parameter
trees in the JAX layout (HWIO conv kernels, (in, out) linear weights) from
the same numpy streams as the JAX package's (`default_rng`, `spawn` in the
same order), so that every `init` of the port gives the JAX package's tree
leaf for leaf.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def make_divisible(v: float, divisor: int = 8, min_value=None) -> int:
    """Channel rounding used by the MobileNetV3 family (PaddleOCR scheme)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# ------------------------------------------------------------------ init
def as_rng(rng) -> np.random.Generator:
    """An int seed or a numpy Generator → a Generator."""
    if isinstance(rng, np.random.Generator):
        return rng
    return np.random.default_rng(int(rng))


def split_rng(rng, n: int):
    return as_rng(rng).spawn(n)


def conv_init(rng, k: int, cin: int, cout: int, groups: int = 1,
              bias: bool = False) -> Dict[str, Any]:
    """He-normal (k, k, cin / groups, cout) kernel, zero bias."""
    std = math.sqrt(2.0 / (k * k * cin // groups))
    p = {"w": as_rng(rng).normal(0.0, std, (k, k, cin // groups, cout))
         .astype(np.float32)}
    if bias:
        p["b"] = np.zeros((cout,), np.float32)
    return p


def bn_init(c: int) -> Dict[str, Any]:
    return {"scale": np.ones((c,), np.float32),
            "bias": np.zeros((c,), np.float32),
            "mean": np.zeros((c,), np.float32),
            "var": np.ones((c,), np.float32)}


def convbn_init(rng, k: int, cin: int, cout: int, groups: int = 1):
    return {"conv": conv_init(rng, k, cin, cout, groups), "bn": bn_init(cout)}


def se_init(rng, c: int, mid: Optional[int] = None) -> Dict[str, Any]:
    mid = c // 4 if mid is None else mid
    r1, r2 = split_rng(rng, 2)
    return {"reduce": conv_init(r1, 1, c, mid, bias=True),
            "expand": conv_init(r2, 1, mid, c, bias=True)}


def linear_init(rng, cin: int, cout: int) -> Dict[str, Any]:
    """normal(0, sqrt(1 / cin)) (cin, cout) weight, zero bias."""
    return {"w": as_rng(rng).normal(0.0, math.sqrt(1.0 / cin), (cin, cout))
            .astype(np.float32),
            "b": np.zeros((cout,), np.float32)}


def hardswish(x):
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hardsigmoid(x, alpha: float = 0.2, beta: float = 0.5):
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


ACTS = {
    "relu": torch.relu,
    "hswish": hardswish,
    "none": lambda x: x,
}


class BatchNorm(nn.Module):
    """Inference batch norm with the JAX tree's names (scale, bias, mean,
    var) and arithmetic."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        inv = self.scale * torch.rsqrt(self.var + self.eps)
        shift = self.bias - self.mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


def conv(k: int, cin: int, cout: int, stride=1, groups: int = 1,
         bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     groups=groups, bias=bias)


class ConvBN(nn.Module):
    def __init__(self, k: int, cin: int, cout: int, stride=1,
                 groups: int = 1, act: str = "none"):
        super().__init__()
        self.conv = conv(k, cin, cout, stride, groups)
        self.bn = BatchNorm(cout)
        self.act = ACTS[act]

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


def _valid_mask(x, vh, vw):
    """(N, 1, H, W) bool mask of each sample's (vh (N,), vw (N,)) valid
    region of x (N, C, H, W)."""
    rows = torch.arange(x.shape[2], device=x.device) < vh[:, None]
    cols = torch.arange(x.shape[3], device=x.device) < vw[:, None]
    return rows[:, None, :, None] & cols[:, None, None, :]


def mask_valid_(x, vh, vw):
    """Zero x (N, C, H, W) beyond the (vh, vw) valid region IN PLACE (the
    callers pass intermediates they own) and return it. vh, vw: ints shared
    by every sample, or (N,) int tensors, one extent per sample (JAX
    `mask_valid`)."""
    if isinstance(vh, torch.Tensor):
        return x.masked_fill_(~_valid_mask(x, vh, vw), 0)
    if vh < x.shape[2]:
        x[:, :, vh:] = 0
    if vw < x.shape[3]:
        x[:, :, :, vw:] = 0
    return x


class SE(nn.Module):
    """Squeeze-and-excitation with the global pool restricted to the valid
    region (JAX `se_module` with valid_hw): ints, or (N,) int tensors of
    per-sample extents. A sample with no valid pixel (a padding row of a
    batched wave, extent 0) pools to 0: the area is clamped to 1."""

    def __init__(self, c: int, mid: int):
        super().__init__()
        self.reduce = nn.Conv2d(c, mid, 1, bias=True)
        self.expand = nn.Conv2d(mid, c, 1, bias=True)

    def forward(self, x, valid_hw=None):
        if valid_hw is None:
            s = x.mean(dim=(2, 3), keepdim=True)
        elif isinstance(valid_hw[0], torch.Tensor):
            vh, vw = valid_hw
            m = _valid_mask(x, vh, vw).to(x.dtype)
            area = torch.clamp(vh * vw, min=1).to(x.dtype)
            s = (x * m).sum(dim=(2, 3), keepdim=True) / \
                area[:, None, None, None]
        else:
            vh, vw = valid_hw
            s = x[:, :, :vh, :vw].sum(dim=(2, 3), keepdim=True) / \
                max(vh * vw, 1)
        s = torch.relu(self.reduce(s))
        s = hardsigmoid(self.expand(s))
        return x * s


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d), requires_grad=False)

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.square(x - mean).mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + \
            self.bias


def upsample_nearest_2x(x):
    return F.interpolate(x, scale_factor=2.0, mode="nearest")

"""NCHW building blocks for the ported models.

Counterpart of onnxocr_tpu/models/common.py. Module and parameter names
mirror the JAX parameter trees (`conv/w` → `conv.weight`, `bn/scale` →
`bn.scale`, ...) so models/convert.py can map a checkpoint onto a model by
name. Arithmetic follows the JAX forms where PyTorch's built-ins differ:
hardsigmoid is clip(0.2x + 0.5) (ONNX's default, not torch's x/6 + 0.5),
batch norm is x·inv + (bias − mean·inv) with eps 1e-5, convolutions pad
k//2 on both sides, and the 2x transposed conv takes the JAX kernel flipped
on both spatial axes (models/convert.py does the flip).

Dtypes follow the JAX forms too. A layer casts its weight to the input's
dtype and multiplies in float32 (the JAX layers' `preferred_element_type`:
a bfloat16 × bfloat16 product accumulated in float32 is the float32 product
of the two operands), then adds its bias by type promotion; batch norm
folds its four leaves in float32; everything else promotes as PyTorch does
(bfloat16 with float32 → float32). So under `tree_cast(model,
torch.bfloat16)` with bfloat16 inputs (inference at tpu_dtype='bfloat16'),
the first layer reads bfloat16 operands and every activation after it is
float32; with float32 parameters and bfloat16 inputs (the trainers' dtype)
only the first layer's weight is rounded, as in JAX. Every JAX tree leaf,
batch-norm `mean` and `var` included, is a parameter: optax trains them
all.

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


class _Clip(torch.autograd.Function):
    """torch.clamp with the derivative of JAX's clip (maximum, then
    minimum): 1 inside, ½ on a bound (lax.max and lax.min split a tie), 0
    outside. The ties are common where it matters: a ReLU sees exact zeros
    wherever a whole receptive field was zeroed by the ReLU before it."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = x > lo if hi is None else (x > lo) & (x < hi)
        tie = x == lo if hi is None else (x == lo) | (x == hi)
        return g * (inside.to(g.dtype) + 0.5 * tie.to(g.dtype)), None, None


def clip(x, lo: float, hi: Optional[float] = None):
    """jnp.clip(x, lo, hi) (no upper bound when hi is None), its gradient
    included."""
    return _Clip.apply(x, lo, hi)


def relu(x):
    """jnp.maximum(x, 0), its gradient included (½ at 0)."""
    return _Clip.apply(x, 0.0, None)


def hardswish(x):
    return x * clip(x / 6.0 + 0.5, 0.0, 1.0)


def hardsigmoid(x, alpha: float = 0.2, beta: float = 0.5):
    return clip(alpha * x + beta, 0.0, 1.0)


ACTS = {
    "relu": relu,
    "hswish": hardswish,
    "none": lambda x: x,
}


class BatchNorm(nn.Module):
    """Inference batch norm (no batch statistics) with the JAX tree's names
    (scale, bias, mean, var) and arithmetic. The leaves are folded into a
    scale and a shift in float32 whatever their dtype: the JAX jaxpr types
    that fold bfloat16 under tree_cast, but XLA computes the scale and shift
    in float32 inside the fusion that applies them (its default excess
    precision), rounding only what it materialises between fusions; JAX's
    jit and eager runs of one bfloat16 BN differ by a bfloat16 ulp of the
    scale. The float32 fold is the nearer of the two forms to JAX's jitted
    output (tests/test_torch_bf16.py)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)
        self.mean = nn.Parameter(torch.zeros(c), requires_grad=False)
        self.var = nn.Parameter(torch.ones(c), requires_grad=False)

    def forward(self, x):
        inv = self.scale.float() * torch.rsqrt(self.var.float() + self.eps)
        shift = self.bias.float() - self.mean.float() * inv
        return x * inv[:, None, None] + shift[:, None, None]


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float()


class Conv2d(nn.Conv2d):
    """nn.Conv2d with the JAX `conv2d`'s dtypes: the weight cast to the
    input's dtype, the product and the bias in float32."""

    def forward(self, x):
        return F.conv2d(x.float(), self.weight.to(x.dtype).float(),
                        _f32(self.bias), self.stride, self.padding,
                        self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d with the weight cast to the input's dtype (JAX
    `conv_transpose2x`; the DB head calls it on float32 activations only,
    so its float32 product is the JAX one)."""

    def forward(self, x):
        return F.conv_transpose2d(x.float(), self.weight.to(x.dtype).float(),
                                  _f32(self.bias), self.stride)


class Linear(nn.Linear):
    """nn.Linear with the JAX `linear`'s dtypes: the weight cast to the
    input's dtype, the product and the bias in float32."""

    def forward(self, x):
        return F.linear(x.float(), self.weight.to(x.dtype).float(),
                        _f32(self.bias))


def conv(k: int, cin: int, cout: int, stride=1, groups: int = 1,
         bias: bool = False) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                  groups=groups, bias=bias)


def tree_cast(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter (every JAX tree leaf) of `model` to
    `dtype` in place (JAX `tree_cast` over the parameter tree) and return
    it. A float32 copy made from the parameters (the CTC head's kernel
    operand) is made again after the cast by its owner."""
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return model


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
    `mask_valid`). Only the inference forwards mask (the trainers pass no
    valid extent, as JAX's do), so autograd never records the write."""
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
        self.reduce = Conv2d(c, mid, 1, bias=True)
        self.expand = Conv2d(mid, c, 1, bias=True)

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
        s = relu(self.reduce(s))
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

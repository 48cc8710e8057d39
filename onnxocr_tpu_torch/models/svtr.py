"""SVTR-LCNet-style CTC recognizer (NCHW convs, (N, T, D) mixer).
Counterpart of onnxocr_tpu/models/svtr.py.

Input (N, 3, 48, W) in [-1, 1], W a multiple of 8; `features` returns the
(N, W/8, D) pre-head sequence. The CTC head keeps w (D, V) in the JAX
layout and, once `Head.prepare` has run, the operand the fused head kernel
reads (ops/kernels/ctc_head.split_head). Attention heads are D // 32, LayerNorm eps 1e-6, GELU the tanh approximation (jax.nn.gelu's
default).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import common as cm
from ..ops.kernels import ctc_head

# (out_ch, (stride_h, stride_w)) depthwise-separable stages after the stem
STAGES = ((64, (2, 1)), (64, (1, 1)), (128, (2, 2)), (128, (1, 1)),
          (256, (2, 1)), (256, (1, 1)))


def init(rng, vocab_size: int, dim: int = 192, depth: int = 2,
         width_mult: float = 1.0, mlp_ratio: int = 2) -> Dict[str, Any]:
    """Seeded tree of the JAX package's `svtr.init` (its defaults: dim 192,
    2 mixer blocks, MLP ratio 2)."""
    keys = iter(cm.split_rng(rng, 8 + 2 * len(STAGES) + 6 * depth))

    def ch(c):
        return int(round(c * width_mult / 8) * 8) or 8

    def ln():
        return {"scale": np.ones((dim,), np.float32),
                "bias": np.zeros((dim,), np.float32)}

    p: Dict[str, Any] = {"stem": cm.convbn_init(next(keys), 3, 3, ch(32)),
                         "stages": []}
    cin = ch(32)
    for cout, _s in STAGES:
        p["stages"].append({
            "dw": cm.convbn_init(next(keys), 3, cin, cin, groups=cin),
            "pw": cm.convbn_init(next(keys), 1, cin, ch(cout))})
        cin = ch(cout)
    p["neck"] = cm.convbn_init(next(keys), 1, cin, dim)
    p["mixer"] = [{"ln1": ln(), "qkv": cm.linear_init(next(keys), dim,
                                                      3 * dim),
                   "proj": cm.linear_init(next(keys), dim, dim),
                   "ln2": ln(),
                   "fc1": cm.linear_init(next(keys), dim, mlp_ratio * dim),
                   "fc2": cm.linear_init(next(keys), mlp_ratio * dim, dim)}
                  for _ in range(depth)]
    p["head"] = cm.linear_init(next(keys), dim, vocab_size)
    return p


class Stage(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.dw = cm.ConvBN(3, cin, cin, stride=stride, groups=cin,
                            act="hswish")
        self.pw = cm.ConvBN(1, cin, cout, act="hswish")


class Mixer(nn.Module):
    def __init__(self, dim: int, mlp_ratio: int):
        super().__init__()
        self.ln1 = cm.LayerNorm(dim)
        self.qkv = cm.Linear(dim, 3 * dim)
        self.proj = cm.Linear(dim, dim)
        self.ln2 = cm.LayerNorm(dim)
        self.fc1 = cm.Linear(dim, mlp_ratio * dim)
        self.fc2 = cm.Linear(mlp_ratio * dim, dim)

    def attn(self, x, valid_t=None):
        n, t, d = x.shape
        h = max(1, d // 32)
        qkv = self.qkv(x).reshape(n, t, 3, h, d // h)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(d // h)
        if valid_t is not None:
            keep = torch.arange(t, device=x.device)[None, :] < \
                valid_t[:, None]
            scores = scores.masked_fill(~keep[:, None, None, :], -1e9)
        out = torch.softmax(scores, dim=-1) @ v
        return self.proj(out.transpose(1, 2).reshape(n, t, d))

    def forward(self, x, valid_t=None):
        x = x + self.attn(self.ln1(x), valid_t)
        y = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(y)


class Head(nn.Module):
    """CTC head in the JAX layout: w (D, V), b (V,). `w_split` (2, V, D) is
    the fused head kernel's operand, made from w by `prepare` (it is no
    part of the state dict)."""

    def __init__(self, dim: int, vocab: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(dim, vocab), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(vocab), requires_grad=False)
        self.register_buffer("w_split", None, persistent=False)

    def prepare(self) -> None:
        """Split w (in float32, whatever its dtype: the kernel reads float32
        operands, as JAX's head wrapper casts them) for the kernel, on w's
        device. Call again after w changes, moves or is cast."""
        self.w_split = ctc_head.split_head(self.w.detach().float())


def _mask_w(x, vw):
    """Zero x (N, C, H, W) beyond each sample's valid width vw (N,)."""
    keep = torch.arange(x.shape[3], device=x.device)[None, :] < vw[:, None]
    return x * keep[:, None, None, :].to(x.dtype)


class SVTR(nn.Module):
    def __init__(self, vocab: int, dim: int = 192, depth: int = 2,
                 width_mult: float = 1.0, mlp_ratio: int = 2):
        super().__init__()

        def ch(c):
            return int(round(c * width_mult / 8) * 8) or 8

        self.stem = cm.ConvBN(3, 3, ch(32), stride=2, act="hswish")
        stages = []
        cin = ch(32)
        for cout, s in STAGES:
            stages.append(Stage(cin, ch(cout), s))
            cin = ch(cout)
        self.stages = nn.ModuleList(stages)
        self.neck = cm.ConvBN(1, cin, dim, act="hswish")
        self.mixer = nn.ModuleList(Mixer(dim, mlp_ratio)
                                   for _ in range(depth))
        self.head = Head(dim, vocab)

    def features(self, x: torch.Tensor,
                 valid_t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, 3, 48, W) → (N, W/8, D). valid_t (N,) masks every conv
        stage's width axis and the attention keys beyond each row's valid
        token count, so valid-region features do not depend on padding."""
        x = self.stem(x)
        if valid_t is not None:
            x = _mask_w(x, valid_t * 4)
        w_div = 2
        for (_, s), st in zip(STAGES, self.stages):
            x = st.dw(x)
            w_div *= s[1]
            if valid_t is not None:
                x = _mask_w(x, valid_t * (8 // w_div))
            x = st.pw(x)
            if valid_t is not None:
                x = _mask_w(x, valid_t * (8 // w_div))
        x = self.neck(x)
        if valid_t is not None:
            x = _mask_w(x, valid_t * (8 // w_div))
        x = F.avg_pool2d(x, (x.shape[2], 2), (x.shape[2], 2))
        x = x[:, :, 0].transpose(1, 2)  # (N, T, D)
        for blk in self.mixer:
            x = blk(x, valid_t)
        return x

    def forward(self, x, valid_t=None) -> torch.Tensor:
        """(N, 3, 48, W) → (N, W/8, V) float32 logits (the plain head)."""
        f = self.features(x, valid_t)
        return f @ self.head.w.to(f.dtype) + self.head.b

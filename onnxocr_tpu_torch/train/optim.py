"""The trainers' optimizer (optax 0.2's `adamw`) and their view of a model.

optax.adamw(lr, weight_decay=wd) with its defaults (b1 0.9, b2 0.999, eps
1e-8, eps_root 0, no mask) updates every float leaf of the tree, biases,
LayerNorm leaves and batch-norm `mean` / `var` included:

    m ← b1·m + (1 − b1)·g,  v ← b2·v + (1 − b2)·g²,
    u = m̂ / (√v̂ + eps) + wd·p,  p ← p − lr·u  (m̂, v̂ bias-corrected).

torch.optim.AdamW computes the same update in another order (p·(1 − lr·wd)
first, then the Adam step with √v / √(1 − b2^t)); it holds to optax within
the tolerance tests/test_torch_train.py states, so it is used as it is.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from typing import Iterable, List

import numpy as np
import torch
import torch.nn as nn


def trainable(model: nn.Module) -> List[nn.Parameter]:
    """Put a built model (models/convert.build_*) in training mode with
    every JAX tree leaf trainable, and return those parameters. Training
    mode only lets cuDNN run the LSTM backward: no module of the port has
    dropout or batch statistics, so the forward is the same in both modes.
    The LSTMs' `bias_hh` stays frozen at zero: the JAX BiLSTM has one bias,
    loaded as `bias_ih`, which then takes the whole gradient."""
    model.train()
    params = []
    for name, p in model.named_parameters():
        train = "bias_hh" not in name
        p.requires_grad_(train)
        if train:
            params.append(p)
    return params


def adamw(params: Iterable[torch.Tensor], lr: float,
          weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """optax.adamw(lr, weight_decay=weight_decay) over `params`: every
    parameter decays."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def _cosf(x) -> np.float32:
    """The C library's float32 cosine (what XLA's CPU backend calls for
    optax's jnp.cos; numpy's float32 cosine differs from it by an ulp at
    some arguments), else the float64 cosine rounded."""
    global _LIBM
    if _LIBM is None:
        name = ctypes.util.find_library("m")
        _LIBM = ctypes.CDLL(name) if name else False
        if _LIBM:
            _LIBM.cosf.restype = ctypes.c_float
            _LIBM.cosf.argtypes = [ctypes.c_float]
    if _LIBM:
        return np.float32(_LIBM.cosf(float(x)))
    return np.float32(np.cos(np.float64(x)))


_LIBM = None


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule(init_value, peak_value,
    warmup_steps, decay_steps, end_value): count → the learning rate, in
    float32 as optax computes it (a linear warmup from init_value to
    peak_value over warmup_steps, then a cosine from peak_value to
    end_value over decay_steps − warmup_steps, held there after)."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def warm(count: int):
        if warmup_steps <= 0:
            return f32(init_value)
        c = f32(min(max(count, 0), warmup_steps))
        frac = f32(1) - c / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def cosine(count: int):
        c = f32(min(count, span))
        cos = f32(0.5) * (f32(1) + _cosf(f32(np.pi) * c / f32(span)))
        return f32(peak_value) * ((f32(1) - f32(alpha)) * cos + f32(alpha))

    def schedule(count: int):
        return warm(count) if count < warmup_steps else \
            cosine(count - warmup_steps)
    return schedule

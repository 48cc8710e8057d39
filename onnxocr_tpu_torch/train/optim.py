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

from typing import Iterable, List

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

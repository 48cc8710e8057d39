"""CRNN recognizer (NCHW) of the ch_ppocr_server_v2.0 family: strided conv
stages → mean over the remaining height → two bidirectional LSTMs (hidden
256) → linear to the vocabulary. Counterpart of onnxocr_tpu/models/crnn.py.

Input (N, 3, 48, W) in [−1, 1]; T = W/4 time steps. The LSTMs are
`torch.nn.LSTM(bidirectional=True)` run on the padded, unpacked sequence:
the JAX package's reverse direction flips the whole padded sequence, and
its gate order (i, f, g, o) is torch's. Its one bias per direction is
`bias_ih`; `bias_hh` is zero (models/convert.build_crnn). Nothing masks
width: a crop's logits depend on its bucket's padding, as in the JAX
package.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from . import common as cm

# (channels, (stride_h, stride_w)): H 48 → 24 → 12 → 6 → 2, W → W/4
STAGES = (
    (64, (2, 2)),
    (128, (2, 2)),
    (256, (2, 1)),
    (256, (3, 1)),
)
HIDDEN = 256


def init(rng, vocab_size: int) -> Dict[str, Any]:
    """Seeded tree of the JAX package's `crnn.init`: both BiLSTMs draw from
    one generator, normal(0, 1/sqrt(hidden)) weights, zero biases."""
    keys = iter(cm.split_rng(rng, 4 + len(STAGES) + 4 * 2 + 2))
    p: Dict[str, Any] = {"stem": cm.convbn_init(next(keys), 3, 3, 32),
                         "stages": []}
    cin = 32
    for cout, _s in STAGES:
        p["stages"].append(cm.convbn_init(next(keys), 3, cin, cout))
        cin = cout
    gen = cm.as_rng(next(keys))

    def lstm(in_dim):
        std = 1.0 / np.sqrt(HIDDEN)
        return {"wi": gen.normal(0, std, (2, 4 * HIDDEN, in_dim))
                .astype(np.float32),
                "wh": gen.normal(0, std, (2, 4 * HIDDEN, HIDDEN))
                .astype(np.float32),
                "b": np.zeros((2, 4 * HIDDEN), np.float32)}

    p["lstm1"] = lstm(cin)
    p["lstm2"] = lstm(2 * HIDDEN)
    p["head"] = cm.linear_init(next(keys), 2 * HIDDEN, vocab_size)
    return p


class CRNN(nn.Module):
    def __init__(self, vocab: int):
        super().__init__()
        self.stem = cm.ConvBN(3, 3, 32, act="relu")
        stages = []
        cin = 32
        for cout, s in STAGES:
            stages.append(cm.ConvBN(3, cin, cout, s, act="relu"))
            cin = cout
        self.stages = nn.ModuleList(stages)
        self.lstm1 = nn.LSTM(cin, HIDDEN, batch_first=True,
                             bidirectional=True)
        self.lstm2 = nn.LSTM(2 * HIDDEN, HIDDEN, batch_first=True,
                             bidirectional=True)
        self.head = cm.Linear(2 * HIDDEN, vocab)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, 3, 48, W) → (N, W/4, 256): the conv stack, its remaining
        height averaged."""
        x = self.stem(x)
        for st in self.stages:
            x = st(x)
        return x.mean(dim=2).transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3, 48, W) → (N, W/4, V) float32 logits."""
        return self.head(bilstm(self.lstm2, bilstm(self.lstm1,
                                                   self.features(x))))


def bilstm(lstm: nn.LSTM, x: torch.Tensor) -> torch.Tensor:
    """(N, T, D) → (N, T, 2H), the LSTM's weights cast to x's dtype (the
    JAX BiLSTM promotes bfloat16 leaves to the float32 activations)."""
    if lstm.weight_ih_l0.dtype == x.dtype:
        return lstm(x)[0]
    params = {n: p.to(x.dtype) for n, p in lstm.named_parameters()}
    return torch.func.functional_call(lstm, params, (x,))[0]

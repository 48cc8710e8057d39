"""The yardstick's arithmetic: the card's peaks, the model FLOPs of a
forward from its shapes, and kernel 1's least time from its shapes.

FLOPs count 2 a multiply-add of the matrix products and convolutions, as
torch.utils.flop_counter.FlopCounterMode counts them over the plain
networks of ocrbench/reference/nets.py run on the meta device (shapes
only); elementwise work counts nothing. A DBNet is fully convolutional, so
its FLOPs are measured once a (height, width); an SVTR's are a quadratic
in its width (attention) and a CRNN's linear, each fitted exactly from
three widths."""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from .reference import nets

# NVIDIA's data sheet for the H100 SXM (dense, at the 700 W limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32": 67e12, "tf32": 495e12,
                              "bf16": 989e12, "hbm_bytes": 3.35e12},
}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(kind)


@functools.lru_cache(maxsize=None)
def _meta_params(path: str):
    with np.load(path) as z:
        return {k: torch.empty(z[k].shape, device="meta") for k in z.files}


def _count(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


@functools.lru_cache(maxsize=None)
def det_flops(params_path: str, arch: str, h: int, w: int) -> float:
    """One page's DBNet forward at (h, w)."""
    p = _meta_params(params_path)
    return _count(lambda: nets.dbnet(
        p, torch.empty(1, 3, h, w, device="meta"), arch))


@functools.lru_cache(maxsize=None)
def _rec_poly(params_path: str, arch: str):
    p = _meta_params(params_path)
    fn = nets.svtr if arch == "svtr" else nets.crnn
    xs = np.array([64.0, 128.0, 192.0])
    ys = [_count(lambda w=int(w): fn(p, torch.empty(
        1, 3, 48, w, device="meta"))) for w in xs]
    return np.polyfit(xs, ys, 2)


def rec_flops(params_path: str, arch: str, width: int) -> float:
    """One line's recognizer forward at `width` (48 rows)."""
    return float(np.polyval(_rec_poly(params_path, arch), width))


def ctc_head_least_s(m: int, d: int, v: int, kind: str) -> Optional[float]:
    """Kernel 1's least time for one launch over M rows of width D against
    a vocabulary of V: its three TF32 products (3 · 2·M·D·V) at the TF32
    peak, or its bytes (x, the split head's two float32 copies, the bias,
    each row's index and probability, each read or written once) at the
    memory peak, whichever is longer."""
    pk = peaks(kind)
    if pk is None:
        return None
    ops = 3 * 2.0 * m * d * v
    nbytes = 4.0 * (m * d + 2 * v * d + v + 2 * m)
    return max(ops / pk["tf32"], nbytes / pk["hbm_bytes"])

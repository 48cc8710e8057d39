"""Fused CTC head: (M, D) @ (D, V) + b → per-row first-index argmax and
softmax max-prob, without materialising the (M, V) logits on the card.

Port of onnxocr_tpu/ops/pallas/ctc_head.py (`ctc_head_reduce`). On a CUDA
tensor the wrapper launches the hand-written kernel in csrc/ctc_head.cu; on a
CPU tensor it runs the plain PyTorch version below, which is also what the
kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from ..ctc import ctc_reduce_logits

_C = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"ctc_head_reduce": [_C, _C, _C, _I, _I, _I, _I,
                                   _C, _C, _C, _C, _C, _C]}
_BK = 16       # csrc/ctc_head.cu: D is consumed in chunks of 16
_BM = 64       # rows per block
_BN = 128      # vocab columns per tile
_SMS = 132     # H100 SXM


def ctc_head_reduce_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          chunk: int = 1024
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same function in plain PyTorch (ops/ctc.ctc_reduce_logits semantics),
    `chunk` rows at a time so the logits never exceed chunk × V."""
    idx, prob = [], []
    for r in range(0, x.shape[0], chunk):
        i, p = ctc_reduce_logits(x[r:r + chunk] @ w + b)
        idx.append(i)
        prob.append(p)
    if not idx:
        return (torch.zeros(0, dtype=torch.int32, device=x.device),
                torch.zeros(0, dtype=torch.float32, device=x.device))
    return torch.cat(idx), torch.cat(prob)


def _check(x, w, b):
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError("ctc_head_reduce wants x (M, D), w (D, V), b (V,)")
    if x.shape[1] != w.shape[0] or w.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"ctc_head_reduce: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ctc_head_reduce: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError("ctc_head_reduce: x, w, b on different devices")


def ctc_head_reduce(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, D), w (D, V), b (V,) float32 → ((M,) int32 argmax, (M,) float32
    1/Σexp(l − max)). Ties resolve to the first index."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return ctc_head_reduce_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"ctc_head_reduce: unsupported device {x.device}")
    M, D = x.shape
    V = w.shape[1]
    if D % _BK:
        raise ValueError(f"ctc_head_reduce: D={D} must be a multiple of {_BK}")
    idx = torch.empty(M, dtype=torch.int32, device=x.device)
    prob = torch.empty(M, dtype=torch.float32, device=x.device)
    if M == 0:
        return idx, prob
    # split the vocab over grid.y so about two waves of blocks fill the SMs
    n_tiles = -(-V // _BN)
    splits = max(1, min(n_tiles, -(-2 * _SMS // -(-M // _BM))))
    part_m = torch.empty((M, splits), dtype=torch.float32, device=x.device)
    part_s = torch.empty_like(part_m)
    part_a = torch.empty((M, splits), dtype=torch.int32, device=x.device)
    lib = build.load("ctc_head", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.ctc_head_reduce(
            build.ptr(x), build.ptr(w), build.ptr(b), M, D, V, splits,
            build.ptr(part_m), build.ptr(part_s), build.ptr(part_a),
            build.ptr(idx), build.ptr(prob), build.stream_of(x))
    build.check(rc, "ctc_head_reduce")
    build.LAUNCHES["ctc_head_reduce"] += 1
    return idx, prob


def ctc_head_reduce_batched(feats: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, T, D) → ((N, T) idx, (N, T) prob)."""
    N, T, D = feats.shape
    idx, prob = ctc_head_reduce(feats.reshape(N * T, D).contiguous(), w, b)
    return idx.reshape(N, T), prob.reshape(N, T)

"""Fused CTC head: (M, D) @ (D, V) + b → per-row first-index argmax and
softmax max-prob, without materialising the (M, V) logits on the card.

Port of onnxocr_tpu/ops/pallas/ctc_head.py (`ctc_head_reduce`). The card has
no float32 tensor-core product, so the kernel in csrc/ctc_head.cu takes the
product as three TF32 passes over split operands (`split_tf32`): x = x_hi +
x_lo, W = W_hi + W_lo, logits = x_lo·W_hi + x_hi·W_lo + x_hi·W_hi summed in
float32. W is a constant: `split_head` prepares it once, K-major,
when the head is built, and `ctc_head_reduce` takes that prepared operand; x
is split inside the kernel. On a CUDA tensor the wrapper launches the kernel;
on a CPU tensor it runs `ctc_head_reduce_3xtf32_plain`, the same arithmetic
in plain PyTorch. `ctc_head_reduce_plain` is the float32 function both are
held against.
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
_BM = 64       # csrc/ctc_head.cu: rows per block (one wgmma M)
_BN = 128      # vocab columns per tile (one wgmma N)
_KB = 32       # D is consumed in 128-byte rows of 32 floats
_MAX_D = 192   # x_hi + x_lo of a row tile and the W ring fill shared memory
_SMS = 132     # H100 SXM


def split_tf32(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 v → (hi, lo), both with the low 13 mantissa bits clear (TF32
    values): hi = v rounded to nearest, ties away from zero (PTX
    `cvt.rna.tf32.f32`), lo = (v − hi) rounded the same way. v − hi is exact
    in float32, so hi + lo reproduces v to 2⁻²² relative."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(v)
    return hi, rna(v - hi)


def split_head(w: torch.Tensor) -> torch.Tensor:
    """Head weight w (D, V) → the kernel's prepared operand (2, V, D) on w's
    device: [0] = hi, [1] = lo of `split_tf32`, each K-major (D contiguous),
    as the tensor cores read a TF32 operand from shared memory."""
    if w.dim() != 2 or w.dtype != torch.float32:
        raise TypeError("split_head wants w (D, V) float32")
    return torch.stack(split_tf32(w.detach().t().contiguous()))


def _chunked(fn, x: torch.Tensor, chunk: int):
    idx, prob = [], []
    for r in range(0, x.shape[0], chunk):
        i, p = ctc_reduce_logits(fn(x[r:r + chunk]))
        idx.append(i)
        prob.append(p)
    if not idx:
        return (torch.zeros(0, dtype=torch.int32, device=x.device),
                torch.zeros(0, dtype=torch.float32, device=x.device))
    return torch.cat(idx), torch.cat(prob)


def ctc_head_reduce_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          chunk: int = 1024
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 function in plain PyTorch over the unsplit w (D, V)
    (ops/ctc.ctc_reduce_logits semantics), `chunk` rows at a time so the
    logits never exceed chunk × V."""
    return _chunked(lambda rows: rows @ w + b, x, chunk)


def ctc_head_reduce_3xtf32_plain(x: torch.Tensor, w_split: torch.Tensor,
                                 b: torch.Tensor, chunk: int = 1024
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch: x split as the kernel
    splits it, three float32 products of the TF32 parts (small terms
    first), then the same reduction."""
    w_hi, w_lo = w_split[0].t(), w_split[1].t()

    def logits(rows):
        hi, lo = split_tf32(rows)
        return (lo @ w_hi + hi @ w_lo) + hi @ w_hi + b

    return _chunked(logits, x, chunk)


def _check(x, w_split, b):
    if x.dim() != 2 or w_split.dim() != 3 or w_split.shape[0] != 2 \
            or b.dim() != 1:
        raise ValueError("ctc_head_reduce wants x (M, D), w_split (2, V, D) "
                         "from split_head, b (V,)")
    if x.shape[1] != w_split.shape[2] or w_split.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_split "
                         f"{tuple(w_split.shape)}, b {tuple(b.shape)}")
    for name, t in (("x", x), ("w_split", w_split), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"ctc_head_reduce: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ctc_head_reduce: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError("ctc_head_reduce: x, w_split, b on different "
                             "devices")


def pick_splits(M: int, V: int) -> int:
    """Parts the vocab sweep is cut into (grid.y). One block fills an SM, so
    the blocks run in waves of `_SMS`: take the split count with the least
    waves × (vocab tiles per block + 1), the 1 standing for a block's
    staging of its row tile; the smaller count on equal cost."""
    row_tiles = -(-M // _BM)
    n_tiles = -(-V // _BN)
    best, best_cost = 1, None
    for s in range(1, min(n_tiles, 16) + 1):
        cost = -(-row_tiles * s // _SMS) * (-(-n_tiles // s) + 1)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def ctc_head_reduce(x: torch.Tensor, w_split: torch.Tensor, b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, D), w_split (2, V, D) from `split_head`, b (V,) float32 →
    ((M,) int32 argmax, (M,) float32 1/Σexp(l − max)). Ties resolve to the
    first index. Its product, 2·M·D·V FLOPs, goes to any open
    `build.counting_flops` count on either route (the plain version's
    three TF32 products are hidden from PyTorch's FLOP counter)."""
    _check(x, w_split, b)
    build.count_flops(2 * x.shape[0] * x.shape[1] * w_split.shape[1])
    if x.device.type == "cpu":
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            return ctc_head_reduce_3xtf32_plain(x, w_split, b)
    if x.device.type != "cuda":
        raise ValueError(f"ctc_head_reduce: unsupported device {x.device}")
    M, D = x.shape
    V = w_split.shape[1]
    if D % _KB or not 0 < D <= _MAX_D:
        raise ValueError(f"ctc_head_reduce: D={D} must be a multiple of "
                         f"{_KB}, at most {_MAX_D}")
    if x.data_ptr() % 16 or w_split.data_ptr() % 16:
        raise ValueError("ctc_head_reduce: x and w_split must be 16-byte "
                         "aligned")
    idx = torch.empty(M, dtype=torch.int32, device=x.device)
    prob = torch.empty(M, dtype=torch.float32, device=x.device)
    if M == 0:
        return idx, prob
    splits = pick_splits(M, V)
    part_m = torch.empty((M, splits), dtype=torch.float32, device=x.device)
    part_s = torch.empty_like(part_m)
    part_a = torch.empty((M, splits), dtype=torch.int32, device=x.device)
    lib = build.load("ctc_head", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.ctc_head_reduce(
            build.ptr(x), build.ptr(w_split), build.ptr(b), M, D, V, splits,
            build.ptr(part_m), build.ptr(part_s), build.ptr(part_a),
            build.ptr(idx), build.ptr(prob), build.stream_of(x))
    build.check(rc, "ctc_head_reduce")
    build.count_launch("ctc_head_reduce")
    return idx, prob


def ctc_head_reduce_batched(feats: torch.Tensor, w_split: torch.Tensor,
                            b: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, T, D) → ((N, T) idx, (N, T) prob)."""
    N, T, D = feats.shape
    idx, prob = ctc_head_reduce(feats.reshape(N * T, D).contiguous(),
                                w_split, b)
    return idx.reshape(N, T), prob.reshape(N, T)

"""Slot-keyed DB-extraction reductions: fold every working-grid cell's
values into its component slot — (K, C) segment sums and segment mins.

Port of onnxocr_tpu/ops/pallas/seg_reduce.py (`seg_sum_bands`,
`seg_min_bands`), the reductions of `tpu_db_reduce='pallas'`. On CUDA
tensors the wrappers launch the hand-written kernels in csrc/seg_reduce.cu;
on CPU tensors they run the plain PyTorch versions below (index_add_ /
scatter_reduce_ "amin" into a (K + 1, C) buffer whose last row is the dump
slot), which are also what the kernels are held against on the card.

Contract (the reference's): slot K — and any slot outside [0, K) — is a
no-op; the sum of an empty slot is 0 and its min is `big`; a value at or
above the 3.4e38 sentinel never wins a min; 1 <= C <= 7.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

BIG = 3.4e38
MAX_C = 7

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "seg_sum_bands": [_C, _C, _L, _I, _I, _C, _C, _C],
    "seg_min_bands": [_C, _C, _L, _I, _I, ctypes.c_float, _C, _C, _C],
}


def _rows(slot: torch.Tensor, K: int) -> torch.Tensor:
    """int64 row of each cell in a (K + 1, C) buffer, K for a no-op cell."""
    s = slot.to(torch.int64)
    return torch.where((s >= 0) & (s < K), s, K)


def seg_sum_bands_plain(slot, vals, K: int):
    """Plain version: float64 index_add_, cast to float32 (the kernel also
    accumulates in float64)."""
    acc = torch.zeros((K + 1, vals.shape[1]), dtype=torch.float64,
                      device=vals.device)
    acc.index_add_(0, _rows(slot, K), vals.to(torch.float64))
    return acc[:K].to(torch.float32)


def seg_min_bands_plain(slot, vals, K: int, big: float = BIG):
    """Plain version: scatter_reduce_ 'amin' over a buffer of 3.4e38, the
    sentinel swapped for `big` afterwards as the reference does."""
    C = vals.shape[1]
    ext = torch.full((K + 1, C), BIG, dtype=torch.float32,
                     device=vals.device)
    ext.scatter_reduce_(0, _rows(slot, K)[:, None].expand(-1, C), vals,
                        "amin", include_self=True)
    res = ext[:K]
    return torch.where(res >= BIG, float(big), res)


def _check(name: str, slot: torch.Tensor, vals: torch.Tensor, K: int):
    if slot.dim() != 1 or slot.dtype != torch.int32:
        raise TypeError(f"{name}: slot must be (N,) int32")
    if vals.dim() != 2 or vals.dtype != torch.float32 or \
            vals.shape[0] != slot.shape[0]:
        raise TypeError(f"{name}: vals must be (N, C) float32 with slot's N, "
                        f"got {vals.dtype} {tuple(vals.shape)}")
    if not 1 <= vals.shape[1] <= MAX_C:
        raise ValueError(f"{name}: C must be in [1, {MAX_C}]")
    if int(K) < 1:
        raise ValueError(f"{name}: K must be positive")
    if not (slot.is_contiguous() and vals.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if slot.device != vals.device:
        raise ValueError(f"{name}: inputs on different devices")
    if slot.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {slot.device}")


def seg_sum_bands(slot: torch.Tensor, vals: torch.Tensor, K: int
                  ) -> torch.Tensor:
    """slot (N,) int32, vals (N, C) float32 → (K, C) float32 sums."""
    _check("seg_sum_bands", slot, vals, K)
    if slot.device.type == "cpu":
        return seg_sum_bands_plain(slot, vals, K)
    if slot.shape[0] >= 2 ** 31:
        raise ValueError("seg_sum_bands: N must be below 2^31")
    C = vals.shape[1]
    scratch = torch.empty((K * C + 1,), dtype=torch.float64,
                          device=slot.device)
    out = torch.empty((K, C), dtype=torch.float32, device=slot.device)
    lib = build.load("seg_reduce", _SIGNATURES)
    with torch.cuda.device(slot.device):
        rc = lib.seg_sum_bands(build.ptr(slot), build.ptr(vals),
                               slot.shape[0], K, C, build.ptr(scratch),
                               build.ptr(out), build.stream_of(slot))
    build.check(rc, "seg_sum_bands")
    build.count_launch("seg_sum_bands")
    return out


def seg_min_bands(slot: torch.Tensor, vals: torch.Tensor, K: int,
                  big: float = BIG) -> torch.Tensor:
    """slot (N,) int32, vals (N, C) float32 → (K, C) float32 mins; empty
    slots (and slots that only saw the sentinel) return `big`."""
    _check("seg_min_bands", slot, vals, K)
    if slot.device.type == "cpu":
        return seg_min_bands_plain(slot, vals, K, big)
    if slot.shape[0] >= 2 ** 31:
        raise ValueError("seg_min_bands: N must be below 2^31")
    C = vals.shape[1]
    scratch = torch.empty((K * C + 1,), dtype=torch.int32,
                          device=slot.device)
    out = torch.empty((K, C), dtype=torch.float32, device=slot.device)
    lib = build.load("seg_reduce", _SIGNATURES)
    with torch.cuda.device(slot.device):
        rc = lib.seg_min_bands(build.ptr(slot), build.ptr(vals),
                               slot.shape[0], K, C, float(big),
                               build.ptr(scratch), build.ptr(out),
                               build.stream_of(slot))
    build.check(rc, "seg_min_bands")
    build.count_launch("seg_min_bands")
    return out

"""Label-keyed DB-extraction reductions: per kept component id, moment sums
and projection extents over the working-grid cells carrying that label.

Port of onnxocr_tpu/ops/pallas/seg_reduce2.py (`label_moment_sums`,
`label_proj_extents`). On CUDA tensors the wrappers launch the hand-written
kernels in csrc/seg_reduce2.cu; on CPU tensors they run the plain PyTorch
versions below (searchsorted slots + index_add_ / scatter_reduce_), which
are also what the kernels are held against on the card.

Coordinates are full-map cell centres under the (sy, sx) working grid:
x = sx·gx + (sx−1)/2, y = sy·gy + (sy−1)/2. `ids` is ascending (kept rep
seeds) with INT32_MAX marking empty slots; labels absent from `ids`
(background 0, components past the budget) contribute nothing.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

BIG = 3.4e38

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "label_moment_sums": [_C, _C, _C, _I, _L, _I, _I, _I, _C, _C, _C],
    "label_proj_extents": [_C, _C, _C, _I, _L, _I, _I, _I, _C, _C, _C],
}


def _slots(lab_flat: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Slot of each cell's label in `ids`, K (a dump slot) when absent."""
    K = ids.shape[0]
    s = torch.searchsorted(ids, lab_flat)
    found = (lab_flat > 0) & (s < K) & \
        (ids[s.clamp(max=K - 1)] == lab_flat)
    return torch.where(found, s, K)


def _coords(n: int, W: int, sy: int, sx: int, dtype, device
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, device=device)
    gy = torch.div(i, W, rounding_mode="floor")
    gx = i - gy * W
    return (gx.to(dtype) * sx + (sx - 1) * 0.5,
            gy.to(dtype) * sy + (sy - 1) * 0.5)


def label_moment_sums_plain(lab, prob, ids, sy: int = 1, sx: int = 1):
    """Plain version: float64 index_add_ of the seven moments, cast to
    float32 (the kernel also accumulates in float64)."""
    K = ids.shape[0]
    flat = lab.reshape(-1)
    slot = _slots(flat, ids)
    fx, fy = _coords(flat.shape[0], lab.shape[1], sy, sx, torch.float64,
                     lab.device)
    stats = torch.stack([torch.ones_like(fx), fx, fy, fx * fx, fy * fy,
                         fx * fy, prob.reshape(-1).to(torch.float64)], 1)
    acc = torch.zeros((K + 1, 7), dtype=torch.float64, device=lab.device)
    acc.index_add_(0, slot, stats)
    return acc[:K].to(torch.float32)


def label_proj_extents_plain(lab, axes, ids, sy: int = 1, sx: int = 1):
    """Plain version: float32 projections, scatter_reduce_ 'amin'."""
    K = ids.shape[0]
    flat = lab.reshape(-1)
    slot = _slots(flat, ids)
    fx, fy = _coords(flat.shape[0], lab.shape[1], sy, sx, torch.float32,
                     lab.device)
    sc = slot.clamp(max=K - 1)
    ux, uy = axes[sc, 0], axes[sc, 1]
    pu = ux * fx + uy * fy
    pv = ux * fy - uy * fx
    cols = torch.stack([pu, pv, -pu, -pv], 1)
    ext = torch.full((K + 1, 4), BIG, dtype=torch.float32, device=lab.device)
    ext.scatter_reduce_(0, slot[:, None].expand(-1, 4), cols, "amin",
                        include_self=True)
    return ext[:K]


def _check(name, lab, ids, other, other_shape):
    if lab.dim() != 2 or lab.dtype != torch.int32:
        raise TypeError(f"{name}: lab must be (H, W) int32")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise TypeError(f"{name}: ids must be (K,) int32")
    if other.dtype != torch.float32 or tuple(other.shape) != other_shape:
        raise TypeError(f"{name}: expected float32 {other_shape}, got "
                        f"{other.dtype} {tuple(other.shape)}")
    for t in (lab, ids, other):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.device != lab.device:
            raise ValueError(f"{name}: inputs on different devices")
    if lab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {lab.device}")
    if lab.numel() >= 2 ** 31:
        raise ValueError(f"{name}: the grid must have fewer than 2^31 cells")


def label_moment_sums(lab: torch.Tensor, prob: torch.Tensor,
                      ids: torch.Tensor, sy: int = 1, sx: int = 1
                      ) -> torch.Tensor:
    """lab (H, Wg) int32, prob (H, Wg) float32, ids (K,) int32 ascending →
    (K, 7) float32 [n, Σx, Σy, Σx², Σy², Σxy, Σp]. On the card: one memset
    and one launch."""
    _check("label_moment_sums", lab, ids, prob, tuple(lab.shape))
    if lab.device.type == "cpu":
        return label_moment_sums_plain(lab, prob, ids, sy, sx)
    K = ids.shape[0]
    # accumulator + ticket counter, cleared by the kernel's one memset
    acc = torch.empty(7 * K + 1, dtype=torch.float64, device=lab.device)
    out = torch.empty((K, 7), dtype=torch.float32, device=lab.device)
    lib = build.load("seg_reduce2", _SIGNATURES)
    with torch.cuda.device(lab.device):
        rc = lib.label_moment_sums(
            build.ptr(lab), build.ptr(prob), build.ptr(ids), K, lab.numel(),
            lab.shape[1], sy, sx, build.ptr(acc), build.ptr(out),
            build.stream_of(lab))
    build.check(rc, "label_moment_sums")
    build.count_launch("label_moment_sums")
    return out


def label_proj_extents(lab: torch.Tensor, axes: torch.Tensor,
                       ids: torch.Tensor, sy: int = 1, sx: int = 1
                       ) -> torch.Tensor:
    """lab (H, Wg) int32, axes (K, 2) float32 per-slot major axis [ux, uy],
    ids (K,) int32 ascending → (K, 4) float32 mins of [pu, pv, −pu, −pv]
    (3.4e38 for empty slots). On the card: one memset and one launch."""
    K = ids.shape[0]
    _check("label_proj_extents", lab, ids, axes, (K, 2))
    if lab.device.type == "cpu":
        return label_proj_extents_plain(lab, axes, ids, sy, sx)
    # key accumulator + ticket counter, cleared by the kernel's one memset
    acc = torch.empty(4 * K + 1, dtype=torch.int32, device=lab.device)
    out = torch.empty((K, 4), dtype=torch.float32, device=lab.device)
    lib = build.load("seg_reduce2", _SIGNATURES)
    with torch.cuda.device(lab.device):
        rc = lib.label_proj_extents(
            build.ptr(lab), build.ptr(axes), build.ptr(ids), K, lab.numel(),
            lab.shape[1], sy, sx, build.ptr(acc), build.ptr(out),
            build.stream_of(lab))
    build.check(rc, "label_proj_extents")
    build.count_launch("label_proj_extents")
    return out

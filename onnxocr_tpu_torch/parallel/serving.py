"""Batched inference over a mesh of devices: the page (or crop) batch split
over the mesh's `data` axis. Counterpart of onnxocr_tpu/parallel/serving.py.

The JAX package shards the batch axis of one jit program over its chips;
weights replicate and no collective runs (pages are independent). The
port keeps the trainers' single-controller form: one process, one replica
of the model per data row on the row's first device (`mesh.replicate`),
and one worker thread per device (`mesh.Rows`), which pads the batch to a
multiple of the rows, splits it evenly and gathers the rows' outputs in
batch order. No torch.distributed, no NCCL.

Usage:
    m = mesh.make_mesh()                      # every CUDA device
    det = ShardedDetBatch(model, m)           # the port's DBNet module
    prob_maps = det(pages_u8, rhw)            # (B, H, W) on row 0's device
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops import ctc, det_pre
from . import mesh as mesh_lib


def _param_dtype(model) -> torch.dtype:
    return next(model.parameters()).dtype


class ShardedDetBatch:
    """(B, H, W, 3) uint8 page batch → (B, H, W) float32 prob maps, B split
    over the mesh's `data` axis; each row runs `normalize_det` and the
    DBNet (`model`, the port's module; `arch` its backbone, as the JAX
    class takes it) masked to each page's valid extent."""

    def __init__(self, model, mesh: mesh_lib.Mesh, arch: str = "mbv3"):
        if getattr(model, "arch", arch) != arch:
            raise ValueError(f"the DBNet's backbone is {model.arch!r}, "
                             f"not {arch!r}")
        self.mesh = mesh
        self.arch = arch
        self.rows = mesh_lib.Rows(mesh)
        self.models = mesh_lib.replicate(model, mesh)
        self.dtype = _param_dtype(model)

    def __call__(self, batch_u8, rhw=None, encode: Optional[Callable] = None,
                 device=None) -> torch.Tensor:
        """rhw (B, 2) int32 valid (rh, rw) per page masks the backbone's SE
        pools to the un-padded region; it defaults to the full canvas. The
        batch pads with zero pages of full-canvas extent, as in the JAX
        package. `encode` (the det batcher's wire encoding) runs on each
        row before the gather; the result lands on `device` (default: row
        0's)."""
        b, h, w = batch_u8.shape[:3]
        if rhw is None:
            rhw = np.tile(np.int32([h, w]), (b, 1))
        return self.rows.split(
            lambda i, pages, ext: self._row(i, pages, ext, encode),
            (batch_u8, np.asarray(rhw, np.int32)),
            pads=(None, np.int32([h, w])), device=device)

    def _row(self, i: int, pages, rhw, encode):
        dev = self.rows.devices[i]
        x = det_pre.normalize_det(torch.as_tensor(pages).to(dev))
        ext = torch.as_tensor(rhw).to(dev)
        prob = self.models[i](x.permute(0, 3, 1, 2).to(self.dtype),
                              valid_hw=(ext[:, 0], ext[:, 1]))
        prob = prob.to(torch.float32)
        return prob if encode is None else encode(prob)

    def close(self) -> None:
        self.rows.close()


class ShardedRecBatch:
    """(B, 48, W, 3) float32 crop batch → ((B, T) int32 idx, (B, T) float32
    prob), B split over the mesh's `data` axis. Each row computes the
    SVTR's full logits (the plain head) and reduces them with
    `ctc_reduce_logits`, as the JAX class does (no head kernel here)."""

    def __init__(self, model, mesh: mesh_lib.Mesh):
        self.mesh = mesh
        self.rows = mesh_lib.Rows(mesh)
        self.models = mesh_lib.replicate(model, mesh)
        self.dtype = _param_dtype(model)

    def __call__(self, crops):
        """The batch pads with zero crops; the result is on row 0's
        device."""
        return self.rows.split(self._row, (crops,))

    def _row(self, i: int, crops):
        x = torch.as_tensor(crops).to(self.rows.devices[i])
        logits = self.models[i](x.permute(0, 3, 1, 2).to(self.dtype))
        return ctc.ctc_reduce_logits(logits.to(torch.float32))

    def close(self) -> None:
        self.rows.close()

"""Detection preprocessing helpers: the reference resize target, the
ImageNet constants, and the bitmap wire (the DB bitmap bitpacked on the
device, unpacked on the host). Copy of the parts of
onnxocr_tpu/ops/det_pre.py the ported paths read; the host det resize
(`prepare_det_input`, cv2) is not ported.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def det_resize_target(h: int, w: int, limit_side_len: float = 960,
                      limit_type: str = "max") -> Tuple[int, int]:
    """The /32-rounded (resize_h, resize_w) the reference would use
    (DetResizeForTest resize_image_type0, operators.py:99-127)."""
    if limit_type == "max":
        ratio = float(limit_side_len) / max(h, w) \
            if max(h, w) > limit_side_len else 1.0
    elif limit_type == "min":
        ratio = float(limit_side_len) / min(h, w) \
            if min(h, w) < limit_side_len else 1.0
    elif limit_type == "resize_long":
        ratio = float(limit_side_len) / max(h, w)
    else:
        raise ValueError(f"unsupported limit_type {limit_type!r}")
    resize_h = int(h * ratio)
    resize_w = int(w * ratio)
    resize_h = max(int(round(resize_h / 32) * 32), 32)
    resize_w = max(int(round(resize_w / 32) * 32), 32)
    return resize_h, resize_w


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bitpack_map(prob: torch.Tensor, vh, vw, thresh: float) -> torch.Tensor:
    """(H, W) float32 prob on the device → (H, W // 8) uint8 of the DB
    bitmap (prob > thresh), zeroed outside the (vh, vw) valid region,
    bitpacked little-endian within a byte (bit i of byte j holds column
    8j + i). W is a multiple of 8: the det canvas is a multiple of its
    320 bucket. A wave's maps (B, H, W) take (B,) int tensors vh, vw, one
    extent per map (the JAX package vmaps the one-map form)."""
    H, W = prob.shape[-2:]
    dev = prob.device
    if isinstance(vh, torch.Tensor):
        vh, vw = vh[..., None, None], vw[..., None, None]
    row = torch.arange(H, device=dev)[:, None] < vh
    col = torch.arange(W, device=dev)[None, :] < vw
    bits = (prob > thresh) & row & col
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.int32,
                           device=dev)
    return (bits.reshape(*prob.shape[:-1], W // 8, 8).to(torch.int32) *
            weights).sum(-1).to(torch.uint8)


def unpack_bitmap(bits_u8: np.ndarray, rw: int) -> np.ndarray:
    """Host twin of bitpack_map: (rh, ceil(rw / 8)) packed rows → (rh, rw)
    uint8 0/1 bitmap."""
    return np.unpackbits(bits_u8, axis=1, bitorder="little")[:, :rw]

"""Detection preprocessing: the reference resize target, the host det input
(`prepare_det_input`: the reference resize with cv2's pixels into a zero
canvas), the ImageNet normalization, and the bitmap wire (the DB bitmap
bitpacked on the device, unpacked on the host). Counterpart of
onnxocr_tpu/ops/det_pre.py.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import cv_ops

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


def det_resize_long_target(h: int, w: int, resize_long: float = 960
                           ) -> Tuple[int, int]:
    """resize_type 2: the longest side scaled to resize_long, the sides
    rounded up to a multiple of 128 (reference operators.py:140-161)."""
    ratio = float(resize_long) / max(h, w)
    stride = 128
    return ((int(h * ratio) + stride - 1) // stride * stride,
            (int(w * ratio) + stride - 1) // stride * stride)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def prepare_det_input(img: np.ndarray, limit_side_len: float = 960,
                      limit_type: str = "max", bucket: int = 320,
                      image_shape: Optional[Tuple[int, int]] = None,
                      keep_ratio: bool = False,
                      canvas: Optional[Tuple[int, int]] = None,
                      ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """The host det input: → (canvas (Hb, Wb, 3) uint8, shape_info [src_h,
    src_w, ratio_h, ratio_w] float64, (resize_h, resize_w)).

    The reference's tiny-image quirk is kept: a page with h + w < 64 is
    zero-padded to at least 32 × 32 before the resize (its ratios are
    those of the padded page). image_shape: the fixed resize target
    (DetResizeForTest type 1; keep_ratio rounds its width to the page's
    aspect). The canvas is the page's own bucket canvas, or `canvas`
    (H, W) when it covers the resize target."""
    src_h, src_w = img.shape[:2]
    if src_h + src_w < 64:
        pad = np.zeros((max(32, src_h), max(32, src_w), img.shape[2]),
                       np.uint8)
        pad[:src_h, :src_w] = img
        img = pad
    h, w = img.shape[:2]
    if image_shape is not None:
        resize_h, resize_w = image_shape
        if keep_ratio:
            resize_w = int(math.ceil(w * resize_h / h / 32) * 32)
        ratio_h = float(resize_h) / h
        ratio_w = float(resize_w) / w
    else:
        resize_h, resize_w = det_resize_target(h, w, limit_side_len,
                                               limit_type)
        ratio_h = resize_h / float(h)
        ratio_w = resize_w / float(w)
    resized = cv_ops.resize_linear(img, (resize_w, resize_h))
    hb, wb = round_up(resize_h, bucket), round_up(resize_w, bucket)
    if canvas is not None:
        hb, wb = max(canvas[0], hb), max(canvas[1], wb)
    padded = np.zeros((hb, wb, 3), dtype=np.uint8)
    padded[:resize_h, :resize_w] = resized
    shape_info = np.array([src_h, src_w, ratio_h, ratio_w], dtype=np.float64)
    return padded, shape_info, (resize_h, resize_w)


def normalize_det(x: torch.Tensor) -> torch.Tensor:
    """Pixel values in [0, 255] (uint8 or float) → ImageNet-normalized
    float32 (NormalizeImage with scale 1/255)."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x.to(torch.float32) / 255.0 - mean) / std


def normalize_pm1(x: torch.Tensor) -> torch.Tensor:
    """uint8 → [-1, 1] float32 on the tensor's device (the rec / cls
    normalization, predict_rec.py:74-77)."""
    return x.to(torch.float32) / 127.5 - 1.0


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

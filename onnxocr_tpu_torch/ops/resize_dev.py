"""Detector input prep on the device: bilinear resize of the uploaded source
page into the det canvas, rounded to uint8 and ImageNet-normalized.

Port of onnxocr_tpu/ops/resize_dev.py (the 'padded' upload: the host
edge-pads the page to a 512-multiple source bucket, so crop warps that clamp
at the bucket edge see BORDER_REPLICATE pixels).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import det_pre

SRC_BUCKET = 512


def src_bucket_shape(h: int, w: int) -> Tuple[int, int]:
    return (max(SRC_BUCKET, det_pre.round_up(h, SRC_BUCKET)),
            max(SRC_BUCKET, det_pre.round_up(w, SRC_BUCKET)))


def pad_src_bucket(img: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """EDGE-pad the page up to its source bucket → (padded, h, w)."""
    h, w = img.shape[:2]
    hb, wb = src_bucket_shape(h, w)
    if (hb, wb) == (h, w):
        return np.ascontiguousarray(img), h, w
    return np.pad(img, ((0, hb - h), (0, wb - w), (0, 0)), mode="edge"), h, w


def put_src_bucket(img: np.ndarray, device) -> Tuple[torch.Tensor, int, int]:
    """Upload a BGR page → ((hb, wb, 3) uint8 tensor on `device`, h, w)."""
    padded, h, w = pad_src_bucket(img)
    return torch.from_numpy(padded).to(device), h, w


def resize_normalize_det(image_u8: torch.Tensor, src_h: int, src_w: int,
                         resize_h: int, resize_w: int, out_h: int,
                         out_w: int) -> torch.Tensor:
    """image_u8 (Hs, Ws, 3) padded source (valid src_h × src_w) → (out_h,
    out_w, 3) float32 whose top-left resize_h × resize_w region is the
    half-pixel bilinear resize of the valid source (cv2 INTER_LINEAR),
    rounded to uint8 before normalizing, zero elsewhere. The separable
    resize runs as two matrix products whose weight rows hold exactly the
    two taps max(0, 1 − |i − src|)."""
    Hs, Ws = image_u8.shape[:2]
    dev = image_u8.device
    f32 = torch.float32
    sy = float(np.float32(src_h) / np.float32(resize_h))
    sx = float(np.float32(src_w) / np.float32(resize_w))
    ys = torch.arange(out_h, dtype=f32, device=dev)
    xs = torch.arange(out_w, dtype=f32, device=dev)
    src_y = torch.clamp((ys + 0.5) * sy - 0.5, 0.0, src_h - 1.0)
    src_x = torch.clamp((xs + 0.5) * sx - 0.5, 0.0, src_w - 1.0)
    iy = torch.arange(Hs, dtype=f32, device=dev)
    ix = torch.arange(Ws, dtype=f32, device=dev)
    wy = torch.clamp(1.0 - torch.abs(iy[None, :] - src_y[:, None]), min=0.0)
    wx = torch.clamp(1.0 - torch.abs(ix[None, :] - src_x[:, None]), min=0.0)
    tmp = (wy @ image_u8.reshape(Hs, Ws * 3).to(f32)).reshape(out_h, Ws, 3)
    vals = torch.einsum("hwc,xw->hxc", tmp, wx)
    norm = det_pre.normalize_det(torch.round(torch.clamp(vals, 0.0, 255.0)))
    norm[resize_h:] = 0.0
    norm[:, resize_w:] = 0.0
    return norm

"""Perspective crops of text boxes: host homographies + the device gather.

Port of onnxocr_tpu/ops/warp.py, gather form: every crop pixel maps through
one 3×3 dest→source matrix (homography ∘ rot90 quirk ∘ optional 180° ∘
resize), is sampled bilinearly with BORDER_REPLICATE clamping, clipped,
normalized to [−1, 1] and zeroed beyond the crop's valid width. The
shear-staged warp (`tpu_warp_stage='shear'`) and bicubic sampling are not
ported.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3×3 homography mapping src[i] → dst[i] (cv2.getPerspectiveTransform)."""
    src = np.asarray(src, dtype=np.float64).reshape(4, 2)
    dst = np.asarray(dst, dtype=np.float64).reshape(4, 2)
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        A[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        A[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i] = u
        b[2 * i + 1] = v
    h = np.linalg.solve(A, b)
    return np.append(h, 1.0).reshape(3, 3)


def crop_geometry(box: np.ndarray) -> Tuple[int, int]:
    """Crop width/height of a quad as the reference computes them."""
    pts = np.asarray(box, dtype=np.float32)
    w = int(max(np.linalg.norm(pts[0] - pts[1]),
                np.linalg.norm(pts[2] - pts[3])))
    h = int(max(np.linalg.norm(pts[0] - pts[3]),
                np.linalg.norm(pts[1] - pts[2])))
    return w, h


def _affine(a, b, c, d, tx, ty) -> np.ndarray:
    return np.array([[a, b, tx], [c, d, ty], [0, 0, 1.0]])


def build_crop_matrix(box: np.ndarray, out_h: int, bucket_w: int,
                      rotate180: bool = False) -> Tuple[np.ndarray, int]:
    """Dest→source matrix for one crop: perspective warp to (cw, ch), rot90
    if ch/cw >= 1.5, optional 180°, then resize height → out_h at width
    ceil(out_h·ratio) capped at bucket_w. → (3×3 float32, resized_w)."""
    pts = np.asarray(box, dtype=np.float32).reshape(4, 2)
    cw, ch = crop_geometry(pts)
    cw = max(cw, 1)
    ch = max(ch, 1)
    dst_std = np.array([[0, 0], [cw, 0], [cw, ch], [0, ch]], dtype=np.float32)
    M_inv = perspective_transform(dst_std, pts)
    if ch * 1.0 / cw >= 1.5:
        M_inv = M_inv @ _affine(0, -1, 1, 0, cw - 1.0, 0.0)
        cw, ch = ch, cw
    if rotate180:
        M_inv = M_inv @ _affine(-1, 0, 0, -1, cw - 1.0, ch - 1.0)
    ratio = cw / float(ch)
    if int(np.ceil(out_h * ratio)) > bucket_w:
        resized_w = bucket_w
    else:
        resized_w = max(1, int(np.ceil(out_h * ratio)))
    sx = cw / float(resized_w)
    sy = ch / float(out_h)
    M = M_inv @ _affine(sx, 0, 0, sy, 0.5 * sx - 0.5, 0.5 * sy - 0.5)
    return M.astype(np.float32), resized_w


def warp_crops(image_u8: torch.Tensor, mats: torch.Tensor,
               valid_w: torch.Tensor, out_h: int, out_w: int,
               interp: str = "bilinear") -> torch.Tensor:
    """image_u8 (H, W, 3) uint8, mats (N, 3, 3) float32 dest→source,
    valid_w (N,) int → (N, out_h, out_w, 3) float32 crops in [−1, 1], zero
    at columns >= valid_w."""
    if interp != "bilinear":
        raise NotImplementedError(f"tpu_warp_interp={interp!r} is not "
                                  "ported; only 'bilinear' is")
    H, W = image_u8.shape[:2]
    dev = image_u8.device
    flat = image_u8.reshape(-1, 3)
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32,
                                         device=dev),
                            torch.arange(out_w, dtype=torch.float32,
                                         device=dev), indexing="ij")
    m = mats[:, :, :, None, None]
    u = m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]
    v = m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]
    w = m[:, 2, 0] * gx + m[:, 2, 1] * gy + m[:, 2, 2]
    inv_w = 1.0 / w
    sx = torch.clamp(u * inv_w, 0.0, W - 1.0)
    sy = torch.clamp(v * inv_w, 0.0, H - 1.0)
    # dead lanes (gx >= valid_w) are zeroed below; pin them to one index
    live = gx[None] < valid_w[:, None, None]
    sx = torch.where(live, sx, 0.0)
    sy = torch.where(live, sy, 0.0)

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)

    def tap(yy, xx):
        yy = torch.clamp(yy, 0, H - 1)
        xx = torch.clamp(xx, 0, W - 1)
        return flat[yy * W + xx].to(torch.float32)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    vals = torch.clamp(top * (1 - fy) + bot * fy, 0.0, 255.0)
    norm = (vals / 255.0 - 0.5) / 0.5
    return torch.where(live[..., None], norm, 0.0)

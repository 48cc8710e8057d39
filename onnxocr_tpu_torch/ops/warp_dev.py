"""Device-side crop-matrix construction from detector quads, batched over K
boxes. Port of onnxocr_tpu/ops/warp_dev.py: clockwise order → clip → side
filter (reference filter_tag_det_res) → rect→quad homography, rot90-if-tall,
180° variant and resize affine (the ops/warp.build_crop_matrix contract, in
float32 on the device).
"""
from __future__ import annotations

from typing import Tuple

import torch


def order_points_clockwise(quads: torch.Tensor) -> torch.Tensor:
    """(K, 4, 2) → [tl, tr, br, bl]: the two smallest-x points (stable on
    ties) form the left pair, each pair ordered by y."""
    order = torch.argsort(quads[:, :, 0], dim=1, stable=True)
    q = torch.gather(quads, 1, order[:, :, None].expand(-1, -1, 2))
    left, right = q[:, :2], q[:, 2:]
    left = torch.where((left[:, 0, 1] <= left[:, 1, 1])[:, None, None],
                       left, left.flip(1))
    right = torch.where((right[:, 0, 1] <= right[:, 1, 1])[:, None, None],
                        right, right.flip(1))
    return torch.stack([left[:, 0], right[:, 0], right[:, 1], left[:, 1]],
                       dim=1)


def clip_filter_boxes(quads: torch.Tensor, src_h: int, src_w: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clip to the image; keep boxes whose int side lengths are > 3 px."""
    x = torch.clamp(quads[..., 0], 0.0, src_w - 1.0)
    y = torch.clamp(quads[..., 1], 0.0, src_h - 1.0)
    q = torch.stack([x, y], dim=-1)
    rect_w = torch.floor(torch.linalg.vector_norm(q[:, 0] - q[:, 1], dim=-1))
    rect_h = torch.floor(torch.linalg.vector_norm(q[:, 0] - q[:, 3], dim=-1))
    return q, (rect_w > 3) & (rect_h > 3)


def _affine(a, b, c, d, tx, ty) -> torch.Tensor:
    """(K, 3, 3) affines from (K,) tensors."""
    one = torch.ones_like(tx)
    zero = torch.zeros_like(tx)
    return torch.stack([torch.stack([a * one, b * one, tx], -1),
                        torch.stack([c * one, d * one, ty], -1),
                        torch.stack([zero, zero, one], -1)], 1)


def crop_matrices(quads: torch.Tensor, valid: torch.Tensor, out_h: int,
                  bucket_w: int):
    """quads (K, 4, 2) clockwise source-coord boxes; invalid rows solve a
    safe identity target. → (mats (K, 3, 3), mats_rot180 (K, 3, 3),
    valid_w (K,) int32 capped at bucket_w, desired_w (K,) int32 uncapped)."""
    def norm(a, b):
        return torch.linalg.vector_norm(a - b, dim=-1)

    q = quads
    cw = torch.floor(torch.maximum(norm(q[:, 0], q[:, 1]),
                                   norm(q[:, 2], q[:, 3])))
    ch = torch.floor(torch.maximum(norm(q[:, 0], q[:, 3]),
                                   norm(q[:, 1], q[:, 2])))
    cw = torch.clamp(cw, min=1.0)
    ch = torch.clamp(ch, min=1.0)
    zero = torch.zeros_like(cw)
    src = torch.stack([torch.stack([zero, zero], -1),
                       torch.stack([cw, zero], -1),
                       torch.stack([cw, ch], -1),
                       torch.stack([zero, ch], -1)], 1)     # (K, 4, 2)
    pts = torch.where(valid[:, None, None], q, src)

    # H mapping the rect (0,0)-(cw,ch) onto pts: 8×8 system per box
    x, y = src[..., 0], src[..., 1]
    u, v = pts[..., 0], pts[..., 1]
    one, z = torch.ones_like(x), torch.zeros_like(x)
    row_u = torch.stack([x, y, one, z, z, z, -u * x, -u * y], -1)
    row_v = torch.stack([z, z, z, x, y, one, -v * x, -v * y], -1)
    A = torch.stack([row_u, row_v], 2).reshape(-1, 8, 8)
    b = torch.stack([u, v], 2).reshape(-1, 8)
    h, _ = torch.linalg.solve_ex(A, b)
    M_inv = torch.cat([h, torch.ones_like(h[:, :1])], 1).reshape(-1, 3, 3)

    tall = ch / cw >= 1.5
    rot90 = _affine(0.0, -1.0, 1.0, 0.0, cw - 1.0, zero)
    M_inv = torch.where(tall[:, None, None], M_inv @ rot90, M_inv)
    cw2 = torch.where(tall, ch, cw)
    ch2 = torch.where(tall, cw, ch)
    M_rot = M_inv @ _affine(-1.0, 0.0, 0.0, -1.0, cw2 - 1.0, ch2 - 1.0)

    desired = torch.ceil(out_h * (cw2 / ch2))
    resized_w = torch.clamp(desired, 1.0, float(bucket_w))
    sx = cw2 / resized_w
    sy = ch2 / float(out_h)
    rs = _affine(sx, 0.0, 0.0, sy, 0.5 * sx - 0.5, 0.5 * sy - 0.5)
    return (M_inv @ rs, M_rot @ rs, resized_w.to(torch.int32),
            desired.to(torch.int32))

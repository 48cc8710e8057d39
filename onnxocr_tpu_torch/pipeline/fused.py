"""Fused cls→rec device step: one pass per width bucket with one download.
Counterpart of onnxocr_tpu/pipeline/fused.py (`FusedClsRec.__call__` and
`call_scored`):

    warp 48×192 cls crops from the uploaded page → cls forward → rotation
    verdict on the device → select between the two precomputed homographies
    (upright / turned by 180°) → warp 48×W rec crops → SVTR → fused CTC head

`__call__` downloads one packed (N, 2T + 3) float32 buffer [idx (T), prob
(T), cls probs (2), rot (1)]. `call_scored`, the bitmap wire's step, also
scores the DB candidates' pre-unclip quads against the prob map that stayed
on the device, and downloads (N, 2T + 1) [idx, prob, score]. The
cross-page variants of the reference (`call_multi`, `call_multi_scored`)
belong to its batchers and are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import config
from ..ops import db_device
from ..ops import warp as warp_ops


class FusedClsRec:
    def __init__(self, cls_forward, rec_forward, cls_shape=(48, 192),
                 cls_thresh: float = 0.9, idx180: Optional[int] = 1,
                 warp_form: Optional[dict] = None):
        self.cls_forward = cls_forward
        self.rec_forward = rec_forward
        self.cls_h, self.cls_w = cls_shape
        self.cls_thresh = cls_thresh
        self.idx180 = idx180
        # the warp form of every crop of the step (ops/warp.form_of)
        self.warp_form = warp_form or warp_ops.form_of(config.make_params())

    def warp(self, image_u8, mats, valid_w, out_h: int, out_w: int):
        """Crops of the step, in the step's warp form."""
        return warp_ops.warp_crops(image_u8, mats, valid_w, out_h, out_w,
                                   **self.warp_form)

    def select_mats(self, image_u8, cls_mats, cls_valid, rec_mats,
                    rec_mats_rot):
        """The cls half: → (mats (N, 3, 3) with the 180° homography where
        the classifier says so, cls probs (N, 2), rot (N,) bool)."""
        crops = self.warp(image_u8, cls_mats, cls_valid, self.cls_h,
                          self.cls_w)
        probs = self.cls_forward(crops)
        rot = (torch.argmax(probs, dim=1) == self.idx180) & \
            (probs[:, self.idx180] > self.cls_thresh)
        return torch.where(rot[:, None, None], rec_mats_rot, rec_mats), \
            probs, rot

    def _cls_rec(self, image_u8, cls_mats, cls_valid, rec_mats,
                 rec_mats_rot, rec_valid, out_h: int, out_w: int,
                 use_cls: bool):
        """→ (idx (N, T), prob (N, T), cls probs (N, 2), rot (N,)) on the
        device; cls probs and rot are 0 when the classifier is off."""
        n = rec_mats.shape[0]
        dev = image_u8.device
        if use_cls:
            mats, cls_probs, rot = self.select_mats(
                image_u8, cls_mats, cls_valid, rec_mats, rec_mats_rot)
        else:
            mats = rec_mats
            cls_probs = torch.zeros((n, 2), device=dev)
            rot = torch.zeros((n,), dtype=torch.bool, device=dev)
        crops = self.warp(image_u8, mats, rec_valid, out_h, out_w)
        idx, prob = self.rec_forward(crops, (rec_valid + 7) // 8)
        return idx, prob, cls_probs, rot

    @torch.inference_mode()
    def __call__(self, image_u8: torch.Tensor, cls_mats, cls_valid,
                 rec_mats, rec_mats_rot, rec_valid, out_h: int, out_w: int,
                 use_cls: bool = True) -> torch.Tensor:
        """image_u8 (H, W, 3) uint8 on the device; matrices (N, 3, 3) and
        valid widths (N,) as numpy arrays or tensors → packed (N, 2T + 3)
        float32 tensor on the device."""
        dev = image_u8.device
        idx, prob, cls_probs, rot = self._cls_rec(
            image_u8, *(torch.as_tensor(a).to(dev) for a in (
                cls_mats, cls_valid, rec_mats, rec_mats_rot, rec_valid)),
            out_h, out_w, use_cls)
        f32 = torch.float32
        return torch.cat([idx.to(f32), prob.to(f32), cls_probs.to(f32),
                          rot.to(f32)[:, None]], -1)

    @torch.inference_mode()
    def call_scored(self, image_u8: torch.Tensor, prob: torch.Tensor,
                    r_h: int, r_w: int, pre_quads, cls_mats, cls_valid,
                    rec_mats, rec_mats_rot, rec_valid, out_h: int, out_w: int,
                    use_cls: bool = True) -> torch.Tensor:
        """The bitmap wire's step: `__call__`'s crops and head, and each
        row's pre-unclip quad (N, 4, 2) in map coordinates scored against
        the (H, W) prob map on the device (valid r_h × r_w). Padding rows
        carry zero quads, which score 0. → packed (N, 2T + 1) float32 [idx,
        prob, score] on the device."""
        dev = image_u8.device
        H, W = prob.shape
        in_valid = (torch.arange(H, device=dev)[:, None] < r_h) & \
            (torch.arange(W, device=dev)[None, :] < r_w)
        scores = db_device.quad_mask_mean(
            prob, torch.as_tensor(pre_quads).to(dev), in_valid)
        idx, prob_max, _, _ = self._cls_rec(
            image_u8, *(torch.as_tensor(a).to(dev) for a in (
                cls_mats, cls_valid, rec_mats, rec_mats_rot, rec_valid)),
            out_h, out_w, use_cls)
        f32 = torch.float32
        return torch.cat([idx.to(f32), prob_max.to(f32),
                          scores.to(f32)[:, None]], -1)

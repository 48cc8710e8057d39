"""Fused cls→rec device step: one pass per width bucket with one download.
Counterpart of onnxocr_tpu/pipeline/fused.py (`FusedClsRec.__call__` and
`call_scored`):

    warp 48×192 cls crops from the uploaded page → cls forward → rotation
    verdict on the device → select between the two precomputed homographies
    (upright / turned by 180°) → warp 48×W rec crops → SVTR → fused CTC head
    (or CRNN → logits → reduce)

`__call__` downloads one packed (N, 2T + 3) float32 buffer [idx (T), prob
(T), cls probs (2), rot (1)]. `call_scored`, the bitmap wire's step, also
scores the DB candidates' pre-unclip quads against the prob map that stayed
on the device, and downloads (N, 2T + 1) [idx, prob, score]. The
cross-request rec batcher's variants take their crops from a stack of pages
(`warp_crops_multi`, always the gather form, as in the JAX package):
`call_multi` → (N, 2T) [idx, prob], and `call_multi_scored` → (N, 2T + 1),
each quad scored against its own page's prob map.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from .. import config
from ..ops import db_device
from ..ops import warp as warp_ops
from ..utils.profiling import CAPTURE


def _on(dev, *arrays):
    """numpy arrays or tensors → tensors on `dev`."""
    return tuple(torch.as_tensor(a).to(dev) for a in arrays)


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
        return self._select(partial(self.warp, image_u8), cls_mats,
                            cls_valid, rec_mats, rec_mats_rot)

    def _select(self, warp, cls_mats, cls_valid, rec_mats, rec_mats_rot):
        """select_mats with the crops of `warp(mats, valid_w, out_h,
        out_w)`."""
        probs = self.cls_forward(warp(cls_mats, cls_valid, self.cls_h,
                                      self.cls_w))
        rot = (torch.argmax(probs, dim=1) == self.idx180) & \
            (probs[:, self.idx180] > self.cls_thresh)
        return torch.where(rot[:, None, None], rec_mats_rot, rec_mats), \
            probs, rot

    def _cls_rec(self, warp, cls_mats, cls_valid, rec_mats, rec_mats_rot,
                 rec_valid, out_h: int, out_w: int, use_cls: bool):
        """The crops of `warp(mats, valid_w, out_h, out_w)` → (idx (N, T),
        prob (N, T), cls probs (N, 2), rot (N,)) on the device; cls probs
        and rot are 0 when the classifier is off."""
        n = rec_mats.shape[0]
        dev = rec_mats.device
        if use_cls:
            mats, cls_probs, rot = self._select(
                warp, cls_mats, cls_valid, rec_mats, rec_mats_rot)
        else:
            mats = rec_mats
            cls_probs = torch.zeros((n, 2), device=dev)
            rot = torch.zeros((n,), dtype=torch.bool, device=dev)
        crops = warp(mats, rec_valid, out_h, out_w)
        idx, prob = self.rec_forward(crops,
                                     self.rec_forward.valid_t(rec_valid))
        return idx, prob, cls_probs, rot

    def _multi(self, images_u8, img_idx, mats, out_h: int, out_w: int,
               use_cls: bool):
        """The multi-page step's (idx, prob) over the crops of `images_u8`
        (B, H, W, 3); img_idx and the five matrix / width arrays of `mats`
        as numpy arrays or tensors."""
        img_idx, *mats = _on(images_u8.device, img_idx, *mats)

        def warp(m, valid_w, h, w):
            return warp_ops.warp_crops_multi(images_u8, img_idx, m, valid_w,
                                             h, w, self.warp_form["interp"])

        return self._cls_rec(warp, *mats, out_h, out_w, use_cls)[:2]

    @torch.inference_mode()
    def __call__(self, image_u8: torch.Tensor, cls_mats, cls_valid,
                 rec_mats, rec_mats_rot, rec_valid, out_h: int, out_w: int,
                 use_cls: bool = True) -> torch.Tensor:
        """image_u8 (H, W, 3) uint8 on the device; matrices (N, 3, 3) and
        valid widths (N,) as numpy arrays or tensors → packed (N, 2T + 3)
        float32 tensor on the device."""
        dev = image_u8.device
        idx, prob, cls_probs, rot = self._cls_rec(
            partial(self.warp, image_u8), *_on(
                dev, cls_mats, cls_valid, rec_mats, rec_mats_rot, rec_valid),
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
        mats = _on(dev, pre_quads, cls_mats, cls_valid, rec_mats,
                   rec_mats_rot, rec_valid)
        if CAPTURE.enabled:
            CAPTURE.record("fused_scored",
                           partial(self.call_scored, use_cls=use_cls),
                           (image_u8, prob, r_h, r_w, *mats, out_h, out_w))
        H, W = prob.shape
        in_valid = (torch.arange(H, device=dev)[:, None] < r_h) & \
            (torch.arange(W, device=dev)[None, :] < r_w)
        scores = db_device.quad_mask_mean(prob, mats[0], in_valid)
        idx, prob_max, _, _ = self._cls_rec(
            partial(self.warp, image_u8), *mats[1:], out_h, out_w, use_cls)
        f32 = torch.float32
        return torch.cat([idx.to(f32), prob_max.to(f32),
                          scores.to(f32)[:, None]], -1)

    @torch.inference_mode()
    def call_multi(self, images_u8: torch.Tensor, img_idx, cls_mats,
                   cls_valid, rec_mats, rec_mats_rot, rec_valid, out_h: int,
                   out_w: int, use_cls: bool = True) -> torch.Tensor:
        """The rec batcher's step over a stack of pages: images_u8 (B, H, W,
        3) uint8 on the device, img_idx (N,) the page of each row, the rest
        as `__call__` → packed (N, 2T) float32 [idx, prob] on the device."""
        idx, prob = self._multi(images_u8, img_idx, (
            cls_mats, cls_valid, rec_mats, rec_mats_rot, rec_valid),
            out_h, out_w, use_cls)
        return torch.cat([idx.to(torch.float32), prob.to(torch.float32)], -1)

    @torch.inference_mode()
    def call_multi_scored(self, images_u8: torch.Tensor, probs: torch.Tensor,
                          rhw, img_idx, pre_quads, cls_mats, cls_valid,
                          rec_mats, rec_mats_rot, rec_valid, out_h: int,
                          out_w: int, use_cls: bool = True) -> torch.Tensor:
        """call_multi whose every row also scores its pre-unclip quad
        against its own page's prob map: probs (B, Hm, Wm) on the device,
        rhw (B, 2) the maps' valid extents, pre_quads (N, 4, 2) in map
        coordinates → packed (N, 2T + 1) float32 [idx, prob, score] on the
        device."""
        dev = images_u8.device
        scores = db_device.quad_mask_mean_multi(
            probs, *_on(dev, rhw, pre_quads, img_idx))
        idx, prob = self._multi(images_u8, img_idx, (
            cls_mats, cls_valid, rec_mats, rec_mats_rot, rec_valid),
            out_h, out_w, use_cls)
        f32 = torch.float32
        return torch.cat([idx.to(f32), prob.to(f32), scores.to(f32)[:, None]],
                         -1)

"""One-call OCR on the device: det → DB boxes → crop matrices → rec → CTC
head, with one device→host copy of a packed buffer per page.

Port of onnxocr_tpu/pipeline/onecall.py (single page):

    upload the edge-padded page → resize + normalize into the fixed det
    canvas → DBNet → device DB extraction in the extraction window →
    rescale / clockwise / clip / side filter → compact valid boxes into a
    K_rec prefix → crop homographies → (with the classifier: warp 48×192
    cls crops → cls → select the 180°-turned homographies) → warp rec
    crops at one width (shear-staged by default) → SVTR → fused CTC head
    → one packed (K_rec + 1 + det rows, 12 + 2T) float32 buffer

Packed layout (as in the JAX package): K_rec body rows [quad (8), score,
valid, valid width, desired width, idx (T), prob (T)]; a tail row whose
first entry is n_valid; then all K_det filtered quads + valid flags,
flattened into rows of the same width. Wide lines (desired width > the rec
width) and boxes past K_rec re-run through the recognizer's fused
per-bucket path against the same uploaded page.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..ops import db_device, det_pre, resize_dev, warp_dev


class OneCallPipeline:
    def __init__(self, detector, recognizer, fused, args,
                 device: torch.device):
        self.detector = detector
        self.recognizer = recognizer
        self.fused = fused
        self.device = device
        self.rec_w = int(args.tpu_onecall_rec_width)
        self.k_rec = int(args.tpu_onecall_max_boxes)
        self.k_det = int(args.tpu_onecall_det_candidates)
        self.imgH = recognizer.rec_image_shape[1]
        self.extract_scale = db_device.parse_extract_scale(
            args.tpu_det_extract_scale)
        self.score_scale = db_device.parse_extract_scale(
            args.tpu_det_score_scale)
        self.db_reduce = str(args.tpu_db_reduce)
        self.score_k = int(args.tpu_det_score_k)
        self.axis_snap = float(args.tpu_det_axis_snap)
        self.ex_bucket = int(args.tpu_det_extract_window)

    def _ex_window(self, rh: int, rw: int, hb: int, wb: int
                   ) -> Tuple[int, int]:
        """Extraction window for a page's valid size; (0, 0) = off."""
        b = self.ex_bucket
        if not b:
            return 0, 0
        return (min(hb, det_pre.round_up(max(rh, 1), b)),
                min(wb, det_pre.round_up(max(rw, 1), b)))

    def canvas(self, src_h: int, src_w: int):
        """→ (rh, rw) resize target, (hb, wb) det canvas, (eh, ew) window."""
        det = self.detector
        rh, rw = det_pre.det_resize_target(src_h, src_w, det.limit_side_len)
        # one fixed square canvas for every page: the valid_hw masking makes
        # the det map over the valid region independent of the padding
        cap = det_pre.round_up(int(det.limit_side_len), det.bucket)
        hb = wb = max(cap, det_pre.round_up(max(rh, rw), det.bucket))
        return (rh, rw), (hb, wb), self._ex_window(rh, rw, hb, wb)

    def source_boxes(self, quads_m, scores, valid, r_h: int, r_w: int,
                     src_h: int, src_w: int):
        """Det-map boxes → (quads_s, valid, quads_c, scores_c, valid_c): every
        candidate in source coordinates (rounded, clipped to [0, src], in
        the reference's clockwise order, clip and side filter applied) and
        the K_rec prefix of the valid ones, raster order kept."""
        qx = torch.clamp(torch.round(quads_m[..., 0] / float(r_w) * src_w),
                         0.0, float(src_w))
        qy = torch.clamp(torch.round(quads_m[..., 1] / float(r_h) * src_h),
                         0.0, float(src_h))
        quads_s = warp_dev.order_points_clockwise(torch.stack([qx, qy], -1))
        quads_s, keep = warp_dev.clip_filter_boxes(quads_s, src_h, src_w)
        valid = valid & keep
        take = torch.argsort((~valid).to(torch.int32), stable=True)[:self.k_rec]
        return quads_s, valid, quads_s[take], scores[take], valid[take]

    @torch.inference_mode()
    def step(self, image_u8: torch.Tensor, src_h: int, src_w: int,
             r_h: int, r_w: int, out_h: int, out_w: int, ex_h: int = 0,
             ex_w: int = 0, use_cls: bool = False) -> torch.Tensor:
        """The single-page program: → packed float32 buffer on the device."""
        pp = self.detector.postprocess_op
        x = resize_dev.resize_normalize_det(image_u8, src_h, src_w, r_h, r_w,
                                            out_h, out_w)
        prob = self.detector.model(x.permute(2, 0, 1)[None],
                                   valid_hw=(r_h, r_w))[0]
        if ex_h and ex_w and (ex_h < out_h or ex_w < out_w):
            prob = prob[:ex_h, :ex_w]
        quads_m, scores, valid = db_device.device_boxes(
            prob.contiguous(), r_h, r_w, max_k=self.k_det, thresh=pp.thresh,
            box_thresh=pp.box_thresh, unclip_ratio=pp.unclip_ratio,
            min_size=float(pp.min_size), scale=self.extract_scale,
            score_scale=self.score_scale, reduce=self.db_reduce,
            score_k=self.score_k, axis_snap=self.axis_snap)

        quads_s, valid, quads_c, scores_c, valid_c = self.source_boxes(
            quads_m, scores, valid, r_h, r_w, src_h, src_w)
        n_valid = valid.sum()
        rec_m, rec_m_rot, rec_vw, desired = warp_dev.crop_matrices(
            quads_c, valid_c, self.imgH, self.rec_w)
        rec_vw = torch.where(valid_c, rec_vw, 0)
        if use_cls:
            fused = self.fused
            cls_m, _, cls_vw, _ = warp_dev.crop_matrices(
                quads_c, valid_c, fused.cls_h, fused.cls_w)
            rec_m, _, _ = fused.select_mats(
                image_u8, cls_m, torch.where(valid_c, cls_vw, 0), rec_m,
                rec_m_rot)
        crops = self.fused.warp(image_u8, rec_m, rec_vw, self.imgH,
                                self.rec_w)
        idx, prob_max = self.recognizer.forward(crops, (rec_vw + 7) // 8)

        k_rec = quads_c.shape[0]
        T = idx.shape[1]
        wbuf = 12 + 2 * T
        f32 = torch.float32
        body = torch.cat([quads_c.reshape(k_rec, 8), scores_c[:, None],
                          valid_c[:, None].to(f32), rec_vw[:, None].to(f32),
                          desired[:, None].to(f32), idx.to(f32),
                          prob_max.to(f32)], -1)
        tail = torch.zeros((1, wbuf), dtype=f32, device=body.device)
        tail[0, 0] = n_valid.to(f32)
        det_flat = torch.cat([quads_s.reshape(-1, 8),
                              valid[:, None].to(f32)], -1).reshape(-1)
        n_det_rows = -(-det_flat.shape[0] // wbuf)
        det_block = torch.cat([det_flat, det_flat.new_zeros(
            n_det_rows * wbuf - det_flat.shape[0])]).reshape(n_det_rows, wbuf)
        return torch.cat([body, tail, det_block], 0)

    def use_cls(self, cls: bool) -> bool:
        """Whether a call with `cls` runs the classifier."""
        return bool(cls and self.fused.cls_forward is not None and
                    self.fused.idx180 is not None)

    def run_packed(self, img: np.ndarray, use_cls: bool = False):
        """Upload a BGR page and run the program → (packed numpy buffer,
        uploaded page on the device)."""
        image_dev, src_h, src_w = resize_dev.put_src_bucket(img, self.device)
        (rh, rw), (hb, wb), (eh, ew) = self.canvas(src_h, src_w)
        packed = self.step(image_dev, src_h, src_w, rh, rw, hb, wb, eh, ew,
                           use_cls)
        return packed.cpu().numpy(), image_dev

    def __call__(self, img: np.ndarray, cls: bool = False
                 ) -> Tuple[np.ndarray, List[Tuple[str, float]]]:
        """→ (boxes (N, 4, 2) float32, [(text, score)]) in device (raster)
        order; the caller applies the sorted-boxes pairing and drop_score."""
        use_cls = self.use_cls(cls)
        packed, image_dev = self.run_packed(img, use_cls)
        return self.decode_packed(packed, image_dev, use_cls)

    def _rerun(self, image_dev, boxes, use_cls: bool):
        fused = self.fused
        return self.recognizer.run_boxes_fused(
            image_dev, boxes, fused, (fused.cls_h, fused.cls_w),
            use_cls=use_cls)

    def decode_packed(self, packed: np.ndarray, image_dev: torch.Tensor,
                      use_cls: bool = False
                      ) -> Tuple[np.ndarray, List[Tuple[str, float]]]:
        body = packed[:self.k_rec]
        n_valid = int(packed[self.k_rec, 0])
        rows = body[body[:, 9] > 0.5]
        if n_valid == 0 or rows.shape[0] == 0:
            return np.zeros((0, 4, 2), np.float32), []
        boxes = rows[:, :8].reshape(-1, 4, 2).astype(np.float32)
        rec_vw = rows[:, 10].astype(np.int32)
        desired = rows[:, 11].astype(np.int32)
        T = (body.shape[1] - 12) // 2
        idx = rows[:, 12:12 + T].astype(np.int32)
        prob_max = rows[:, 12 + T:]
        stride = self.rec_w // T
        valid_t = [min(T, int(math.ceil(w / stride))) for w in rec_vw]
        rec_res = self.recognizer.postprocess_op.decode_indices(
            idx, prob_max, is_remove_duplicate=True, valid_t=valid_t)

        wide = np.nonzero(desired > self.rec_w)[0]
        if len(wide):
            redo = self._rerun(image_dev, boxes[wide], use_cls)
            for i, res in zip(wide, redo):
                rec_res[i] = res

        if n_valid > self.k_rec:
            # the det block carries every filtered quad: keep the K_rec
            # prefix results, recognize only the remainder
            det_flat = packed[self.k_rec + 1:].reshape(-1)
            det_rows = det_flat[:self.k_det * 9].reshape(self.k_det, 9)
            boxes_all = det_rows[det_rows[:, 8] > 0.5, :8].reshape(
                -1, 4, 2).astype(np.float32)
            rest = self._rerun(image_dev, boxes_all[self.k_rec:], use_cls)
            return boxes_all, rec_res + rest
        return boxes, rec_res

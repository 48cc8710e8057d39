"""CTC text recognizer on the device. Counterpart of
onnxocr_tpu/pipeline/recognizer.py: the SVTR forward through the fused CTC
head kernel, and the two per-width-bucket paths over boxes of an uploaded
page — `run_boxes_fused` (cls + rec in one pass per bucket through
pipeline/fused.py: the staged device-det path, and the one-call pipeline's
re-runs for wide lines and boxes past its K_rec budget),
`run_candidates_scored` (the same pass scoring the bitmap wire's DB
candidates against the prob map on the device) and `run_boxes` (rec alone,
rotation verdicts given by the caller).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import config
from ..models import convert
from ..ops import ctc
from ..ops import warp as warp_ops
from ..ops.kernels import ctc_head
from . import backends, batching


class RecForward:
    """(N, 48, W, 3) float32 crops in [−1, 1] + (N,) valid token counts →
    ((N, T) int32 argmax, (N, T) float32 max-prob) via the fused head."""

    def __init__(self, tree, device: torch.device):
        self.model = convert.build_svtr(tree, device)

    @torch.inference_mode()
    def __call__(self, crops: torch.Tensor, valid_t: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.model.features(crops.permute(0, 3, 1, 2), valid_t)
        head = self.model.head
        return ctc_head.ctc_head_reduce_batched(feats, head.w_split, head.b)


class TextRecognizer:
    def __init__(self, args, device: torch.device):
        self.device = device
        self.rec_image_shape = config.parse_shape(args.rec_image_shape)
        self.width_ladder = tuple(args.tpu_rec_width_buckets)
        self.batch_ladder = tuple(args.tpu_batch_buckets)
        self.warp_form = warp_ops.form_of(args)
        self.postprocess_op = ctc.CTCLabelDecode(
            character_dict_path=args.rec_char_dict_path,
            use_space_char=args.use_space_char)
        if backends.pick_arch("rec", args.rec_model_dir,
                              args.rec_algorithm) != "svtr":
            raise NotImplementedError("the CRNN recognizer is not ported")
        tree, _ = backends.load_native_params("rec", args.rec_model_dir)
        if getattr(args, "tpu_decode_support", "trained") == "trained":
            sup = backends.trained_support(args.rec_char_dict_path)
            if sup is not None:
                tree = backends.apply_support_bias(tree, sup)
        self.forward = RecForward(tree, device)

    def desired_widths(self, boxes: np.ndarray) -> List[int]:
        imgH = self.rec_image_shape[1]
        min_w = int(self.rec_image_shape[2])
        desired = []
        for b in boxes:
            cw, ch = warp_ops.crop_geometry(b)
            cw = max(cw, 1)
            ch = max(ch, 1)
            if ch / cw >= 1.5:
                cw, ch = ch, cw
            desired.append(max(min_w, math.ceil(imgH * cw / ch)))
        return desired

    def _decode(self, idx: np.ndarray, prob: np.ndarray, valid_w,
                bucket_w: int) -> List[Tuple[str, float]]:
        """Rows of argmax / max-prob → [(text, score)] over each row's valid
        (un-padded) time steps."""
        stride = bucket_w // idx.shape[1]
        valid_t = [min(idx.shape[1], math.ceil(w / stride)) for w in valid_w]
        return self.postprocess_op.decode_indices(
            idx, prob, is_remove_duplicate=True, valid_t=valid_t)

    def run_boxes(self, image_u8: torch.Tensor, boxes: np.ndarray,
                  rot180: Optional[np.ndarray] = None
                  ) -> List[Tuple[str, float]]:
        """image_u8: (H, W, 3) uint8 source on the device; boxes (N, 4, 2)
        source coords; rot180 (N,) bool from the angle classifier →
        [(text, score)] in box order. One device call per (width bucket,
        chunk of at most the top batch size)."""
        n = len(boxes)
        if n == 0:
            return []
        if rot180 is None:
            rot180 = np.zeros(n, dtype=bool)
        imgH = self.rec_image_shape[1]
        results: List[Tuple[str, float]] = [("", 0.0)] * n
        groups = batching.group_collapsed(self.desired_widths(boxes),
                                          self.width_ladder)
        eye = np.eye(3, dtype=np.float32)
        for bucket_w, indices in groups.items():
            for chunk in batching.chunks_of(indices, self.batch_ladder[-1]):
                k = len(chunk)
                bsz = batching.pick_batch_bucket(k, self.batch_ladder)
                mats = np.tile(eye, (bsz, 1, 1))
                valid = np.zeros(bsz, np.int32)
                for row, i in enumerate(chunk):
                    mats[row], valid[row] = warp_ops.build_crop_matrix(
                        boxes[i], imgH, bucket_w, rotate180=bool(rot180[i]))
                valid_dev = torch.from_numpy(valid).to(self.device)
                crops = warp_ops.warp_crops(
                    image_u8, torch.from_numpy(mats).to(self.device),
                    valid_dev, imgH, bucket_w, **self.warp_form)
                idx, prob = self.forward(crops, (valid_dev + 7) // 8)
                out = self._decode(idx[:k].cpu().numpy(),
                                   prob[:k].cpu().numpy(), valid[:k],
                                   bucket_w)
                for i, res in zip(chunk, out):
                    results[i] = res
        return results

    def _fused_chunks(self, boxes: np.ndarray, cls_shape):
        """The fused passes over `boxes`, one per (width bucket, chunk of at
        most the top batch size) → (bucket_w, chunk indices, (cls_mats,
        cls_valid, rec_mats, rot_mats, rec_valid)) with the inputs padded
        to the chunk's batch bucket: rows past the chunk keep the identity
        and a valid width of 0."""
        imgH = self.rec_image_shape[1]
        cls_h, cls_w = cls_shape
        groups = batching.group_collapsed(self.desired_widths(boxes),
                                          self.width_ladder)
        eye = np.eye(3, dtype=np.float32)
        for bucket_w, indices in groups.items():
            for chunk in batching.chunks_of(indices, self.batch_ladder[-1]):
                bsz = batching.pick_batch_bucket(len(chunk), self.batch_ladder)
                rec_mats = np.tile(eye, (bsz, 1, 1))
                rot_mats = np.tile(eye, (bsz, 1, 1))
                cls_mats = np.tile(eye, (bsz, 1, 1))
                rec_valid = np.zeros(bsz, np.int32)
                cls_valid = np.zeros(bsz, np.int32)
                for row, i in enumerate(chunk):
                    rec_mats[row], rec_valid[row] = \
                        warp_ops.build_crop_matrix(boxes[i], imgH, bucket_w)
                    rot_mats[row], _ = warp_ops.build_crop_matrix(
                        boxes[i], imgH, bucket_w, rotate180=True)
                    cls_mats[row], cls_valid[row] = \
                        warp_ops.build_crop_matrix(boxes[i], cls_h, cls_w)
                yield bucket_w, chunk, (cls_mats, cls_valid, rec_mats,
                                        rot_mats, rec_valid)

    def run_boxes_fused(self, image_u8: torch.Tensor, boxes: np.ndarray,
                        fused, cls_shape, use_cls: bool = True
                        ) -> List[Tuple[str, float]]:
        """One fused device pass and one download per (width bucket, chunk):
        the classifier's verdicts select the 180°-turned homographies on the
        device (pipeline/fused.py), so nothing returns to the host between
        cls and rec. Arguments as run_boxes; cls_shape = (cls_h, cls_w)."""
        results: List[Tuple[str, float]] = [("", 0.0)] * len(boxes)
        imgH = self.rec_image_shape[1]
        for bucket_w, chunk, mats in self._fused_chunks(boxes, cls_shape):
            k = len(chunk)
            packed = fused(image_u8, *mats, imgH, bucket_w,
                           use_cls=use_cls).cpu().numpy()
            T = (packed.shape[1] - 3) // 2
            out = self._decode(packed[:k, :T].astype(np.int32),
                               packed[:k, T:2 * T], mats[-1][:k], bucket_w)
            for i, res in zip(chunk, out):
                results[i] = res
        return results

    def run_candidates_scored(self, image_u8: torch.Tensor,
                              prob: torch.Tensor, rh: int, rw: int,
                              boxes: np.ndarray, pre_quads: np.ndarray,
                              fused, cls_shape, use_cls: bool = True
                              ) -> Tuple[List[Tuple[str, float]],
                                         np.ndarray]:
        """The bitmap wire's rec: run_boxes_fused whose every pass also
        scores the candidates' pre-unclip quads (N, 4, 2, map coordinates)
        against the prob map on the device (fused.call_scored), so the map
        is never downloaded. Padding rows carry zero quads. → (rec results,
        DB box scores (N,) float32) in candidate order; the caller applies
        the box_thresh filter."""
        results: List[Tuple[str, float]] = [("", 0.0)] * len(boxes)
        scores = np.zeros(len(boxes), np.float32)
        imgH = self.rec_image_shape[1]
        for bucket_w, chunk, mats in self._fused_chunks(boxes, cls_shape):
            k = len(chunk)
            quads = np.zeros((len(mats[0]), 4, 2), np.float32)
            quads[:k] = pre_quads[chunk]
            packed = fused.call_scored(image_u8, prob, rh, rw, quads, *mats,
                                       imgH, bucket_w,
                                       use_cls=use_cls).cpu().numpy()
            T = (packed.shape[1] - 1) // 2
            out = self._decode(packed[:k, :T].astype(np.int32),
                               packed[:k, T:2 * T], mats[-1][:k], bucket_w)
            for row, i in enumerate(chunk):
                results[i] = out[row]
                scores[i] = packed[row, 2 * T]
        return results, scores

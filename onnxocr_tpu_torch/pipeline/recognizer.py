"""CTC text recognizer on the device. Counterpart of
onnxocr_tpu/pipeline/recognizer.py: the SVTR forward through the fused CTC
head kernel, and `run_boxes` — the per-width-bucket path the one-call
pipeline re-runs for wide lines and for boxes past its K_rec budget
(`run_boxes_fused` with the classifier off).
"""
from __future__ import annotations

import math
from typing import List, Tuple

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
        return ctc_head.ctc_head_reduce_batched(feats, head.w, head.b)


class TextRecognizer:
    def __init__(self, args, device: torch.device):
        self.device = device
        self.rec_image_shape = config.parse_shape(args.rec_image_shape)
        self.width_ladder = tuple(args.tpu_rec_width_buckets)
        self.batch_ladder = tuple(args.tpu_batch_buckets)
        self.interp = args.tpu_warp_interp
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

    def run_boxes(self, image_u8: torch.Tensor, boxes: np.ndarray
                  ) -> List[Tuple[str, float]]:
        """image_u8: (H, W, 3) uint8 source on the device; boxes (N, 4, 2)
        source coords → [(text, score)] in box order. One device call per
        (width bucket, chunk of at most the top batch size)."""
        n = len(boxes)
        if n == 0:
            return []
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
                        boxes[i], imgH, bucket_w)
                valid_dev = torch.from_numpy(valid).to(self.device)
                crops = warp_ops.warp_crops(
                    image_u8, torch.from_numpy(mats).to(self.device),
                    valid_dev, imgH, bucket_w, self.interp)
                idx, prob = self.forward(crops, (valid_dev + 7) // 8)
                idx = idx[:k].cpu().numpy()
                prob = prob[:k].cpu().numpy()
                stride = bucket_w // idx.shape[1]
                valid_t = [min(idx.shape[1], math.ceil(w / stride))
                           for w in valid[:k]]
                out = self.postprocess_op.decode_indices(
                    idx, prob, is_remove_duplicate=True, valid_t=valid_t)
                for i, res in zip(chunk, out):
                    results[i] = res
        return results

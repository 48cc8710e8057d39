"""Text angle classifier (0° / 180°) on the device. Counterpart of
onnxocr_tpu/pipeline/classifier.py: the forward over (N, 48, 192, 3) crops
(native, or a cls.onnx's graph);
`run_boxes`, which classifies crops warped straight from the uploaded page
and returns only the rotation verdicts — the 180° turn itself is folded
into the recognizer's warp homography; and the reference's `__call__` on a
list of host crops (resized with cv2's pixels, utils/cv_ops.py), which
turns the crops it finds upside down.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..models import convert
from ..onnx.executor import GraphExecutor
from ..ops import ctc
from ..ops import warp as warp_ops
from ..utils import cv_ops
from . import backends, batching


class ClsForward:
    """(N, 48, 192, 3) float32 crops in [−1, 1] → (N, 2) softmax probs: the
    native classifier (seeded, from a checkpoint, or lifted from a
    cls.onnx), or a cls.onnx that does not lift run by the graph executor
    (its output is the probabilities), as backends.resolve_backend picks."""

    def __init__(self, tree, device: torch.device, backend: str = "native",
                 model_path: Optional[str] = None, dtype=torch.float32):
        self.backend = backend
        self.dtype = dtype
        if backend == "graph":
            self.executor = GraphExecutor(model_path, name="cls",
                                          device=device)
        else:
            self.model = convert.build_cls(tree, device, dtype)

    @torch.inference_mode()
    def __call__(self, crops: torch.Tensor) -> torch.Tensor:
        x = crops.permute(0, 3, 1, 2)
        if self.backend == "graph":
            return self.executor({self.executor.input_names[0]: x})[0]
        return self.model(x.to(self.dtype))


class TextClassifier:
    def __init__(self, args, device: torch.device):
        self.device = device
        self.cls_image_shape = config.parse_shape(args.cls_image_shape)
        self.cls_batch_num = args.cls_batch_num
        self.cls_thresh = args.cls_thresh
        self.label_list = args.label_list
        # index of the "180" label; None turns the classifier off
        self.idx180 = next((i for i, l in enumerate(self.label_list)
                            if "180" in str(l)), None)
        self.batch_ladder = tuple(args.tpu_batch_buckets)
        self.warp_form = warp_ops.form_of(args)
        self.postprocess_op = ctc.ClsPostProcess(label_list=args.label_list)
        backend, path, tree, _, _ = backends.resolve_backend(
            "cls", args.cls_model_dir, args.tpu_backend,
            allow_untrained=args.tpu_allow_untrained)
        self.forward = ClsForward(tree, device, backend, path,
                                  backends.stage_dtype(backend, args, "cls"))

    def _forward_batches(self, crops: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) float32 host crops → (N, 2) probs, in chunks of the
        top batch size, each padded with zero crops up the ladder."""
        n = len(crops)
        out = np.zeros((n, 2), np.float32)
        max_batch = self.batch_ladder[-1]
        for start in range(0, n, max_batch):
            chunk = crops[start:start + max_batch]
            k = len(chunk)
            bsz = batching.pick_batch_bucket(k, self.batch_ladder)
            if bsz > k:
                chunk = np.concatenate([chunk, np.zeros(
                    (bsz - k,) + chunk.shape[1:], chunk.dtype)])
            probs = self.forward(torch.from_numpy(chunk).to(self.device))
            out[start:start + k] = probs[:k].cpu().numpy()
        return out

    def resize_norm_img(self, img: np.ndarray) -> np.ndarray:
        """The reference cls resize (predict_cls.py:22-42): the crop at
        height 48 and its aspect's width (at most 192), normalized to
        [−1, 1], zero-padded to 48 × 192."""
        imgC, imgH, imgW = self.cls_image_shape
        h, w = img.shape[:2]
        ratio = w / float(h)
        if math.ceil(imgH * ratio) > imgW:
            resized_w = imgW
        else:
            resized_w = int(math.ceil(imgH * ratio))
        resized = cv_ops.resize_linear(img, (resized_w, imgH)).astype(
            np.float32)
        if imgC == 1 and resized.ndim == 2:
            resized = resized[..., None]
        resized = resized / 255.0
        resized = (resized - 0.5) / 0.5
        out = np.zeros((imgH, imgW, imgC), dtype=np.float32)
        out[:, :resized_w] = resized
        return out

    def __call__(self, img_list: Sequence[np.ndarray]
                 ) -> Tuple[List[np.ndarray], List[List]]:
        """The reference's host path: → (the crops, those the classifier
        reads as turned by 180° rotated back, [[label, score]])."""
        img_list = list(img_list)
        if not img_list:
            return img_list, []
        crops = np.stack([self.resize_norm_img(im) for im in img_list])
        cls_res = self.postprocess_op(self._forward_batches(crops))
        out_res: List[List] = []
        for i, (label, score) in enumerate(cls_res):
            out_res.append([label, score])
            if "180" in label and score > self.cls_thresh:
                img_list[i] = cv_ops.rotate_180(img_list[i])
        return img_list, out_res

    def run_boxes(self, image_u8: torch.Tensor, boxes: np.ndarray
                  ) -> Tuple[np.ndarray, List[List]]:
        """image_u8 (H, W, 3) uint8 source on the device; boxes (N, 4, 2)
        → (rot180 (N,) bool, [[label, score]]). One device call per chunk
        of at most the top batch size."""
        n = len(boxes)
        if n == 0:
            return np.zeros(0, bool), []
        _, imgH, imgW = self.cls_image_shape
        max_batch = self.batch_ladder[-1]
        probs_all = np.zeros((n, 2), np.float32)
        for start in range(0, n, max_batch):
            idxs = range(start, min(start + max_batch, n))
            bsz = batching.pick_batch_bucket(len(idxs), self.batch_ladder)
            mats = np.tile(np.eye(3, dtype=np.float32), (bsz, 1, 1))
            valid = np.zeros(bsz, np.int32)
            for row, i in enumerate(idxs):
                mats[row], valid[row] = warp_ops.build_crop_matrix(
                    boxes[i], imgH, imgW)
            crops = warp_ops.warp_crops(
                image_u8, torch.from_numpy(mats).to(self.device),
                torch.from_numpy(valid).to(self.device), imgH, imgW,
                **self.warp_form)
            probs = self.forward(crops).cpu().numpy()
            probs_all[start:start + len(idxs)] = probs[:len(idxs)]
        cls_res = self.postprocess_op(probs_all)
        rot = np.array([("180" in label and score > self.cls_thresh)
                        for label, score in cls_res], dtype=bool)
        return rot, [[label, score] for label, score in cls_res]

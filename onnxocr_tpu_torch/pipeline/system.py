"""TextSystem: det → sort → (cls) → rec on the device. Counterpart of
onnxocr_tpu/pipeline/system.py for the two ported paths:

* one-call (`tpu_pipeline='onecall'`, the port's default): the whole page
  in one program with one download (pipeline/onecall.py); results pair up
  in sorted_boxes order afterwards;
* staged with the device det postprocess (`tpu_pipeline='staged'`,
  `tpu_det_postprocess='device'`): upload → det + device DB boxes (one
  small download) → host clockwise / clip / side filter → sorted_boxes →
  cls + rec per width bucket (`run_boxes_fused`, or the classifier's and
  recognizer's `run_boxes` when `tpu_fused_cls_rec` is off).

drop_score filters the recognition results of both.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import config
from ..ops import resize_dev
from .classifier import TextClassifier
from .detector import TextDetector
from .fused import FusedClsRec
from .onecall import OneCallPipeline
from .recognizer import TextRecognizer


def resolve_device(device) -> torch.device:
    """The device to run on: CUDA unless the caller asks for the CPU, and
    an error (not a silent CPU run) when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _unported(args) -> List[str]:
    """Settings whose code path is not ported yet."""
    out = []
    # as in the reference, the one-call program needs the fused step
    onecall = args.tpu_pipeline == "onecall" and args.tpu_fused_cls_rec
    if not onecall and args.tpu_det_postprocess != "device":
        out.append(f"tpu_pipeline={args.tpu_pipeline!r} with "
                   f"tpu_det_postprocess={args.tpu_det_postprocess!r} (the "
                   "staged pipeline runs only with "
                   "tpu_det_postprocess='device')")
    if args.det_box_type != "quad" or args.use_dilation or \
            args.det_db_score_mode != "fast" or \
            args.det_limit_type != "max" or \
            getattr(args, "det_image_shape", None) is not None:
        out.append("det settings outside the device-det contract (quad "
                   "boxes, no dilation, fast score, limit_type 'max')")
    if args.save_crop_res:
        out.append("save_crop_res=True (host crops)")
    if not getattr(args, "tpu_onecall_fixed_canvas", True):
        out.append("tpu_onecall_fixed_canvas=False (per-page det canvas in "
                   "the one-call program)")
    for flag in ("tpu_det_microbatch", "tpu_rec_microbatch",
                 "tpu_onecall_wave"):
        if getattr(args, flag, False):
            out.append(f"{flag}=True (cross-request batching)")
    if getattr(args, "tpu_crop_backend", "device") != "device":
        out.append("tpu_crop_backend other than 'device' (host crops)")
    return out


class TextSystem:
    def __init__(self, args, device="cuda"):
        missing = _unported(args)
        if missing:
            raise NotImplementedError("not ported yet: " + "; ".join(missing))
        self.args = args
        self.device = resolve_device(device)
        self.use_angle_cls = args.use_angle_cls
        self.drop_score = args.drop_score
        self.text_detector = TextDetector(args, self.device)
        self.text_recognizer = TextRecognizer(args, self.device)
        if self.use_angle_cls:
            self.text_classifier = TextClassifier(args, self.device)
        self._fused = None
        if args.tpu_fused_cls_rec:
            warp_form = self.text_recognizer.warp_form
            if self.use_angle_cls:
                cls = self.text_classifier
                self._fused = FusedClsRec(
                    cls.forward, self.text_recognizer.forward,
                    cls_shape=config.parse_shape(args.cls_image_shape)[1:],
                    cls_thresh=args.cls_thresh, idx180=cls.idx180,
                    warp_form=warp_form)
            else:
                self._fused = FusedClsRec(None, self.text_recognizer.forward,
                                          warp_form=warp_form)
        self._onecall = None
        if args.tpu_pipeline == "onecall" and self._fused is not None:
            self._onecall = OneCallPipeline(
                self.text_detector, self.text_recognizer, self._fused, args,
                self.device)

    def _call_staged_device(self, img, cls: bool):
        """Staged path with the det postprocess on the device."""
        det, rec = self.text_detector, self.text_recognizer
        image_dev, src_h, src_w = resize_dev.put_src_bucket(img, self.device)
        raw = det.infer_boxes_device(image_dev, src_h, src_w)
        dt_boxes = sorted_boxes(det.filter_tag_det_res(raw, img.shape))
        if len(dt_boxes) == 0:
            return dt_boxes, []
        crop_quads = np.asarray(dt_boxes, dtype=np.float32)
        if self._fused is not None:
            use_cls = bool(self.use_angle_cls and cls and
                           self._fused.idx180 is not None)
            return dt_boxes, rec.run_boxes_fused(
                image_dev, crop_quads, self._fused,
                (self._fused.cls_h, self._fused.cls_w), use_cls=use_cls)
        rot180 = None
        if self.use_angle_cls and cls:
            rot180, _ = self.text_classifier.run_boxes(image_dev, crop_quads)
        return dt_boxes, rec.run_boxes(image_dev, crop_quads, rot180)

    def __call__(self, img, cls: bool = True):
        if img.shape[0] + img.shape[1] < 64:
            # the reference zero-pads tiny images before resizing; the JAX
            # package routes them to its host det path
            raise NotImplementedError(
                "images with h + w < 64 take the staged host det path, "
                "which is not ported")
        if self._onecall is not None:
            boxes, rec_res = self._onecall(img, cls)
            order = _sorted_pair_order(boxes)
            dt_boxes = [boxes[i] for i in order]
            rec_res = [rec_res[i] for i in order]
        else:
            dt_boxes, rec_res = self._call_staged_device(img, cls)
        filter_boxes, filter_rec_res = [], []
        for box, rec_result in zip(dt_boxes, rec_res):
            if rec_result[1] >= self.drop_score:
                filter_boxes.append(box)
                filter_rec_res.append(rec_result)
        return filter_boxes, filter_rec_res


def _sorted_pair_order(boxes) -> List[int]:
    """Index permutation with sorted_boxes' semantics (sort by (y, x) of the
    first corner + one 10 px-tolerance bubble pass)."""
    n = len(boxes)
    order = sorted(range(n), key=lambda i: (boxes[i][0][1], boxes[i][0][0]))
    for i in range(n - 1):
        for j in range(i, -1, -1):
            bj1, bj = boxes[order[j + 1]], boxes[order[j]]
            if abs(bj1[0][1] - bj[0][1]) < 10 and (bj1[0][0] < bj[0][0]):
                order[j], order[j + 1] = order[j + 1], order[j]
            else:
                break
    return order


def sorted_boxes(dt_boxes) -> List[np.ndarray]:
    """Top to bottom, then left to right, with the reference's single
    bubble pass of 10 px y-tolerance (intentionally not a full sort)."""
    return [dt_boxes[i] for i in _sorted_pair_order(dt_boxes)]

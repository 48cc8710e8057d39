"""TextSystem: det → sort → rec on the device through the one-call
pipeline. Counterpart of onnxocr_tpu/pipeline/system.py for the ported
path: results pair up in sorted_boxes order (one 10 px-tolerance bubble
pass) and drop_score filters the recognition results.
"""
from __future__ import annotations

from typing import List

import torch

from .detector import TextDetector
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
    if args.use_angle_cls:
        out.append("use_angle_cls=True (the angle classifier)")
    if args.tpu_pipeline != "onecall":
        out.append(f"tpu_pipeline={args.tpu_pipeline!r} (staged pipeline)")
    if args.tpu_warp_stage not in ("off", "", None, False):
        out.append(f"tpu_warp_stage={args.tpu_warp_stage!r} (staged warp)")
    if args.tpu_warp_interp != "bilinear":
        out.append(f"tpu_warp_interp={args.tpu_warp_interp!r}")
    if args.det_box_type != "quad" or args.use_dilation or \
            args.det_db_score_mode != "fast" or \
            args.det_limit_type != "max" or \
            getattr(args, "det_image_shape", None) is not None:
        out.append("det settings outside the one-call contract (quad boxes, "
                   "no dilation, fast score, limit_type 'max')")
    if args.save_crop_res:
        out.append("save_crop_res=True (host crops)")
    if not getattr(args, "tpu_onecall_fixed_canvas", True):
        out.append("tpu_onecall_fixed_canvas=False (per-page det canvas)")
    if str(getattr(args, "tpu_det_score_scale", "1x1")) not in ("1x1", "1"):
        out.append("tpu_det_score_scale other than 1x1")
    if float(getattr(args, "tpu_det_axis_snap", 0.0)):
        out.append("tpu_det_axis_snap")
    return out


class TextSystem:
    def __init__(self, args, device="cuda"):
        missing = _unported(args)
        if missing:
            raise NotImplementedError("not ported yet: " + "; ".join(missing))
        self.device = resolve_device(device)
        self.use_angle_cls = False
        self.drop_score = args.drop_score
        self.text_detector = TextDetector(args, self.device)
        self.text_recognizer = TextRecognizer(args, self.device)
        self._onecall = OneCallPipeline(self.text_detector,
                                        self.text_recognizer, args,
                                        self.device)

    def __call__(self, img, cls: bool = True):
        if img.shape[0] + img.shape[1] < 64:
            # the reference zero-pads tiny images before resizing; the JAX
            # package routes them to its host det path
            raise NotImplementedError(
                "images with h + w < 64 take the staged host det path, "
                "which is not ported")
        boxes, rec_res = self._onecall(img)
        order = _sorted_pair_order(boxes)
        filter_boxes, filter_rec_res = [], []
        for i in order:
            if rec_res[i][1] >= self.drop_score:
                filter_boxes.append(boxes[i])
                filter_rec_res.append(rec_res[i])
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

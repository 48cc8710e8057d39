"""Text detector setup for the one-call path: the DBNet on the device, the
DB postprocess parameters, and the checkpoint calibration. Counterpart of
the parts of onnxocr_tpu/pipeline/detector.py the one-call program reads.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from ..models import convert
from . import backends


class TextDetector:
    def __init__(self, args, device: torch.device):
        self.limit_side_len = args.det_limit_side_len
        self.bucket = int(getattr(args, "tpu_det_bucket", 320))
        if backends.pick_arch("det", args.det_model_dir) != "mbv3":
            raise NotImplementedError("the ResNet18-vd server detector is "
                                      "not ported")
        tree, ckpt = backends.load_native_params("det", args.det_model_dir)
        # checkpoint calibration applies only to flags the caller did not set
        user_keys = getattr(args, "_user_keys", set()) or set()
        for k, v in backends.checkpoint_calibration(ckpt).items():
            if k.startswith("det_") and k not in user_keys:
                setattr(args, k, v)
        # DBPostProcess parameters (reference min_size 3)
        self.postprocess_op = SimpleNamespace(
            thresh=args.det_db_thresh, box_thresh=args.det_db_box_thresh,
            unclip_ratio=args.det_db_unclip_ratio, min_size=3)
        self.model = convert.build_dbnet(tree, device)

"""Text detector on the device: the DBNet, the DB postprocess parameters,
the checkpoint calibration, and the device box extraction of the staged
path. Counterpart of the parts of onnxocr_tpu/pipeline/detector.py the
ported paths read; the host DB postprocess (contours, minAreaRect, unclip
from a downloaded map) is not ported.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..models import convert
from ..ops import db_device, det_pre, resize_dev
from . import backends


def order_points_clockwise(pts: np.ndarray) -> np.ndarray:
    """4 points → [top-left, top-right, bottom-right, bottom-left]: the two
    smallest-x points form the left pair, each pair ordered by y (own copy
    of the reference's ops/geometry.order_points_clockwise)."""
    pts = np.asarray(pts)
    idx = np.argsort(pts[:, 0])
    left = pts[idx[:2]]
    right = pts[idx[2:]]
    left = left[np.argsort(left[:, 1])]
    right = right[np.argsort(right[:, 1])]
    return np.asarray([left[0], right[0], right[1], left[1]],
                      dtype=pts.dtype)


class TextDetector:
    def __init__(self, args, device: torch.device):
        self.args = args
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

    def clip_det_res(self, points, img_height, img_width):
        points = np.array(points)
        points[:, 0] = np.clip(points[:, 0], 0, img_width - 1)
        points[:, 1] = np.clip(points[:, 1], 0, img_height - 1)
        return points

    def filter_tag_det_res(self, dt_boxes, image_shape) -> np.ndarray:
        """Clockwise order, clip to the image, drop boxes with a side of
        3 px or less (the reference's predict_det contract)."""
        img_height, img_width = image_shape[:2]
        out = []
        for box in dt_boxes:
            box = order_points_clockwise(np.asarray(box))
            box = self.clip_det_res(box, img_height, img_width)
            rect_width = int(np.linalg.norm(box[0] - box[1]))
            rect_height = int(np.linalg.norm(box[0] - box[3]))
            if rect_width <= 3 or rect_height <= 3:
                continue
            out.append(box)
        return np.array(out)

    @torch.inference_mode()
    def boxes_packed(self, image_u8: torch.Tensor, src_h: int, src_w: int,
                     rh: int, rw: int) -> torch.Tensor:
        """resize → DBNet on the page's own canvas (round_up(rh, bucket) ×
        round_up(rw, bucket)) → device DB extraction. → (max_k, 10) float32
        on the device: [quad in map coords (8), score, valid]."""
        args, pp = self.args, self.postprocess_op
        hb = det_pre.round_up(rh, self.bucket)
        wb = det_pre.round_up(rw, self.bucket)
        max_k = int(args.tpu_det_max_boxes)
        x = resize_dev.resize_normalize_det(image_u8, src_h, src_w, rh, rw,
                                            hb, wb)
        prob = self.model(x.permute(2, 0, 1)[None], valid_hw=(rh, rw))[0]
        quads, scores, valid = db_device.device_boxes(
            prob.contiguous(), rh, rw, max_k=max_k, thresh=pp.thresh,
            box_thresh=pp.box_thresh, unclip_ratio=pp.unclip_ratio,
            min_size=float(pp.min_size), scale=args.tpu_det_extract_scale,
            score_scale=args.tpu_det_score_scale,
            reduce=str(args.tpu_db_reduce),
            score_k=int(args.tpu_det_score_k),
            axis_snap=float(args.tpu_det_axis_snap))
        return torch.cat([quads.reshape(max_k, 8), scores[:, None],
                          valid[:, None].to(torch.float32)], -1)

    def infer_boxes_device(self, image_u8: torch.Tensor, src_h: int,
                           src_w: int) -> np.ndarray:
        """The staged path's det step (tpu_det_postprocess='device'): only
        max_k × 10 floats return to the host. → (N, 4, 2) int32 boxes in
        source coords, before filter_tag_det_res."""
        rh, rw = det_pre.det_resize_target(src_h, src_w, self.limit_side_len)
        packed = self.boxes_packed(image_u8, src_h, src_w, rh, rw)
        return db_device.unpack_boxes(packed.cpu().numpy(), rw, rh, src_w,
                                      src_h)

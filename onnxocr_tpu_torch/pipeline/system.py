"""TextSystem: det → sort → (cls) → rec on the device. Counterpart of
onnxocr_tpu/pipeline/system.py, routed as the JAX package routes a page
(`_call_device_crops`), first route that applies:

* one-call (`tpu_pipeline='onecall'` with the fused step, quad boxes, no
  dilation, fast score, limit_type 'max', no det_image_shape): the whole
  page in one program with one download (pipeline/onecall.py; with
  `tpu_onecall_wave` concurrent pages share one multi-page program);
  results pair up in sorted_boxes order afterwards;
* the bitmap wire (the default: `tpu_det_wire='bitmap'`,
  `tpu_det_postprocess='host'`, `tpu_det_input='device'`, the fused step,
  quad boxes, fast score, limit_type 'max', no det_image_shape): DBNet →
  the bitpacked DB bitmap downloaded → host contours, min-area quads and
  unclip → clockwise / clip / side filter → one fused pass per (width
  bucket, chunk) that scores the candidates against the prob map left on
  the device and runs cls + rec → box_thresh filter → sorted pairing.
  Past `batch_ladder[-1] * 4` candidates the map is downloaded and scored
  on the host instead, and the kept boxes run the fused step;
* the device det postprocess (`tpu_det_postprocess='device'`, quad boxes,
  no dilation, limit_type 'max', no det_image_shape): det + device DB
  boxes (one small download) → host filter → sorted_boxes → cls + rec;
* the map route (`tpu_det_input='device'`): DBNet → the map in the wire
  dtype downloaded → the host DB postprocess (quad or poly boxes, fast or
  slow score, dilation) → sorted_boxes → cls + rec;
* the host det input (`tpu_det_input='host'`, and every tiny page, h + w
  < 64, on any route): the page resized on the host with cv2's pixels
  (det_pre.prepare_det_input, which zero-pads a tiny page as the
  reference does) → DBNet → the map route's host postprocess.

With `save_crop_res` every page takes the host crops (as in the JAX
package: the crops it writes are the host's), and each call writes its
crops, after the classifier's turns, as `mg_crop_<n>.jpg` JPEGs at quality
95 (cv2.imwrite's bytes, utils/imcodec.py) under `crop_res_save_dir`, n
counting across calls and threads.

cls + rec is `run_boxes_fused` (one fused pass per width bucket) or, with
`tpu_fused_cls_rec` off, the classifier's and recognizer's `run_boxes`.
Poly boxes crop through their min-area quad. With
`tpu_crop_backend='host'` the reference's own flow runs instead: det boxes,
crops cut on the host, the classifier and recognizer on the crop list
(`_call_host_crops`). drop_score filters the recognition results of every
route.

Concurrent calls from several threads (as the JAX package's serving
engine makes them) may share device calls: with `tpu_det_microbatch` the
det forwards run as one wave (the bitmap wire's, the map route's or the
device postprocess's, runtime/batcher.DetPageBatcher), with
`tpu_rec_microbatch` the fused passes of every route but one-call's own
program run as multi-page passes. `close()` stops their threads and the
wave coalescer's. A det batcher on a mesh of devices (the serving engine's
`_maybe_shard_det`) runs the maps wave, so the bitmap route then takes the
map route's det step, as the JAX package's does (`route` says so).

The stages of utils/profiling.GLOBAL ("img_upload", "det",
"cls_rec_fused", "onecall", "cls", "rec") open where the JAX package's
open them, route by route.
"""
from __future__ import annotations

import os
import threading
from typing import List

import numpy as np
import torch

from .. import config
from ..ops import db_post, det_pre, geometry, resize_dev
from ..utils import imcodec
from ..utils.profiling import GLOBAL as timer
from ..utils.image import get_minarea_rect_crop, get_rotate_crop_image, \
    minarea_quad
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


def route_of(args) -> str:
    """The route a page of normal size takes: 'host_crops', 'onecall',
    'bitmap', 'device', 'map' or 'host' (the host det input)."""
    if getattr(args, "tpu_crop_backend", "device") != "device" or \
            args.save_crop_res:
        return "host_crops"
    fused = bool(args.tpu_fused_cls_rec)
    quad = args.det_box_type == "quad"
    plain_det = args.det_limit_type == "max" and \
        getattr(args, "det_image_shape", None) is None
    fast = args.det_db_score_mode == "fast"
    if args.tpu_pipeline == "onecall" and fused and quad and \
            not args.use_dilation and fast and plain_det:
        return "onecall"
    if args.tpu_det_wire == "bitmap" and fused and \
            args.tpu_det_postprocess == "host" and \
            args.tpu_det_input == "device" and quad and fast and plain_det:
        return "bitmap"
    if args.tpu_det_postprocess == "device" and quad and \
            not args.use_dilation and plain_det:
        return "device"
    if args.tpu_det_input == "device":
        return "map"
    return "host"


class TextSystem:
    def __init__(self, args, device="cuda"):
        self.args = args
        self.device = resolve_device(device)
        self.use_angle_cls = args.use_angle_cls
        self.drop_score = args.drop_score
        self.crop_image_res_index = 0
        self._crop_res_lock = threading.Lock()
        self.text_detector = TextDetector(args, self.device)
        # the checkpoint calibration has set the det flags by now
        self._route = route_of(args)
        self.text_recognizer = TextRecognizer(args, self.device)
        if self.use_angle_cls:
            self.text_classifier = TextClassifier(args, self.device)
        self._fused = None
        if args.tpu_fused_cls_rec and self._route != "host_crops":
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
        if self._route == "onecall":
            self._onecall = OneCallPipeline(
                self.text_detector, self.text_recognizer, self._fused, args,
                self.device)

    @property
    def route(self) -> str:
        """The route a page of normal size takes (route_of), where a det
        batcher that does not run the bitmap wire (one on a mesh) turns the
        bitmap route into the map route, as the JAX package's
        `_call_device_crops` checks the batcher's wire."""
        batcher = self.text_detector._page_batcher
        if self._route == "bitmap" and batcher is not None and \
                batcher.mode != "bits":
            return "map"
        return self._route

    def close(self):
        """Stop the cross-request batchers' and the wave coalescer's
        threads, if any, and those of forwards wrapped in a
        runtime.batcher.BatchedForward."""
        forwards = [self.text_recognizer.forward]
        if self.use_angle_cls:
            forwards.append(self.text_classifier.forward)
        for b in (self.text_detector._page_batcher,
                  self.text_recognizer._crop_batcher, self._onecall,
                  *forwards):
            if b is not None and hasattr(b, "close"):
                b.close()

    def draw_crop_rec_res(self, output_dir, img_crop_list, rec_res):
        """Write the crops as mg_crop_<n>.jpg, n counting on from the last
        call's crops under a lock (the reference's counter is unlocked)."""
        os.makedirs(output_dir, exist_ok=True)
        with self._crop_res_lock:
            base = self.crop_image_res_index
            self.crop_image_res_index += len(img_crop_list)
        for bno, crop in enumerate(img_crop_list):
            with open(os.path.join(output_dir, f"mg_crop_{bno + base}.jpg"),
                      "wb") as f:
                f.write(imcodec.imencode_jpeg(crop, 95))

    def _use_cls(self, cls: bool) -> bool:
        return bool(self.use_angle_cls and cls and
                    self._fused.idx180 is not None)

    def _fixed_canvas(self) -> bool:
        """The bitmap wire's det canvas: 'always' fixes it for the masked
        mbv3 DBNet; 'auto' (fixed on the TPU only, in the JAX package),
        'never' and the ResNet DBNet take the page's own bucket canvas."""
        return self.text_detector.masks_canvas and \
            getattr(self.args, "tpu_det_fixed_canvas", "auto") == "always"

    def _keep_candidates(self, pre_quads, cand, image_shape):
        """filter_tag_det_res over the bitmap wire's candidates, keeping
        each survivor's pre-unclip quad → (boxes (N, 4, 2), pre-unclip
        quads (N, 4, 2)), float32."""
        det = self.text_detector
        keep_pre, keep_boxes = [], []
        for q, b in zip(pre_quads, cand):
            box = geometry.order_points_clockwise(np.asarray(b, np.float32))
            box = det.clip_det_res(box, image_shape[0], image_shape[1])
            w_i = int(np.linalg.norm(box[0] - box[1]))
            h_i = int(np.linalg.norm(box[0] - box[3]))
            if w_i <= 3 or h_i <= 3:
                continue
            keep_pre.append(q)
            keep_boxes.append(box)
        return (np.asarray(keep_boxes, np.float32).reshape(-1, 4, 2),
                np.asarray(keep_pre, np.float32).reshape(-1, 4, 2))

    def _call_bitmap_wire(self, img, cls: bool):
        """The default route: two downloads a page, the bitpacked bitmap and
        the packed rec buffer; the prob map stays on the device."""
        det, rec = self.text_detector, self.text_recognizer
        pp = det.postprocess_op
        with timer.stage("img_upload"):
            image_dev, src_h, src_w = resize_dev.put_src_bucket(img,
                                                                self.device)
        with timer.stage("det"):
            batcher = det._page_batcher
            if batcher is not None:
                # the det batcher: concurrent pages' forwards as one wave,
                # the wave's bitmaps downloaded as one copy; each fixed
                # canvas resized on the device from the uploaded page, or
                # on the host (tpu_det_batch_input='host', and the ResNet's
                # own canvases)
                if batcher.canvas is not None and \
                        self.args.tpu_det_batch_input == "device":
                    bitmap, prob_dev, (rh, rw), _ = batcher.submit_bits_dev(
                        image_dev, src_h, src_w)
                else:
                    bitmap, prob_dev, (rh, rw), _ = batcher.submit_bits(img)
            else:
                bits, prob_dev, (rh, rw) = det.bitmap_forward(
                    image_dev, src_h, src_w, self._fixed_canvas())
                # the whole canvas comes down and is sliced on the host
                bitmap = det_pre.unpack_bitmap(
                    bits.cpu().numpy()[:rh, :rw // 8], rw)
            if pp.use_dilation:
                bitmap = geometry.dilate2x2(bitmap)
            pre_quads, cand = pp.candidates_from_bitmap(
                bitmap, img.shape[1], img.shape[0])
            boxes, pre = self._keep_candidates(pre_quads, cand, img.shape)
        if len(boxes) == 0:
            return [], []
        use_cls = self._use_cls(cls)
        cls_shape = (self._fused.cls_h, self._fused.cls_w)
        if len(boxes) <= rec.batch_ladder[-1] * 4:
            with timer.stage("cls_rec_fused"):
                rec_res, scores = rec.run_candidates_scored(
                    image_dev, prob_dev, rh, rw, boxes, pre, self._fused,
                    cls_shape, use_cls=use_cls)
            keep = scores >= pp.box_thresh
            fb = [b for b, k in zip(boxes, keep) if k]
            fr = [r for r, k in zip(rec_res, keep) if k]
            order = _sorted_pair_order(fb)
            return [fb[i] for i in order], [fr[i] for i in order]
        # more candidates than the scored passes take (a speckled page):
        # the map comes down, the host scores, the kept boxes run fused
        with timer.stage("det"):
            prob = np.ascontiguousarray(prob_dev.cpu().numpy()[:rh, :rw])
            scores = np.asarray([db_post.box_score_fast(prob, q)
                                 for q in pre], np.float32)
            dt_boxes = sorted_boxes(
                [b for b, s in zip(boxes, scores) if s >= pp.box_thresh])
        if not dt_boxes:
            return dt_boxes, []
        with timer.stage("cls_rec_fused"):
            return dt_boxes, rec.run_boxes_fused(
                image_dev, np.asarray(dt_boxes, np.float32), self._fused,
                cls_shape, use_cls=use_cls)

    def _det_boxes(self, img, tiny: bool):
        """The det step of the staged routes, in the JAX package's order
        (`_call_device_crops`) → (boxes, the page on the device or None).
        A tiny page (h + w < 64) takes the host det input, which zero-pads
        it as the reference does, unless the det batcher extracts boxes on
        the device."""
        det = self.text_detector
        batcher = det._page_batcher
        if batcher is not None and batcher.mode == "boxes":
            with timer.stage("det"):
                return det(img), None
        route = self.route
        if route == "device" and not tiny:
            with timer.stage("img_upload"):
                image_dev, src_h, src_w = resize_dev.put_src_bucket(
                    img, self.device)
            with timer.stage("det"):
                return det.filter_tag_det_res(
                    det.infer_boxes_device(image_dev, src_h, src_w),
                    img.shape), image_dev
        if batcher is None and not tiny and route == "map":
            with timer.stage("img_upload"):
                image_dev, src_h, src_w = resize_dev.put_src_bucket(
                    img, self.device)
            with timer.stage("det"):
                prob, shape_info = det.infer_prob_map_device(
                    image_dev, src_h, src_w)
                return det.boxes_from_prob(prob, shape_info, img.shape), \
                    image_dev
        # the det batcher's waves (maps, or bits for the host scores) and
        # the host det input
        with timer.stage("det"):
            return det(img), None

    def _call_staged(self, img, cls: bool, tiny: bool = False):
        """The routes past the one-call program and the bitmap wire: det
        boxes → sorted_boxes → cls + rec from the page on the device (the
        page as it is, uploaded after a host det step)."""
        dt_boxes, image_dev = self._det_boxes(img, tiny)
        dt_boxes = sorted_boxes(dt_boxes)
        if len(dt_boxes) == 0:
            return dt_boxes, []
        if self.args.det_box_type == "quad":
            crop_quads = np.asarray(dt_boxes, dtype=np.float32)
        else:
            crop_quads = np.stack([minarea_quad(np.asarray(b))
                                   for b in dt_boxes]).astype(np.float32)
        if image_dev is None:
            with timer.stage("img_upload"):
                image_dev = torch.from_numpy(np.ascontiguousarray(img)).to(
                    self.device)
        rec = self.text_recognizer
        if self._fused is not None:
            with timer.stage("cls_rec_fused"):
                return dt_boxes, rec.run_boxes_fused(
                    image_dev, crop_quads, self._fused,
                    (self._fused.cls_h, self._fused.cls_w),
                    use_cls=self._use_cls(cls))
        rot180 = None
        if self.use_angle_cls and cls:
            with timer.stage("cls"):
                rot180, _ = self.text_classifier.run_boxes(image_dev,
                                                           crop_quads)
        with timer.stage("rec"):
            return dt_boxes, rec.run_boxes(image_dev, crop_quads, rot180)

    def _call_host_crops(self, img, cls: bool):
        """tpu_crop_backend='host': the reference's own flow — det boxes,
        crops cut on the host (cv2's pixels), the classifier turning the
        crops it reads upside down, the recognizer on the crop list."""
        dt_boxes = sorted_boxes(self.text_detector(img))
        crop = get_rotate_crop_image if self.args.det_box_type == "quad" \
            else get_minarea_rect_crop
        crops = [crop(img, np.array(box, copy=True)) for box in dt_boxes]
        if self.use_angle_cls and cls:
            crops, _ = self.text_classifier(crops)
        rec_res = self.text_recognizer(crops)
        if self.args.save_crop_res:
            self.draw_crop_rec_res(self.args.crop_res_save_dir, crops,
                                   rec_res)
        return dt_boxes, rec_res

    def __call__(self, img, cls: bool = True):
        tiny = img.shape[0] + img.shape[1] < 64
        route = self.route
        if route == "host_crops":
            dt_boxes, rec_res = self._call_host_crops(img, cls)
        elif self._onecall is not None and not tiny:
            with timer.stage("onecall"):
                boxes, rec_res = self._onecall(img, cls)
            order = _sorted_pair_order(boxes)
            dt_boxes = [boxes[i] for i in order]
            rec_res = [rec_res[i] for i in order]
        elif route == "bitmap" and not tiny:
            dt_boxes, rec_res = self._call_bitmap_wire(img, cls)
        else:
            dt_boxes, rec_res = self._call_staged(img, cls, tiny)
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

"""Text detector on the device: the DBNet (MobileNetV3 backbone, or
ResNet18-vd for the ch_ppocr_server_v2.0 family; or a user's det.onnx run
by the graph executor, `GraphDBNet`, as backends.resolve_backend picks),
the host DB postprocess, the checkpoint calibration, and the det forwards
of the staged routes.
Counterpart of onnxocr_tpu/pipeline/detector.py and of the det forwards of
its backends.DetForward:

* the bitmap wire (`bitmap_forward`): DBNet → the DB bitmap bitpacked on
  the device; the prob map stays there for the deferred box scores;
* the map route (`infer_prob_map_device` + `boxes_from_prob`): DBNet → the
  map in the wire dtype `tpu_det_map_dtype` → the host DB postprocess;
* device box extraction (`infer_boxes_device`, tpu_det_postprocess=
  'device'): only max_k × 10 floats come back;
* the host det input (`infer_prob_map`, and `__call__`, the reference's
  det-only contract): the page resized on the host with cv2's pixels into
  its bucket canvas (det_pre.prepare_det_input, which also zero-pads a tiny
  page as the reference does) → DBNet → the map in the wire dtype;
* the cross-request det batcher (`tpu_det_microbatch`,
  `enable_page_batching`): concurrent pages' forwards as one wave on the
  fixed det canvas, or per canvas shape for the ResNet
  (runtime/batcher.DetPageBatcher), in the mode
  `page_batch_mode` picks: the bitmap wire (`pages_bits`), the maps wire
  (`pages_maps`) or device box extraction (`pages_boxes`); on a mesh of
  devices (the serving engine of a host with several cards) the maps wave
  split over the mesh's data rows (`pages_maps_sharded`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models import convert
from ..onnx.executor import GraphExecutor
from ..ops import db_device, det_pre, geometry, resize_dev
from ..ops.db_post import DBPostProcess
from ..utils.profiling import CAPTURE
from . import backends


def page_batch_mode(args) -> Optional[str]:
    """The mode the det batcher takes under `args`, as the JAX package
    picks it (`enable_page_batching`): None (no batcher) without
    limit_type 'max' sizing; 'boxes' (device DB extraction), 'maps' (map
    download) or 'bits' (the bitmap wire)."""
    if args.det_limit_type != "max" or \
            getattr(args, "det_image_shape", None) is not None:
        return None
    quad = args.det_box_type == "quad"
    if args.tpu_det_postprocess == "device" and quad and \
            not args.use_dilation:
        return "boxes"
    if args.tpu_det_wire == "bitmap" and quad and \
            args.det_db_score_mode == "fast":
        return "bits"
    return "maps"


class GraphDBNet:
    """A det.onnx run by the graph executor, behind the native DBNet's call:
    (N, 3, H, W) normalized float32 → (N, H, W) float32 map, the graph's
    (N, 1, H, W) output. `valid_hw` is not applied: the graph keeps its
    unmasked GlobalAveragePool (the JAX package's graph det does too), so
    its map depends on the canvas padding."""

    def __init__(self, model_path: str, device: torch.device):
        self.executor = GraphExecutor(model_path, name="det", device=device)

    def to(self, device) -> "GraphDBNet":
        """The same graph on `device` (a mesh row's replica)."""
        out = GraphDBNet.__new__(GraphDBNet)
        out.executor = self.executor.to(device)
        return out

    def __call__(self, x: torch.Tensor, valid_hw=None) -> torch.Tensor:
        out = self.executor({self.executor.input_names[0]:
                             x.to(torch.float32)})[0]
        return out[:, 0].to(torch.float32)


class TextDetector:
    def __init__(self, args, device: torch.device):
        self.args = args
        self.limit_side_len = args.det_limit_side_len
        self.limit_type = args.det_limit_type
        # fixed-shape resize (DetResizeForTest type 1) when set
        self.image_shape = getattr(args, "det_image_shape", None)
        self.keep_ratio = getattr(args, "det_keep_ratio", False)
        self.bucket = int(getattr(args, "tpu_det_bucket", 320))
        self.map_dtype = getattr(args, "tpu_det_map_dtype", "uint8")
        self.backend, path, tree, self.arch, calib = \
            backends.resolve_backend(
                "det", args.det_model_dir, args.tpu_backend,
                arch=backends.pick_arch("det", args.det_model_dir),
                allow_untrained=args.tpu_allow_untrained)
        # checkpoint calibration applies only to flags the caller did not set
        user_keys = getattr(args, "_user_keys", set()) or set()
        for k, v in calib.items():
            if k.startswith("det_") and k not in user_keys:
                setattr(args, k, v)
        self.postprocess_op = DBPostProcess(
            thresh=args.det_db_thresh, box_thresh=args.det_db_box_thresh,
            max_candidates=1000, unclip_ratio=args.det_db_unclip_ratio,
            use_dilation=args.use_dilation,
            score_mode=args.det_db_score_mode, box_type=args.det_box_type)
        self.device = device
        self.dtype = backends.stage_dtype(self.backend, args, "det")
        self.model = GraphDBNet(path, device) if self.backend == "graph" \
            else convert.build_dbnet(tree, device, self.arch, self.dtype)
        self._page_batcher = None
        if args.tpu_det_microbatch:
            self.enable_page_batching(
                max_wait_ms=float(args.tpu_microbatch_wait_ms))

    @property
    def masks_canvas(self) -> bool:
        """True when the DBNet's map over the valid region does not depend
        on the canvas padding (the masked native mbv3; not the ResNet, not
        a graph), so that pages may share a fixed canvas."""
        return self.backend == "native" and self.arch == "mbv3"

    def enable_page_batching(self, max_wait_ms: float = 8.0,
                             mesh=None) -> bool:
        """Cross-request det batching: concurrent pages share one DBNet
        forward (runtime/batcher.DetPageBatcher) in the mode of
        `page_batch_mode`, on the fixed det canvas for the masked mbv3 and
        on each page's own bucket canvas for the ResNet and a graph. False,
        and no batcher, without limit_type 'max' sizing, as in the JAX
        package. A batcher enabled before is closed and replaced.

        With `mesh` (parallel/mesh.py, serving across cards), the wave
        splits over the mesh's `data` axis (`pages_maps_sharded`) and the
        mode is 'maps', as the JAX package's mesh turns its wire into
        maps; a graph det and the boxes mode drop the mesh, as there."""
        mode = page_batch_mode(self.args)
        if mode is None:
            return False
        if self.backend != "native" or mode == "boxes":
            mesh = None
        from ..runtime.batcher import DetPageBatcher
        if mesh is not None:
            mode, fn = "maps", self.pages_maps_sharded(mesh)
        else:
            fn = {"bits": self.pages_bits, "maps": self.pages_maps,
                  "boxes": self.pages_boxes}[mode]
        if self._page_batcher is not None:
            self._page_batcher.close()
        self._page_batcher = DetPageBatcher(
            fn, mode, self.limit_side_len, self.limit_type,
            max_wait_ms=max_wait_ms, bucket=self.bucket,
            fixed_canvas=self.masks_canvas, mesh=mesh)
        return True

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
            box = geometry.order_points_clockwise(np.asarray(box))
            box = self.clip_det_res(box, img_height, img_width)
            rect_width = int(np.linalg.norm(box[0] - box[1]))
            rect_height = int(np.linalg.norm(box[0] - box[3]))
            if rect_width <= 3 or rect_height <= 3:
                continue
            out.append(box)
        return np.array(out)

    def filter_tag_det_res_only_clip(self, dt_boxes, image_shape):
        """Poly boxes: clip only. A list, not an array: polygons have as
        many vertices as their contours need (the JAX package stacks them
        with np.array, which numpy ≥ 1.24 refuses for ragged polygons)."""
        img_height, img_width = image_shape[:2]
        return [self.clip_det_res(box, img_height, img_width)
                for box in dt_boxes]

    def resize_target(self, src_h: int, src_w: int) -> Tuple[int, int]:
        if self.image_shape is not None:
            return tuple(int(v) for v in self.image_shape)
        return det_pre.det_resize_target(src_h, src_w, self.limit_side_len,
                                         self.limit_type)

    def net(self, x: torch.Tensor, valid_hw) -> torch.Tensor:
        """The DBNet on (N, 3, H, W) normalized canvases, cast to the
        stage's dtype → (N, H, W) float32 maps."""
        return self.model(x.to(self.dtype), valid_hw=valid_hw)

    def forward(self, x: torch.Tensor, rh: int, rw: int) -> torch.Tensor:
        """(H, W, 3) normalized canvas (valid rh × rw) → (H, W) float32 map;
        the backbone's SE pools see the valid region only."""
        return self.net(x.permute(2, 0, 1)[None], (rh, rw))[0]

    def encode_map(self, prob: torch.Tensor) -> torch.Tensor:
        """The map in the wire dtype. uint8 floors (does not round): rounding
        can lift sub-threshold pixels over det_db_thresh."""
        if self.map_dtype == "uint8":
            return torch.floor(prob * 255.0).to(torch.uint8)
        if self.map_dtype == "float16":
            return prob.to(torch.float16)
        return prob.to(torch.float32)

    @staticmethod
    def decode_map(arr: np.ndarray) -> np.ndarray:
        if arr.dtype == np.uint8:
            return arr.astype(np.float32) / 255.0
        return arr.astype(np.float32)

    @torch.inference_mode()
    def bitmap_forward(self, image_u8: torch.Tensor, src_h: int, src_w: int,
                       fixed_canvas: bool = False):
        """The bitmap wire's det step: resize → DBNet → bitpacked DB bitmap,
        all on the device. `fixed_canvas`: one square canvas of the limit
        side for every page, else the page's own bucket canvas. → (bits
        (H, W // 8) uint8, prob (H, W) float32, both on the device, (rh,
        rw))."""
        rh, rw = self.resize_target(src_h, src_w)
        if fixed_canvas:
            cap = det_pre.round_up(int(self.limit_side_len), self.bucket)
            hb = wb = max(cap, det_pre.round_up(max(rh, rw), self.bucket))
        else:
            hb = det_pre.round_up(rh, self.bucket)
            wb = det_pre.round_up(rw, self.bucket)
        x = resize_dev.resize_normalize_det(image_u8, src_h, src_w, rh, rw,
                                            hb, wb)
        if CAPTURE.enabled:
            CAPTURE.record("det_bits", self.bits_forward, (x, rh, rw))
        return (*self.bits_forward(x, rh, rw), (rh, rw))

    @torch.inference_mode()
    def bits_forward(self, x: torch.Tensor, rh: int, rw: int):
        """The bitmap wire's device program on a normalized canvas (H, W, 3)
        (valid rh × rw): DBNet → (bits (H, W // 8) uint8, prob (H, W)
        float32), both on the device."""
        prob = self.forward(x, rh, rw)
        return det_pre.bitpack_map(prob, rh, rw,
                                   self.postprocess_op.thresh), prob

    def _pages_forward(self, batch) -> torch.Tensor:
        """A wave's DBNet forward: {"pages": (B, H, W, 3) uint8 canvases or
        float32 normalized ones on the device, "rhw": (B, 2) valid
        extents} → (B, H, W) float32 maps, each page masked to its own
        extent. Host canvases are uploaded here, once a wave."""
        pages = torch.as_tensor(batch["pages"]).to(self.device)
        if pages.dtype == torch.uint8:
            pages = det_pre.normalize_det(pages)
        rhw = torch.as_tensor(batch["rhw"]).to(pages.device)
        return self.net(pages.permute(0, 3, 1, 2), (rhw[:, 0], rhw[:, 1]))

    @torch.inference_mode()
    def pages_bits(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """The det batcher's bitmap wave (counterpart of
        `make_pages_bits_fn`): batch as `_pages_forward` → (bits (B, H,
        W // 8) uint8, probs (B, H, W) float32), both on the device. A
        padding page (extent 0) gives no bit."""
        probs = self._pages_forward(batch)
        rhw = torch.as_tensor(batch["rhw"]).to(probs.device)
        return det_pre.bitpack_map(probs, rhw[:, 0], rhw[:, 1],
                                   self.postprocess_op.thresh), probs

    @torch.inference_mode()
    def pages_maps(self, batch) -> torch.Tensor:
        """The det batcher's maps wave (`call_pages_u8`): host-resized
        uint8 canvases → (B, H, W) maps in the wire dtype."""
        return self.encode_map(self._pages_forward(batch))

    def pages_maps_sharded(self, mesh):
        """The maps wave split over a mesh (the JAX batcher's
        `_make_sharded_fn`): host-resized uint8 canvases → (B, H, W) maps
        in the wire dtype, each row's DBNet replica masked to its pages'
        extents and its maps encoded on its device, gathered on the host.
        The replicas are built here, once."""
        from ..parallel.serving import ShardedDetBatch
        det = ShardedDetBatch(self.model, mesh, self.arch)

        def fn(batch):
            return det(batch["pages"], batch["rhw"], encode=self.encode_map,
                       device="cpu")

        fn.close = det.close
        return fn

    @torch.inference_mode()
    def pages_boxes(self, batch) -> torch.Tensor:
        """The det batcher's boxes wave (`make_pages_boxes_fn`): host-resized
        uint8 canvases → (B, max_k, 10) float32 [quad in map coords (8),
        score, valid], the device DB extraction run on each page's map in
        turn (padding pages, extent 0, stay zero)."""
        args, pp = self.args, self.postprocess_op
        max_k = int(args.tpu_det_max_boxes)
        probs = self._pages_forward(batch)
        rhw = torch.as_tensor(batch["rhw"]).tolist()
        out = probs.new_zeros((len(rhw), max_k, 10))
        for i, (rh, rw) in enumerate(rhw):
            if rh and rw:
                quads, scores, valid = db_device.device_boxes(
                    probs[i], rh, rw, max_k=max_k, thresh=pp.thresh,
                    box_thresh=pp.box_thresh, unclip_ratio=pp.unclip_ratio,
                    min_size=float(pp.min_size),
                    scale=args.tpu_det_extract_scale,
                    score_scale=args.tpu_det_score_scale,
                    reduce=str(args.tpu_db_reduce),
                    score_k=int(args.tpu_det_score_k))
                out[i] = torch.cat([quads.reshape(max_k, 8), scores[:, None],
                                    valid[:, None].to(torch.float32)], -1)
        return out

    @torch.inference_mode()
    def infer_prob_map(self, img: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """The host det input: the page resized on the host into its bucket
        canvas, uploaded, DBNet → the map in the wire dtype, downloaded →
        (prob (rh, rw) float32 numpy, shape_info)."""
        padded, shape_info, (rh, rw) = det_pre.prepare_det_input(
            img, self.limit_side_len, self.limit_type, self.bucket,
            image_shape=self.image_shape, keep_ratio=self.keep_ratio)
        x = det_pre.normalize_det(torch.from_numpy(padded).to(self.device))
        wire = self.encode_map(self.forward(x, rh, rw))
        return self.decode_map(wire.cpu().numpy()[:rh, :rw]), shape_info

    def __call__(self, img: np.ndarray):
        """The reference's det contract on a BGR page: → the boxes in
        source coordinates after the det filter. Through the det batcher
        when there is one (the boxes mode's device extraction, or the
        wave's map: in the bits mode its float32 prob map, downloaded for
        the host scores), else the host det input."""
        batcher = self._page_batcher
        if batcher is not None and batcher.mode == "boxes":
            return self.filter_tag_det_res(batcher.submit_boxes(img),
                                           img.shape)
        if batcher is not None and batcher.mode == "bits":
            _, prob_dev, (rh, rw), shape_info = batcher.submit_bits(img)
            prob = self.decode_map(prob_dev.cpu().numpy()[:rh, :rw])
        elif batcher is not None:
            prob, shape_info = batcher.submit(img)
            prob = self.decode_map(prob)
        else:
            prob, shape_info = self.infer_prob_map(img)
        return self.boxes_from_prob(prob, shape_info, img.shape)

    @torch.inference_mode()
    def infer_prob_map_device(self, image_u8: torch.Tensor, src_h: int,
                              src_w: int) -> Tuple[np.ndarray, np.ndarray]:
        """The map route's det step: resize → DBNet → the map in the wire
        dtype, downloaded. → (prob (rh, rw) float32 numpy, shape_info
        [src_h, src_w, ratio_h, ratio_w])."""
        rh, rw = self.resize_target(src_h, src_w)
        hb = det_pre.round_up(rh, self.bucket)
        wb = det_pre.round_up(rw, self.bucket)
        x = resize_dev.resize_normalize_det(image_u8, src_h, src_w, rh, rw,
                                            hb, wb)
        wire = self.encode_map(self.forward(x, rh, rw))
        prob = self.decode_map(wire.cpu().numpy()[:rh, :rw])
        shape_info = np.array([src_h, src_w, rh / float(src_h),
                               rw / float(src_w)], dtype=np.float64)
        return prob, shape_info

    def boxes_from_prob(self, prob: np.ndarray, shape_info: np.ndarray,
                        ori_shape):
        """The host DB postprocess of a downloaded map, then the det
        filter (clip only for poly boxes)."""
        dt_boxes = self.postprocess_op({"maps": prob[None, None]},
                                       shape_info[None])[0]["points"]
        if self.args.det_box_type == "poly":
            return self.filter_tag_det_res_only_clip(dt_boxes, ori_shape)
        return self.filter_tag_det_res(dt_boxes, ori_shape)

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
        prob = self.forward(x, rh, rw)
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
        """The device-postprocess route's det step
        (tpu_det_postprocess='device'): only max_k × 10 floats return to
        the host. → (N, 4, 2) int32 boxes in source coords, before
        filter_tag_det_res."""
        rh, rw = det_pre.det_resize_target(src_h, src_w, self.limit_side_len)
        packed = self.boxes_packed(image_u8, src_h, src_w, rh, rw)
        return db_device.unpack_boxes(packed.cpu().numpy(), rw, rh, src_w,
                                      src_h)

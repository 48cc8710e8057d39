"""CTC text recognizer on the device. Counterpart of
onnxocr_tpu/pipeline/recognizer.py: the SVTR forward through the fused CTC
head kernel, the CRNN's, or a user's rec.onnx through the graph executor
(`RecForward`), and the two per-width-bucket paths over boxes of an uploaded
page — `run_boxes_fused` (cls + rec in one pass per bucket through
pipeline/fused.py: the staged device-det path, and the one-call pipeline's
re-runs for wide lines and boxes past its K_rec budget),
`run_candidates_scored` (the same pass scoring the bitmap wire's DB
candidates against the prob map on the device) and `run_boxes` (rec alone,
rotation verdicts given by the caller) — and the reference's `__call__` on
a list of host crops, resized with cv2's pixels (utils/cv_ops.py), which
the crop-list form of `ocr()` and the host crops take. With
`tpu_rec_microbatch` the fused paths hand each chunk, unpadded, to the
cross-request crop batcher (runtime/batcher.RecCropBatcher), which pads it
with other pages' chunks.
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
from ..ops.kernels import ctc_head
from ..utils import cv_ops
from . import backends, batching


class RecForward:
    """(N, 48, W, 3) float32 crops in [−1, 1] → ((N, T) int32 argmax, (N, T)
    float32 max-prob), by backend and architecture as the JAX package's
    RecForward:

    * native 'svtr' (the PP-OCR mobile families): T = W/8, the width
      masked to each row's valid token count, the fused CTC head kernel;
    * native 'crnn' (ch_ppocr_server_v2.0): T = W/4, no width mask, the
      (N, T, V) logits materialised and reduced by `ctc.ctc_reduce_logits`
      (the JAX package runs no Pallas head there);
    * 'graph' (a user's rec.onnx, onnx/executor.py): NCHW crops → the
      graph's (N, T, V) probabilities → `ctc.ctc_reduce`; no width mask.

    A native model computes in `dtype` (its parameters cast, the crops cast
    on the way in); its features and logits are float32, and the head
    kernel reads the bfloat16-rounded head in float32, as JAX's head
    wrapper casts it."""

    def __init__(self, tree, device: torch.device, arch: str = "svtr",
                 backend: str = "native", model_path: Optional[str] = None,
                 dtype=torch.float32):
        self.arch = arch
        self.backend = backend
        self.device = device
        self.dtype = dtype
        if backend == "graph":
            self.executor = GraphExecutor(model_path, name="rec",
                                          device=device)
        else:
            build = convert.build_crnn if arch == "crnn" \
                else convert.build_svtr
            self.model = build(tree, device, dtype=dtype)

    @property
    def masks_width(self) -> bool:
        """True when valid-region outputs do not depend on the bucket's
        padding (the width-masked native SVTR)."""
        return self.backend == "native" and self.arch == "svtr"

    def valid_t(self, valid_w: torch.Tensor) -> Optional[torch.Tensor]:
        """The token counts to mask with, from (N,) valid pixel widths;
        None for a forward that does not mask width."""
        return (valid_w + 7) // 8 if self.masks_width else None

    @torch.inference_mode()
    def __call__(self, crops: torch.Tensor,
                 valid_t: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = crops.permute(0, 3, 1, 2)
        if self.backend == "graph":
            ex = self.executor
            return ctc.ctc_reduce(ex({ex.input_names[0]: x})[0])
        x = x.to(self.dtype)
        if self.arch == "crnn":
            return ctc.ctc_reduce_logits(self.model(x))
        feats = self.model.features(x, valid_t)
        head = self.model.head
        return ctc_head.ctc_head_reduce_batched(feats, head.w_split,
                                                head.b.float())


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
        backend, path, tree, arch, _ = backends.resolve_backend(
            "rec", args.rec_model_dir, args.tpu_backend,
            vocab_size=len(self.postprocess_op.character),
            arch=backends.pick_arch("rec", args.rec_model_dir,
                                    args.rec_algorithm),
            allow_untrained=args.tpu_allow_untrained)
        # the decode-support mask is the native checkpoints' (a graph's
        # weights know the whole dictionary)
        if backend == "native" and \
                getattr(args, "tpu_decode_support", "trained") == "trained":
            sup = backends.trained_support(args.rec_char_dict_path)
            if sup is not None:
                tree = backends.apply_support_bias(tree, sup)
        self.forward = RecForward(
            tree, device, arch, backend, path,
            backends.stage_dtype(backend, args, "rec"))
        self._crop_batcher = None
        if args.tpu_rec_microbatch:
            self.enable_crop_batching(
                max_wait_ms=float(args.tpu_microbatch_wait_ms))

    def enable_crop_batching(self, max_wait_ms: float = 4.0) -> None:
        """Cross-request cls + rec batching: concurrent pages' crop chunks
        run as one fused pass over a stack of their pages
        (runtime/batcher.RecCropBatcher, ops/warp.warp_crops_multi)."""
        from ..runtime.batcher import RecCropBatcher
        self._crop_batcher = RecCropBatcher(
            max_wait_ms=max_wait_ms, batch_ladder=self.batch_ladder)

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

    def _group(self, desired_ws: List[int]):
        """Width-bucket routing; the width-masked SVTR lets every crop up to
        the collapse cap share one bucket, the CRNN runs each crop in its
        own bucket."""
        if self.forward.masks_width:
            return batching.group_collapsed(desired_ws, self.width_ladder)
        return batching.group_by_bucket(desired_ws, self.width_ladder)

    def _decode_chunk(self, crops, valid_ws: np.ndarray, n_real: int
                      ) -> List[Tuple[str, float]]:
        """One forward over a padded chunk of crops (numpy or a tensor,
        (bsz, 48, W, 3)) → the first n_real rows decoded."""
        valid = torch.as_tensor(np.asarray(valid_ws, np.int32)).to(
            self.device)
        crops = torch.as_tensor(crops).to(self.device)
        idx, prob = self.forward(crops, self.forward.valid_t(valid))
        return self._decode(idx[:n_real].cpu().numpy(),
                            prob[:n_real].cpu().numpy(),
                            valid_ws[:n_real], crops.shape[2])

    def _run_batches(self, make_crops, desired_ws: List[int]
                     ) -> List[Tuple[str, float]]:
        """make_crops(indices, bucket_w, bsz) → ((bsz, 48, bucket_w, 3)
        crops, (bsz,) valid widths), rows past the indices padding. One
        forward per (width bucket, chunk of at most the top batch size),
        padded up the batch ladder; results in input order."""
        results: List[Tuple[str, float]] = [("", 0.0)] * len(desired_ws)
        for bucket_w, indices in self._group(desired_ws).items():
            for chunk in batching.chunks_of(indices, self.batch_ladder[-1]):
                bsz = batching.pick_batch_bucket(len(chunk),
                                                 self.batch_ladder)
                crops, valid = make_crops(chunk, bucket_w, bsz)
                out = self._decode_chunk(crops, np.asarray(valid, np.int32),
                                         len(chunk))
                for i, res in zip(chunk, out):
                    results[i] = res
        return results

    def resize_norm_img(self, img: np.ndarray, bucket_w: int
                        ) -> Tuple[np.ndarray, int]:
        """The reference rec resize (predict_rec.py:54-80) against a bucket
        width: the crop at height 48 and its aspect's width (at most the
        bucket's), normalized to [−1, 1], zero-padded → (crop, its width)."""
        imgC, imgH, _ = self.rec_image_shape
        h, w = img.shape[:2]
        ratio = w / float(h)
        if math.ceil(imgH * ratio) > bucket_w:
            resized_w = bucket_w
        else:
            resized_w = int(math.ceil(imgH * ratio))
        resized = cv_ops.resize_linear(img, (resized_w, imgH)).astype(
            np.float32)
        resized = resized / 255.0
        resized = (resized - 0.5) / 0.5
        out = np.zeros((imgH, bucket_w, imgC), dtype=np.float32)
        out[:, :resized_w] = resized if resized.ndim == 3 \
            else resized[..., None]
        return out, resized_w

    def __call__(self, img_list: Sequence[np.ndarray]
                 ) -> List[Tuple[str, float]]:
        """The reference's host path: a list of crops (uint8, BGR or gray)
        → [(text, score)] in list order. The width floor is the configured
        rec width (320), as in the reference."""
        if len(img_list) == 0:
            return []
        imgH = self.rec_image_shape[1]
        min_w = int(self.rec_image_shape[2])
        desired = [max(min_w, math.ceil(imgH * im.shape[1] / im.shape[0]))
                   for im in img_list]

        def make_crops(indices, bucket_w, bsz):
            crops = np.zeros((bsz, imgH, bucket_w, 3), np.float32)
            valid = []
            for row, i in enumerate(indices):
                crops[row], vw = self.resize_norm_img(img_list[i], bucket_w)
                valid.append(vw)
            return crops, valid + [bucket_w] * (bsz - len(indices))

        return self._run_batches(make_crops, desired)

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
        eye = np.eye(3, dtype=np.float32)

        def make_crops(indices, bucket_w, bsz):
            mats = np.tile(eye, (bsz, 1, 1))
            valid = np.zeros(bsz, np.int32)
            for row, i in enumerate(indices):
                mats[row], valid[row] = warp_ops.build_crop_matrix(
                    boxes[i], imgH, bucket_w, rotate180=bool(rot180[i]))
            crops = warp_ops.warp_crops(
                image_u8, torch.from_numpy(mats).to(self.device),
                torch.from_numpy(valid).to(self.device), imgH, bucket_w,
                **self.warp_form)
            return crops, valid

        return self._run_batches(make_crops, self.desired_widths(boxes))

    def _fused_chunks(self, boxes: np.ndarray, cls_shape):
        """The fused passes over `boxes`, one per (width bucket, chunk of at
        most the top batch size) → (bucket_w, chunk indices, (cls_mats,
        cls_valid, rec_mats, rot_mats, rec_valid)), k = len(chunk) rows."""
        imgH = self.rec_image_shape[1]
        cls_h, cls_w = cls_shape
        groups = self._group(self.desired_widths(boxes))
        eye = np.eye(3, dtype=np.float32)
        for bucket_w, indices in groups.items():
            for chunk in batching.chunks_of(indices, self.batch_ladder[-1]):
                k = len(chunk)
                rec_mats = np.tile(eye, (k, 1, 1))
                rot_mats = np.tile(eye, (k, 1, 1))
                cls_mats = np.tile(eye, (k, 1, 1))
                rec_valid = np.zeros(k, np.int32)
                cls_valid = np.zeros(k, np.int32)
                for row, i in enumerate(chunk):
                    rec_mats[row], rec_valid[row] = \
                        warp_ops.build_crop_matrix(boxes[i], imgH, bucket_w)
                    rot_mats[row], _ = warp_ops.build_crop_matrix(
                        boxes[i], imgH, bucket_w, rotate180=True)
                    cls_mats[row], cls_valid[row] = \
                        warp_ops.build_crop_matrix(boxes[i], cls_h, cls_w)
                yield bucket_w, chunk, (cls_mats, cls_valid, rec_mats,
                                        rot_mats, rec_valid)

    def _padded(self, mats, quads=None):
        """A chunk's arrays (and quads) padded to its batch bucket: rows
        past the chunk keep the identity and a valid width (quad) of 0."""
        k = len(mats[0])
        bsz = batching.pick_batch_bucket(k, self.batch_ladder)
        eye = np.eye(3, dtype=np.float32)

        def pad(a, fill):
            if bsz == k:
                return a
            rows = np.tile(fill, (bsz - k,) + (1,) * fill.ndim)
            return np.concatenate([a, rows.astype(a.dtype)])

        zero = np.zeros((), np.int32)
        out = tuple(pad(a, eye if a.ndim == 3 else zero) for a in mats)
        if quads is None:
            return out
        return out, pad(quads, np.zeros((4, 2), np.float32))

    def _promote(self, bucket_w: int) -> bool:
        """A chunk the crop batcher may run at any wider width: the
        width-masked SVTR makes that exact below the collapse cap. A CRNN
        chunk runs alone at its own bucket."""
        return self.forward.masks_width and \
            bucket_w <= batching.COLLAPSE_CAP

    def run_boxes_fused(self, image_u8: torch.Tensor, boxes: np.ndarray,
                        fused, cls_shape, use_cls: bool = True
                        ) -> List[Tuple[str, float]]:
        """One fused device pass and one download per (width bucket, chunk):
        the classifier's verdicts select the 180°-turned homographies on the
        device (pipeline/fused.py), so nothing returns to the host between
        cls and rec. Arguments as run_boxes; cls_shape = (cls_h, cls_w).
        With the crop batcher, each chunk joins other pages' chunks."""
        results: List[Tuple[str, float]] = [("", 0.0)] * len(boxes)
        imgH = self.rec_image_shape[1]
        for bucket_w, chunk, mats in self._fused_chunks(boxes, cls_shape):
            k = len(chunk)
            if self._crop_batcher is not None:
                idx, prob, run_w = self._crop_batcher.submit(
                    fused, image_u8, *mats, imgH, bucket_w, use_cls,
                    promote=self._promote(bucket_w))
            else:
                packed = fused(image_u8, *self._padded(mats), imgH, bucket_w,
                               use_cls=use_cls).cpu().numpy()
                T = (packed.shape[1] - 3) // 2
                idx, prob, run_w = packed[:k, :T], packed[:k, T:2 * T], \
                    bucket_w
            out = self._decode(idx.astype(np.int32), prob, mats[-1], run_w)
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
        against the prob map on the device (fused.call_scored, or the crop
        batcher's call_multi_scored, each quad against its own page's
        map), so the map is never downloaded. Padding rows carry zero
        quads. → (rec results, DB box scores (N,) float32) in candidate
        order; the caller applies the box_thresh filter."""
        results: List[Tuple[str, float]] = [("", 0.0)] * len(boxes)
        scores = np.zeros(len(boxes), np.float32)
        imgH = self.rec_image_shape[1]
        for bucket_w, chunk, mats in self._fused_chunks(boxes, cls_shape):
            k = len(chunk)
            quads = pre_quads[chunk]
            if self._crop_batcher is not None:
                idx, prob_max, sc, run_w = self._crop_batcher.submit(
                    fused, image_u8, *mats, imgH, bucket_w, use_cls,
                    promote=self._promote(bucket_w), prob_dev=prob,
                    pre_quads=quads, rhw=np.array([rh, rw], np.int32))
            else:
                padded, quads = self._padded(mats, quads)
                packed = fused.call_scored(image_u8, prob, rh, rw, quads,
                                           *padded, imgH, bucket_w,
                                           use_cls=use_cls).cpu().numpy()
                T = (packed.shape[1] - 1) // 2
                idx, prob_max, sc, run_w = packed[:k, :T], \
                    packed[:k, T:2 * T], packed[:k, 2 * T], bucket_w
            out = self._decode(idx.astype(np.int32), prob_max, mats[-1],
                               run_w)
            for row, i in enumerate(chunk):
                results[i] = out[row]
                scores[i] = sc[row]
        return results, scores

"""One-call OCR on the device: det → DB boxes → crop matrices → rec → CTC
head, with one device→host copy of a packed buffer per page.

Port of onnxocr_tpu/pipeline/onecall.py (single page):

    upload the edge-padded page → resize + normalize into the fixed det
    canvas → DBNet → device DB extraction in the extraction window →
    rescale / clockwise / clip / side filter → compact valid boxes into a
    K_rec prefix → crop homographies → (with the classifier: warp 48×192
    cls crops → cls → select the 180°-turned homographies) → warp rec
    crops at one width (shear-staged by default) → SVTR → fused CTC head
    (the CRNN: logits → reduce, T = W/4) → one packed (K_rec + 1 + det
    rows, 12 + 2T) float32 buffer

Packed layout (as in the JAX package): K_rec body rows [quad (8), score,
valid, valid width, desired width, idx (T), prob (T)]; a tail row whose
first entry is n_valid; then all K_det filtered quads + valid flags,
flattened into rows of the same width. Wide lines (desired width > the rec
width) and boxes past K_rec re-run through the recognizer's fused
per-bucket path against the same uploaded page.

With `tpu_onecall_wave`, concurrent calls (the serving engine's threads)
hand their uploaded pages to `_WaveCoalescer`, whose thread runs whatever
is queued as one multi-page step (`step_wave`: one DBNet forward, the DB
extraction per page, one gather warp and one recognizer pass over every
page's crops) with one download a wave, at the largest page count of
`tpu_onecall_wave_tiers` that has been warmed; a lone call runs the
single-page step at once and never waits.

`sharded_batch_fn` runs a page batch over a mesh of devices: each data row
runs `step_wave` on its share of the pages with its own replica of the det,
cls and rec models, on its device's worker thread (parallel/mesh.Rows).
"""
from __future__ import annotations

import copy
import math
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import db_device, det_pre, resize_dev, warp_dev
from ..utils.profiling import CAPTURE


class OneCallPipeline:
    def __init__(self, detector, recognizer, fused, args,
                 device: torch.device):
        self.detector = detector
        self.recognizer = recognizer
        self.fused = fused
        self.device = device
        self.rec_w = int(args.tpu_onecall_rec_width)
        self.k_rec = int(args.tpu_onecall_max_boxes)
        self.k_det = int(args.tpu_onecall_det_candidates)
        self.imgH = recognizer.rec_image_shape[1]
        self.extract_scale = db_device.parse_extract_scale(
            args.tpu_det_extract_scale)
        self.score_scale = db_device.parse_extract_scale(
            args.tpu_det_score_scale)
        self.db_reduce = str(args.tpu_db_reduce)
        self.score_k = int(args.tpu_det_score_k)
        self.axis_snap = float(args.tpu_det_axis_snap)
        self.ex_bucket = int(args.tpu_det_extract_window)
        self.fixed_canvas = bool(args.tpu_onecall_fixed_canvas)
        self._wave = None
        if args.tpu_onecall_wave:
            tiers = sorted({int(t) for t in
                            str(args.tpu_onecall_wave_tiers).split(",")
                            if t.strip() and int(t) > 1})
            if tiers:
                self._wave = _WaveCoalescer(self, tiers)

    def _ex_window(self, rh: int, rw: int, hb: int, wb: int
                   ) -> Tuple[int, int]:
        """Extraction window for a page's valid size; (0, 0) = off."""
        b = self.ex_bucket
        if not b:
            return 0, 0
        return (min(hb, det_pre.round_up(max(rh, 1), b)),
                min(wb, det_pre.round_up(max(rw, 1), b)))

    def canvas(self, src_h: int, src_w: int):
        """→ (rh, rw) resize target, (hb, wb) det canvas, (eh, ew) window."""
        det = self.detector
        rh, rw = det_pre.det_resize_target(src_h, src_w, det.limit_side_len)
        if self.fixed_canvas:
            # one square canvas for every page: the valid_hw masking makes
            # the det map over the valid region independent of the padding
            cap = det_pre.round_up(int(det.limit_side_len), det.bucket)
            hb = wb = max(cap, det_pre.round_up(max(rh, rw), det.bucket))
        else:
            hb = det_pre.round_up(rh, det.bucket)
            wb = det_pre.round_up(rw, det.bucket)
        return (rh, rw), (hb, wb), self._ex_window(rh, rw, hb, wb)

    def source_boxes(self, quads_m, scores, valid, r_h: int, r_w: int,
                     src_h: int, src_w: int):
        """Det-map boxes → (quads_s, valid, quads_c, scores_c, valid_c): every
        candidate in source coordinates (rounded, clipped to [0, src], in
        the reference's clockwise order, clip and side filter applied) and
        the K_rec prefix of the valid ones, raster order kept."""
        qx = torch.clamp(torch.round(quads_m[..., 0] / float(r_w) * src_w),
                         0.0, float(src_w))
        qy = torch.clamp(torch.round(quads_m[..., 1] / float(r_h) * src_h),
                         0.0, float(src_h))
        quads_s = warp_dev.order_points_clockwise(torch.stack([qx, qy], -1))
        quads_s, keep = warp_dev.clip_filter_boxes(quads_s, src_h, src_w)
        valid = valid & keep
        take = torch.argsort((~valid).to(torch.int32), stable=True)[:self.k_rec]
        return quads_s, valid, quads_s[take], scores[take], valid[take]

    def page_boxes(self, prob: torch.Tensor, r_h: int, r_w: int,
                   src_h: int, src_w: int, ex_h: int = 0, ex_w: int = 0):
        """One page's det map (H, W) → source_boxes' five tensors, the DB
        extraction run in the extraction window (ex_h, ex_w) when it is
        smaller than the map."""
        pp = self.detector.postprocess_op
        H, W = prob.shape
        if ex_h and ex_w and (ex_h < H or ex_w < W):
            prob = prob[:ex_h, :ex_w]
        quads_m, scores, valid = db_device.device_boxes(
            prob.contiguous(), r_h, r_w, max_k=self.k_det, thresh=pp.thresh,
            box_thresh=pp.box_thresh, unclip_ratio=pp.unclip_ratio,
            min_size=float(pp.min_size), scale=self.extract_scale,
            score_scale=self.score_scale, reduce=self.db_reduce,
            score_k=self.score_k, axis_snap=self.axis_snap)
        return self.source_boxes(quads_m, scores, valid, r_h, r_w, src_h,
                                 src_w)

    def _crop_mats(self, quads_c, valid_c, use_cls: bool):
        """→ (cls_mats, cls_valid, rec_mats, rec_mats_rot, rec_valid,
        desired) of the compacted boxes; the cls pair is the rec pair when
        the classifier is off (nothing reads it then)."""
        rec_m, rec_m_rot, rec_vw, desired = warp_dev.crop_matrices(
            quads_c, valid_c, self.imgH, self.rec_w)
        rec_vw = torch.where(valid_c, rec_vw, 0)
        cls_m, cls_vw = rec_m, rec_vw
        if use_cls:
            fused = self.fused
            cls_m, _, cls_vw, _ = warp_dev.crop_matrices(
                quads_c, valid_c, fused.cls_h, fused.cls_w)
            cls_vw = torch.where(valid_c, cls_vw, 0)
        return cls_m, cls_vw, rec_m, rec_m_rot, rec_vw, desired

    @staticmethod
    def _pack(boxes, rec_vw, desired, idx, prob_max) -> torch.Tensor:
        """One page's packed buffer from its source_boxes tensors and its
        K_rec rows of the rec pass."""
        quads_s, valid, quads_c, scores_c, valid_c = boxes
        k_rec = quads_c.shape[0]
        T = idx.shape[1]
        wbuf = 12 + 2 * T
        f32 = torch.float32
        body = torch.cat([quads_c.reshape(k_rec, 8), scores_c[:, None],
                          valid_c[:, None].to(f32), rec_vw[:, None].to(f32),
                          desired[:, None].to(f32), idx.to(f32),
                          prob_max.to(f32)], -1)
        tail = torch.zeros((1, wbuf), dtype=f32, device=body.device)
        tail[0, 0] = valid.sum().to(f32)
        det_flat = torch.cat([quads_s.reshape(-1, 8),
                              valid[:, None].to(f32)], -1).reshape(-1)
        n_det_rows = -(-det_flat.shape[0] // wbuf)
        det_block = torch.cat([det_flat, det_flat.new_zeros(
            n_det_rows * wbuf - det_flat.shape[0])]).reshape(n_det_rows, wbuf)
        return torch.cat([body, tail, det_block], 0)

    @torch.inference_mode()
    def step(self, image_u8: torch.Tensor, src_h: int, src_w: int,
             r_h: int, r_w: int, out_h: int, out_w: int, ex_h: int = 0,
             ex_w: int = 0, use_cls: bool = False) -> torch.Tensor:
        """The single-page program: → packed float32 buffer on the device."""
        x = resize_dev.resize_normalize_det(image_u8, src_h, src_w, r_h, r_w,
                                            out_h, out_w)
        prob = self.detector.net(x.permute(2, 0, 1)[None], (r_h, r_w))[0]
        boxes = self.page_boxes(prob, r_h, r_w, src_h, src_w, ex_h, ex_w)
        cls_m, cls_vw, rec_m, rec_m_rot, rec_vw, desired = self._crop_mats(
            boxes[2], boxes[4], use_cls)
        if use_cls:
            rec_m, _, _ = self.fused.select_mats(image_u8, cls_m, cls_vw,
                                                 rec_m, rec_m_rot)
        crops = self.fused.warp(image_u8, rec_m, rec_vw, self.imgH,
                                self.rec_w)
        rec = self.recognizer.forward
        idx, prob_max = rec(crops, rec.valid_t(rec_vw))
        return self._pack(boxes, rec_vw, desired, idx, prob_max)

    @torch.inference_mode()
    def step_wave(self, images_u8: torch.Tensor, src_h: Sequence[int],
                  src_w: Sequence[int], r_h: Sequence[int],
                  r_w: Sequence[int], out_h: int, out_w: int, ex_h: int = 0,
                  ex_w: int = 0, use_cls: bool = False) -> torch.Tensor:
        """The multi-page program (the JAX package's vmapped `_make_step(
        use_cls, wave=True)`): images_u8 (B, Hs, Ws, 3) pages of one source
        bucket, the per-page sizes as B ints → (B, rows, 12 + 2T) float32
        on the device, each page's block decoding as `step`'s buffer.

        One DBNet forward over the B canvases (the mbv3's masked to each
        page's extent), the DB extraction per page, then one gather warp of
        the cls crops, one cls forward, one gather warp of the rec crops and
        one recognizer pass over every page's K_rec crops. The wave warps
        in the gather form, whatever the configured form, as the JAX
        package's wave does."""
        B = images_u8.shape[0]
        dev = images_u8.device
        x = torch.stack([resize_dev.resize_normalize_det(
            images_u8[b], src_h[b], src_w[b], r_h[b], r_w[b], out_h, out_w)
            for b in range(B)])
        vh = torch.as_tensor(list(r_h), device=dev)
        vw = torch.as_tensor(list(r_w), device=dev)
        probs = self.detector.net(x.permute(0, 3, 1, 2), (vh, vw))
        pages = [self.page_boxes(probs[b], r_h[b], r_w[b], src_h[b],
                                 src_w[b], ex_h, ex_w) for b in range(B)]
        k = pages[0][2].shape[0]
        quads_c = torch.cat([p[2] for p in pages])
        valid_c = torch.cat([p[4] for p in pages])
        *mats, desired = self._crop_mats(quads_c, valid_c, use_cls)
        img_idx = torch.arange(B, device=dev).repeat_interleave(k)
        packed = self.fused.call_multi(images_u8, img_idx, *mats, self.imgH,
                                       self.rec_w, use_cls)
        T = packed.shape[1] // 2
        idx, prob_max = packed[:, :T], packed[:, T:]
        rec_vw = mats[-1]
        rows = [slice(b * k, (b + 1) * k) for b in range(B)]
        return torch.stack([self._pack(p, rec_vw[r], desired[r], idx[r],
                                       prob_max[r])
                            for p, r in zip(pages, rows)])

    def _row_pipeline(self, dev, det_model, cls_fwd, rec_fwd):
        """A shallow copy of this pipeline that runs on `dev` with the given
        replicas (no wave coalescer, no det batcher)."""
        det = copy.copy(self.detector)
        det.model, det.device, det._page_batcher = det_model, dev, None
        fused = copy.copy(self.fused)
        fused.cls_forward, fused.rec_forward = cls_fwd, rec_fwd
        pipe = copy.copy(self)
        pipe.detector, pipe.fused, pipe.device, pipe._wave = \
            det, fused, dev, None
        return pipe

    def sharded_batch_fn(self, use_cls: bool, mesh, out_h: int = 0,
                         out_w: int = 0):
        """The multi-device one-call program (the JAX package's vmapped
        wave step sharded over the mesh's `data` axis): each data row runs
        `step_wave` on its share of the pages, with its own replica of the
        det, cls and rec models (built here, once) on the row's first
        device, from that device's worker thread (mesh.Rows): rows on
        different cards overlap although `step_wave` waits on its device
        inside the labelling, rows that share a card run in turn. No
        collectives: pages are independent.

        The det canvas (out_h, out_w) defaults to round_up(limit_side_len,
        bucket) when 0. The JAX package's callable takes the det, cls and
        rec param trees first; the port's modules hold their weights, so
        the returned callable holds the replicas and takes the page
        arguments only:

            fn(images_u8 (B, Hs, Ws, 3) uint8, src_h, src_w, r_h, r_w (B,)
               ints) → (B, rows, 12 + 2T) float32 packed buffers on row 0's
               device, each page's block decoding as the single-page
               download. B must split evenly over the rows, as the JAX
               program's input sharding requires."""
        from ..parallel import mesh as mesh_lib
        if not out_h or not out_w:
            det = self.detector
            cap = det_pre.round_up(int(det.limit_side_len), det.bucket)
            out_h = out_h or cap
            out_w = out_w or cap
        use_cls = self.use_cls(use_cls)
        rows = mesh_lib.Rows(mesh)
        n = len(rows)
        dets = mesh_lib.replicate(self.detector.model, mesh)
        recs = _replicate_forward(self.fused.rec_forward, mesh)
        clss = _replicate_forward(self.fused.cls_forward, mesh) \
            if use_cls else [self.fused.cls_forward] * n
        pipes = [self._row_pipeline(dev, *models) for dev, *models in
                 zip(rows.devices, dets, clss, recs)]

        def row(i, images, src_h, src_w, r_h, r_w):
            ints = [np.asarray(a).astype(int).tolist()
                    for a in (src_h, src_w, r_h, r_w)]
            return pipes[i].step_wave(
                torch.as_tensor(images).to(rows.devices[i]), *ints,
                out_h, out_w, 0, 0, use_cls)

        def fn(images_u8, src_h, src_w, r_h, r_w) -> torch.Tensor:
            if len(images_u8) % n:
                raise ValueError(f"{len(images_u8)} pages do not split "
                                 f"over {n} data rows")
            return rows.split(row, (images_u8, src_h, src_w, r_h, r_w))

        fn.rows = rows
        return fn

    def use_cls(self, cls: bool) -> bool:
        """Whether a call with `cls` runs the classifier."""
        return bool(cls and self.fused.cls_forward is not None and
                    self.fused.idx180 is not None)

    def run_packed(self, img: np.ndarray, use_cls: bool = False):
        """Upload a BGR page and run the program (through the wave
        coalescer when it is on) → (packed numpy buffer, uploaded page on
        the device)."""
        image_dev, src_h, src_w = resize_dev.put_src_bucket(img, self.device)
        (rh, rw), (hb, wb), (eh, ew) = self.canvas(src_h, src_w)
        if self._wave is not None:
            packed = self._wave.run(use_cls, image_dev, src_h, src_w, rh, rw,
                                    hb, wb, eh, ew)
        else:
            packed = self._run_single(use_cls, image_dev, src_h, src_w, rh,
                                      rw, hb, wb, eh, ew)
        return packed, image_dev

    def _run_single(self, use_cls: bool, image_dev: torch.Tensor,
                    src_h: int, src_w: int, rh: int, rw: int, hb: int,
                    wb: int, eh: int = 0, ew: int = 0) -> np.ndarray:
        if CAPTURE.enabled:
            CAPTURE.record("onecall",
                           lambda *a: self.step(*a, hb, wb, eh, ew, use_cls),
                           (image_dev, src_h, src_w, rh, rw))
        return self.step(image_dev, src_h, src_w, rh, rw, hb, wb, eh, ew,
                         use_cls).cpu().numpy()

    def close(self):
        """Stop the wave coalescer's thread, if any."""
        if self._wave is not None:
            self._wave.close()

    def __call__(self, img: np.ndarray, cls: bool = False
                 ) -> Tuple[np.ndarray, List[Tuple[str, float]]]:
        """→ (boxes (N, 4, 2) float32, [(text, score)]) in device (raster)
        order; the caller applies the sorted-boxes pairing and drop_score."""
        use_cls = self.use_cls(cls)
        packed, image_dev = self.run_packed(img, use_cls)
        return self.decode_packed(packed, image_dev, use_cls)

    def _rerun(self, image_dev, boxes, use_cls: bool):
        fused = self.fused
        return self.recognizer.run_boxes_fused(
            image_dev, boxes, fused, (fused.cls_h, fused.cls_w),
            use_cls=use_cls)

    def decode_packed(self, packed: np.ndarray, image_dev: torch.Tensor,
                      use_cls: bool = False
                      ) -> Tuple[np.ndarray, List[Tuple[str, float]]]:
        body = packed[:self.k_rec]
        n_valid = int(packed[self.k_rec, 0])
        rows = body[body[:, 9] > 0.5]
        if n_valid == 0 or rows.shape[0] == 0:
            return np.zeros((0, 4, 2), np.float32), []
        boxes = rows[:, :8].reshape(-1, 4, 2).astype(np.float32)
        rec_vw = rows[:, 10].astype(np.int32)
        desired = rows[:, 11].astype(np.int32)
        T = (body.shape[1] - 12) // 2
        idx = rows[:, 12:12 + T].astype(np.int32)
        prob_max = rows[:, 12 + T:]
        stride = self.rec_w // T
        valid_t = [min(T, int(math.ceil(w / stride))) for w in rec_vw]
        rec_res = self.recognizer.postprocess_op.decode_indices(
            idx, prob_max, is_remove_duplicate=True, valid_t=valid_t)

        wide = np.nonzero(desired > self.rec_w)[0]
        if len(wide):
            redo = self._rerun(image_dev, boxes[wide], use_cls)
            for i, res in zip(wide, redo):
                rec_res[i] = res

        if n_valid > self.k_rec:
            # the det block carries every filtered quad: keep the K_rec
            # prefix results, recognize only the remainder
            det_flat = packed[self.k_rec + 1:].reshape(-1)
            det_rows = det_flat[:self.k_det * 9].reshape(self.k_det, 9)
            boxes_all = det_rows[det_rows[:, 8] > 0.5, :8].reshape(
                -1, 4, 2).astype(np.float32)
            rest = self._rerun(image_dev, boxes_all[self.k_rec:], use_cls)
            return boxes_all, rec_res + rest
        return boxes, rec_res


def _replicate_forward(fwd, mesh) -> list:
    """Per data row, a shallow copy of a cls or rec forward whose model (a
    graph's executor) is that row's replica."""
    from ..parallel import mesh as mesh_lib
    attr = "executor" if fwd.backend == "graph" else "model"
    out = []
    for dev, model in zip(mesh_lib.row_devices(mesh),
                          mesh_lib.replicate(getattr(fwd, attr), mesh)):
        f = copy.copy(fwd)
        setattr(f, attr, model)
        f.device = dev
        out.append(f)
    return out


class _WaveReq:
    __slots__ = ("key", "image_dev", "src_h", "src_w", "rh", "rw",
                 "event", "packed", "error")

    def __init__(self, key, image_dev, src_h, src_w, rh, rw):
        self.key = key
        self.image_dev = image_dev
        self.src_h = src_h
        self.src_w = src_w
        self.rh = rh
        self.rw = rw
        self.event = threading.Event()
        self.packed = None
        self.error = None


class _WaveCoalescer:
    """Coalesces concurrent one-call pages into multi-page waves.

    Each caller queues its uploaded page and waits; one dispatcher thread
    takes the pages queued at that moment that share the oldest page's key
    (use_cls, source bucket, det canvas, extraction window) and runs them as
    one `step_wave` with one download, at the largest tier that is at most
    the group's size and has been warmed. Anything else runs batch 1
    through the single-page `step` (in the configured warp form), so a lone
    page never waits for company.

    A tier becomes usable after a warm pass on zero pages at its batch size
    (the card's first runs of a shape pick convolution algorithms and grow
    the allocator's pools): started in the background the first time a key
    shows a backlog for it, or by `warm_sync`. A warm that fails leaves the
    tier cold and the requests on batch 1; its error is kept in
    stats["warm_errors"]. An error in a wave reaches every caller of it."""

    def __init__(self, pipe: OneCallPipeline, tiers: List[int]):
        self.pipe = pipe
        self.tiers = sorted(tiers, reverse=True)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: List[_WaveReq] = []
        self._ready = set()      # (key, B) warmed
        self._warming = set()
        self._closed = False
        self._hold = False       # test hook: dispatch nothing while set
        self.stats = {"waves": {}, "pages": 0, "warm_errors": []}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="onecall-wave")
        self._thread.start()

    @staticmethod
    def _key(use_cls, src_shape, hb, wb, eh, ew):
        return (bool(use_cls), tuple(src_shape), int(hb), int(wb), int(eh),
                int(ew))

    def run(self, use_cls, image_dev, src_h, src_w, rh, rw, hb, wb,
            eh=0, ew=0) -> np.ndarray:
        """Queue one uploaded page and wait for its packed buffer."""
        req = _WaveReq(self._key(use_cls, image_dev.shape, hb, wb, eh, ew),
                       image_dev, int(src_h), int(src_w), int(rh), int(rw))
        with self._cv:
            if self._closed:
                raise RuntimeError("wave coalescer closed")
            self._queue.append(req)
            self._cv.notify()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.packed

    def close(self, timeout: float = 5.0):
        """Stop the dispatcher once the queue is empty."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)

    def _loop(self):
        with torch.inference_mode():
            while True:
                with self._cv:
                    while (not self._queue or self._hold) and \
                            not self._closed:
                        self._cv.wait(0.1)
                    if self._closed and not self._queue:
                        return
                    key = self._queue[0].key
                    group = [r for r in self._queue if r.key == key]
                    want = next((t for t in self.tiers if t <= len(group)),
                                1)
                    B = next((t for t in self.tiers if t <= len(group) and
                              (key, t) in self._ready), 1)
                    if want > B and (key, want) not in self._warming:
                        self._warming.add((key, want))
                        threading.Thread(target=self._warm, daemon=True,
                                         args=(key, want)).start()
                    batch = group[:B]
                    for r in batch:
                        self._queue.remove(r)
                try:
                    self._dispatch(key, batch)
                except Exception as e:  # every caller of the wave gets it
                    for r in batch:
                        r.error = e
                        r.event.set()

    def _dispatch(self, key, batch: List[_WaveReq]):
        use_cls, _, hb, wb, eh, ew = key
        pipe = self.pipe
        n = len(batch)
        self.stats["pages"] += n
        self.stats["waves"][n] = self.stats["waves"].get(n, 0) + 1
        if n == 1:
            r = batch[0]
            r.packed = pipe._run_single(use_cls, r.image_dev, r.src_h,
                                        r.src_w, r.rh, r.rw, hb, wb, eh, ew)
            r.event.set()
            return
        out = pipe.step_wave(
            torch.stack([r.image_dev for r in batch]),
            [r.src_h for r in batch], [r.src_w for r in batch],
            [r.rh for r in batch], [r.rw for r in batch], hb, wb, eh, ew,
            use_cls).cpu().numpy()
        for i, r in enumerate(batch):
            r.packed = out[i]
            r.event.set()

    def _warm(self, key, B: int):
        """Run the (key, B) wave once on zero pages on the device; the tier
        is usable after it."""
        try:
            with torch.inference_mode():
                use_cls, src_shape, hb, wb, eh, ew = key
                images = torch.zeros((B,) + tuple(src_shape),
                                     dtype=torch.uint8,
                                     device=self.pipe.device)
                ones = [32] * B
                self.pipe.step_wave(images, ones, ones, ones, ones, hb, wb,
                                    eh, ew, use_cls).cpu()
            with self._cv:
                self._ready.add((key, B))
        except Exception as e:  # the tier stays cold; requests run batch 1
            with self._cv:
                self.stats["warm_errors"].append(
                    f"{(key, B)}: {type(e).__name__}: {e}")
        finally:
            with self._cv:
                self._warming.discard((key, B))

    def warm_sync(self, use_cls: bool, src_shape, hb: int, wb: int, B: int,
                  eh: int = 0, ew: int = 0):
        """Warm one tier now, on the calling thread (engine warm-up,
        tests)."""
        self._warm(self._key(use_cls, src_shape, hb, wb, eh, ew), B)

"""Cross-request batching in front of one card. Counterpart of
onnxocr_tpu/runtime/batcher.py.

Concurrent `ocr()` calls from several threads hand their device work to a
batcher thread, which waits up to `max_wait_ms` for more, runs one device
call for all of them and hands each caller its rows back:

* `DetPageBatcher`: the pages' DBNet forwards as one wave of up to 8
  pages on the fixed det canvas, or of the pages that share a canvas
  shape for the ResNet DBNet (the bitmap wire: the wave's bitpacked
  bitmaps come down as one copy, the prob maps stay on the device; the
  maps wire; the boxes mode's device DB extraction);
* `RecCropBatcher`: the pages' crop chunks as one multi-page fused pass
  (pipeline/fused.py `call_multi_scored` / `call_multi`);
* `BatchedForward`: a cls or rec forward behind a `MicroBatcher` (the
  serving engine's opt-in MICRO_BATCH), concurrent calls' rows as one.

Both keep the JAX package's grouping, ladders and padding, so the rows and
the decode stride are the reference's. A failure in a batch is raised in
every caller waiting on it, never retried another way. The threads are
daemons; `close()` stops one. Each enters inference mode itself: the
grad mode is per thread.
"""
from __future__ import annotations

import queue
import threading
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import db_device, det_pre, resize_dev
from ..utils.profiling import CAPTURE


class _Work:
    __slots__ = ("item", "event", "result", "error")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


def _fail(works: List[_Work], error: BaseException) -> None:
    """Hand `error` to every caller of `works` still waiting."""
    for w in works:
        if not w.event.is_set():
            w.error = error
            w.event.set()


def _wait(work: _Work):
    work.event.wait()
    if work.error is not None:
        raise work.error
    return work.result


def _tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts / tuples / lists, zipped with the
    leaves of `rest`, which share tree's structure; None is no leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _flatten(tree):
    """→ (leaves, a hashable description of the structure)."""
    if tree is None:
        return [], "none"
    if isinstance(tree, dict):
        parts = [_flatten(v) for v in tree.values()]
        return [x for p in parts for x in p[0]], \
            ("dict", tuple(tree), tuple(p[1] for p in parts))
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(v) for v in tree]
        return [x for p in parts for x in p[0]], \
            (type(tree).__name__, tuple(p[1] for p in parts))
    return [tree], None


def _download(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class MicroBatcher:
    """fn(batch) → a tree of arrays with leading dim B, behind a queue.
    `submit(item)` (a tensor or array (k, ...), or a tree of them sharing
    the leading dim) blocks until fn has run on the batch holding it, and
    returns fn's output rows for the item. Items group by the tree of their
    trailing shapes and dtypes; each group runs as one call padded with
    zero rows up `batch_ladder`. `to_host(out)` makes fn's output what the
    callers get (default: everything downloaded to numpy)."""

    def __init__(self, fn: Callable, max_batch: int = 64,
                 max_wait_ms: float = 4.0,
                 batch_ladder: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                 to_host: Optional[Callable] = None):
        self.fn = fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.batch_ladder = tuple(batch_ladder)
        self._to_host = to_host or (lambda out: _tree_map(_download, out))
        self._q: "queue.Queue[Optional[_Work]]" = queue.Queue()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ocr-microbatcher")
        self._thread.start()

    def close(self, timeout: float = 2.0):
        self._stop = True
        self._q.put(None)  # wake
        self._thread.join(timeout=timeout)

    def submit(self, item):
        """Tensor leaves stay on their device; others become numpy."""
        work = _Work(_tree_map(
            lambda a: a if isinstance(a, torch.Tensor) else np.asarray(a),
            item))
        self._q.put(work)
        return _wait(work)

    @staticmethod
    def _batch_size(item) -> int:
        return _flatten(item)[0][0].shape[0]

    def _loop(self):
        with torch.inference_mode():
            while not self._stop:
                work = self._q.get()
                if work is None:
                    continue
                batch: List[_Work] = [work]
                total = self._batch_size(work.item)
                timeout = self.max_wait
                while total < self.max_batch:
                    try:
                        nxt = self._q.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if nxt is None:
                        break
                    timeout = 0.0  # only wait once per batch
                    batch.append(nxt)
                    total += self._batch_size(nxt.item)
                try:
                    self._run(batch)
                except BaseException as e:
                    # every caller of the batch gets the error; one that is
                    # no Exception (an exit) ends the thread as well
                    _fail(batch, e)
                    if not isinstance(e, Exception):
                        raise

    @staticmethod
    def _group_key(item):
        leaves, structure = _flatten(item)
        return (structure, tuple((tuple(a.shape[1:]), str(a.dtype),
                                  str(getattr(a, "device", "host")))
                                 for a in leaves))

    def _run(self, batch: List[_Work]):
        groups: Dict[tuple, List[_Work]] = {}
        for w in batch:
            groups.setdefault(self._group_key(w.item), []).append(w)
        for works in groups.values():
            try:
                self._run_group(works)
            except Exception as e:
                _fail(works, e)

    def _run_group(self, works: List[_Work]):
        sizes = [self._batch_size(w.item) for w in works]
        n = sum(sizes)
        bsz = max(n, next((b for b in self.batch_ladder if n <= b),
                          self.batch_ladder[-1]))

        def stack(*leaves):
            if isinstance(leaves[0], torch.Tensor):
                parts = list(leaves)
                if bsz > n:
                    parts.append(leaves[0].new_zeros(
                        (bsz - n,) + tuple(leaves[0].shape[1:])))
                return torch.cat(parts) if len(parts) > 1 else parts[0]
            out = np.concatenate(leaves)
            if bsz > n:
                out = np.concatenate([out, np.zeros(
                    (bsz - n,) + out.shape[1:], out.dtype)])
            return out

        stacked = _tree_map(stack, works[0].item,
                            *[w.item for w in works[1:]])
        if CAPTURE.enabled:
            CAPTURE.record("det_pages_b%d" % bsz, self.fn, (stacked,))
        out = self._to_host(self.fn(stacked))
        off = 0
        for w, k in zip(works, sizes):
            w.result = _tree_map(lambda a, o=off, kk=k: a[o:o + kk], out)
            off += k
            w.event.set()


def _bits_to_host(out):
    """The det wave's one download: the bitpacked bitmaps; the prob maps
    stay on the device."""
    bits, probs = out
    return bits.cpu().numpy(), probs


class DetPageBatcher:
    """Cross-request det batching. With `fixed_canvas` (the masked mbv3
    DBNet) each page goes into ONE fixed det canvas,
    round_up(limit_side_len, bucket)², so that every page joins the same
    group: the per-page extents make the canvas padding invisible.
    Without it (the ResNet, whose map depends on the padding) each page
    takes its own bucket canvas, as the unbatched host det input does, and
    pages group by canvas shape. Concurrent pages run `fn` as one wave of
    up to 8, in one of the JAX package's three modes:

    * 'bits' (the bitmap wire): fn = TextDetector.pages_bits; the wave's
      bitmaps download as one copy and each page gets a view of its prob
      map on the device. A page comes resized on the device from the page
      the crop warps read (`submit_bits_dev`, fixed canvas only) or, with
      tpu_det_batch_input='host' and for det-only calls and tiny pages,
      resized on the host (`submit_bits`);
    * 'maps': fn = TextDetector.pages_maps; host-resized pages, the maps
      in the wire dtype downloaded (`submit`);
    * 'boxes': fn = TextDetector.pages_boxes; host-resized pages, the
      device DB extraction per page, only the packed boxes downloaded
      (`submit_boxes`).

    The host resize is det_pre.prepare_det_input (cv2's pixels, the tiny
    page quirk kept).

    With `mesh` (serving across cards), fn is the maps wave split over the
    mesh's data rows (TextDetector.pages_maps_sharded) and the batch ladder
    is padded up to multiples of the data axis, max(n_data, ceil(b /
    n_data) * n_data), as in the JAX package; the mode must be 'maps' (the
    JAX package's mesh turns its wire into maps), and the boxes mode drops
    the mesh (its sharded program is "not yet" there)."""

    def __init__(self, fn: Callable, mode: str, limit_side_len: float = 960,
                 limit_type: str = "max", max_wait_ms: float = 8.0,
                 batch_ladder: Sequence[int] = (1, 2, 4, 8),
                 bucket: int = 320, fixed_canvas: bool = True, mesh=None):
        if limit_type != "max":
            raise ValueError("the det batcher needs limit_type 'max'")
        if mode not in ("bits", "maps", "boxes"):
            raise ValueError(f"unknown det batcher mode {mode!r}")
        if mode == "boxes":
            mesh = None
        if mesh is not None:
            if mode != "maps":
                raise ValueError("a det batcher on a mesh runs the maps "
                                 f"mode, not {mode}")
            n_data = mesh.shape["data"]
            batch_ladder = tuple(sorted({
                max(n_data, -(-b // n_data) * n_data) for b in batch_ladder}))
        self.mesh = mesh
        self.mode = mode
        self.limit_side_len = limit_side_len
        self.limit_type = limit_type
        self.bucket = bucket
        self.canvas = None
        if fixed_canvas:
            cap = det_pre.round_up(int(limit_side_len), bucket)
            self.canvas = (cap, cap)
        self.batcher = MicroBatcher(
            fn, max_batch=batch_ladder[-1], max_wait_ms=max_wait_ms,
            batch_ladder=batch_ladder,
            to_host=_bits_to_host if mode == "bits" else None)
        self._fn = fn

    def close(self):
        """Stop the batcher's thread and, on a mesh, the rows' threads."""
        self.batcher.close()
        close = getattr(self._fn, "close", None)
        if self.mesh is not None and close is not None:
            close()

    def _prepare(self, img: np.ndarray):
        """The host det input on the fixed canvas, or the page's own
        bucket canvas → (canvas uint8, shape_info, (rh, rw))."""
        return det_pre.prepare_det_input(
            img, self.limit_side_len, self.limit_type, bucket=self.bucket,
            canvas=self.canvas)

    def _submit_host(self, img: np.ndarray, mode: str):
        """One host-resized page through the wave → (the wave's rows of
        it, shape_info, (rh, rw))."""
        if self.mode != mode:
            raise RuntimeError(f"the det batcher runs the {self.mode} mode, "
                               f"not {mode}")
        padded, shape_info, (rh, rw) = self._prepare(img)
        out = self.batcher.submit({"pages": padded[None],
                                   "rhw": np.array([[rh, rw]], np.int32)})
        return out, shape_info, (rh, rw)

    def submit(self, img: np.ndarray):
        """The maps mode: BGR page → (its map (rh, rw) in the wire dtype,
        shape_info)."""
        out, shape_info, (rh, rw) = self._submit_host(img, "maps")
        return out[0][:rh, :rw], shape_info

    def submit_bits(self, img: np.ndarray):
        """The bits mode from the host resize: BGR page → (bitmap (rh, rw)
        uint8 0/1, its prob map (H, W) on the device, (rh, rw),
        shape_info)."""
        (bits_rows, prob_rows), shape_info, (rh, rw) = self._submit_host(
            img, "bits")
        bitmap = det_pre.unpack_bitmap(bits_rows[0][:rh, :(rw + 7) // 8], rw)
        return bitmap, prob_rows[0], (rh, rw), shape_info

    def submit_boxes(self, img: np.ndarray) -> np.ndarray:
        """The boxes mode: BGR page → (N, 4, 2) int32 quads in source
        coordinates, before the det filter."""
        out, _, (rh, rw) = self._submit_host(img, "boxes")
        src_h, src_w = img.shape[:2]
        return db_device.unpack_boxes(out[0], rw, rh, src_w, src_h)

    def submit_bits_dev(self, image_dev: torch.Tensor, src_h: int,
                        src_w: int):
        """The bits mode from the device resize: image_dev (Hs, Ws, 3) uint8
        page on the device, padded to its source bucket (valid src_h ×
        src_w) → as submit_bits (shape_info float32, as the JAX package's).
        Fixed canvas only, as in the JAX package."""
        assert self.mode == "bits" and self.canvas is not None
        rh, rw = det_pre.det_resize_target(src_h, src_w, self.limit_side_len,
                                           self.limit_type)
        cap_h, cap_w = self.canvas
        x = resize_dev.resize_normalize_det(image_dev, src_h, src_w, rh, rw,
                                            cap_h, cap_w)
        bits_rows, prob_rows = self.batcher.submit(
            {"pages": x[None], "rhw": np.array([[rh, rw]], np.int32)})
        bitmap = det_pre.unpack_bitmap(bits_rows[0][:rh, :(rw + 7) // 8], rw)
        shape_info = np.array([src_h, src_w, rh / float(src_h),
                               rw / float(src_w)], np.float32)
        return bitmap, prob_rows[0], (rh, rw), shape_info


class RecCropBatcher:
    """Cross-request cls + rec batching: concurrent pages' crop chunks that
    share a source bucket (and width bucket, unless promoted) run as ONE
    fused pass over a stack of their pages (FusedClsRec.call_multi_scored
    on the bitmap wire, call_multi otherwise). Every run takes the multi
    pass, a lone page's too, so every crop is warped in the gather form.

    Groups of two pages or more run at the canonical shapes the JAX
    package keeps for XLA's static shapes: the top batch size, a width of
    COALESCE_WIDTHS and b_img pages from `img_ladder` (padded by passing
    page 0 again). The width-masked SVTR makes a wider run exact, and the
    decode stride follows the run width the caller gets back."""

    #: run widths a promoted multi-page group may execute at
    COALESCE_WIDTHS = (640, 960)

    def __init__(self, max_wait_ms: float = 4.0,
                 batch_ladder: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                 img_ladder: Sequence[int] = (1, 2, 4)):
        self.batch_ladder = tuple(batch_ladder)
        self.img_ladder = tuple(img_ladder)
        self.max_wait = max_wait_ms / 1000.0
        # canonical shapes warm_canonical() has run. Once any is
        # registered, multi-page groups run only at registered shapes; an
        # unwarmed (rare) source bucket runs its pages solo
        self._warmed: set = set()
        self._q: "queue.Queue[Optional[_Work]]" = queue.Queue()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ocr-recbatcher")
        self._thread.start()

    @staticmethod
    def _canon_key(image_shape, prob_shape, b_img, width, out_h, use_cls):
        return (tuple(image_shape),
                tuple(prob_shape) if prob_shape is not None else None,
                int(b_img), int(width), int(out_h), bool(use_cls))

    def close(self, timeout: float = 2.0):
        self._stop = True
        self._q.put(None)
        self._thread.join(timeout=timeout)

    def submit(self, fused, image_dev, cls_mats, cls_valid, rec_mats,
               rot_mats, rec_valid, out_h: int, bucket_w: int,
               use_cls: bool, promote: bool = False, prob_dev=None,
               pre_quads=None, rhw=None):
        """One page's crop chunk of k rows (unpadded) → (idx (k, T), prob
        (k, T)[, scores (k,)], run width) as numpy. Blocks until the group
        holding it has run.

        promote=True: the chunk may run at any width ≥ bucket_w (the
        width-masked SVTR, no crop wider than the collapse cap), so it
        coalesces with other pages' chunks of other width buckets.
        prob_dev / pre_quads / rhw (the bitmap wire): the page's prob map
        on the device, the chunk's pre-unclip quads (k, 4, 2) in map
        coordinates and the map's valid (rh, rw); the group then runs the
        scored pass and each row's box score comes back."""
        item = {
            "fused": fused, "image": image_dev,
            "cls_mats": np.asarray(cls_mats, np.float32),
            "cls_valid": np.asarray(cls_valid, np.int32),
            "rec_mats": np.asarray(rec_mats, np.float32),
            "rot_mats": np.asarray(rot_mats, np.float32),
            "rec_valid": np.asarray(rec_valid, np.int32),
            "out_h": out_h, "bucket_w": bucket_w, "use_cls": use_cls,
            "promote": promote}
        if prob_dev is not None:
            item["prob"] = prob_dev
            item["pre_quads"] = np.asarray(pre_quads, np.float32)
            item["rhw"] = np.asarray(rhw, np.int32)
        work = _Work(item)
        self._q.put(work)
        return _wait(work)

    def warm_canonical(self, fused, image_shape, out_h: int,
                       use_cls: bool = True, prob_shape=None) -> List[str]:
        """Run every canonical multi-page shape of one source bucket once:
        b_img in img_ladder[1:] × COALESCE_WIDTHS at the top batch size, on
        zero pages, and register each, so that no first use of a shape
        (cuDNN's choice of algorithms, the allocator's first blocks) falls
        inside live traffic."""
        device = fused.rec_forward.device
        bsz = self.batch_ladder[-1]
        eye = np.tile(np.eye(3, dtype=np.float32), (bsz, 1, 1))
        valid = np.zeros(bsz, np.int32)
        img_idx = np.zeros(bsz, np.int32)
        quads = np.zeros((bsz, 4, 2), np.float32)
        warmed = []
        for b_img in [b for b in self.img_ladder if b >= 2]:
            images = torch.zeros((b_img,) + tuple(image_shape),
                                 dtype=torch.uint8, device=device)
            if prob_shape is not None:
                probs = torch.zeros((b_img,) + tuple(prob_shape),
                                    device=device)
                rhw = np.tile(np.array([list(prob_shape)], np.int32),
                              (b_img, 1))
            for cw in self.COALESCE_WIDTHS:
                if prob_shape is not None:
                    out = fused.call_multi_scored(
                        images, probs, rhw, img_idx, quads, eye, valid,
                        eye, eye, valid, out_h, cw, use_cls=use_cls)
                else:
                    out = fused.call_multi(
                        images, img_idx, eye, valid, eye, eye, valid,
                        out_h, cw, use_cls=use_cls)
                out.cpu()
                self._warmed.add(self._canon_key(
                    image_shape, prob_shape, b_img, cw, out_h, use_cls))
                warmed.append("i%d_w%d" % (b_img, cw))
        return warmed

    def _loop(self):
        with torch.inference_mode():
            while not self._stop:
                work = self._q.get()
                if work is None:
                    continue
                batch: List[_Work] = [work]
                timeout = self.max_wait
                while len(batch) < self.img_ladder[-1]:
                    try:
                        nxt = self._q.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if nxt is None:
                        break
                    timeout = 0.0  # only wait once per batch
                    batch.append(nxt)
                try:
                    self._run(batch)
                except BaseException as e:
                    # every caller of the batch gets the error; one that is
                    # no Exception (an exit) ends the thread as well
                    _fail(batch, e)
                    if not isinstance(e, Exception):
                        raise

    @staticmethod
    def _group_key(item):
        return (tuple(item["image"].shape),
                "*" if item.get("promote") else item["bucket_w"],
                item["out_h"], item["use_cls"], id(item["fused"]),
                tuple(item["prob"].shape) if "prob" in item else None)

    def _run(self, batch: List[_Work]):
        groups: Dict[tuple, List[_Work]] = {}
        for w in batch:
            groups.setdefault(self._group_key(w.item), []).append(w)
        max_n = self.batch_ladder[-1]
        for key, works in groups.items():
            if key[1] != "*":
                # chunks that were not promoted never coalesce: each runs
                # alone, at its own bucket and batch size
                packs = [[w] for w in works]
            else:
                # greedy packing: a group never exceeds the top batch size
                packs, cur, cur_n = [], [], 0
                for w in works:
                    k = len(w.item["cls_mats"])
                    if cur and cur_n + k > max_n:
                        packs.append(cur)
                        cur, cur_n = [], 0
                    cur.append(w)
                    cur_n += k
                if cur:
                    packs.append(cur)
            for pack in packs:
                try:
                    self._run_group(pack)
                except Exception as e:
                    _fail(pack, e)

    def _run_group(self, works: List[_Work]):
        item0 = works[0].item
        fused = item0["fused"]
        out_h = item0["out_h"]
        bucket_w = max(w.item["bucket_w"] for w in works)
        use_cls = item0["use_cls"]
        scored = "prob" in item0
        sizes = [len(w.item["cls_mats"]) for w in works]
        n = sum(sizes)
        n_img = len(works)
        b_img = max(n_img, next((b for b in self.img_ladder if n_img <= b),
                                self.img_ladder[-1]))
        if n_img >= 2:
            # the canonical shapes: the top batch size and a width of
            # COALESCE_WIDTHS, whatever the pages brought
            bucket_w = next((cw for cw in self.COALESCE_WIDTHS
                             if bucket_w <= cw), bucket_w)
            if self._warmed and self._canon_key(
                    item0["image"].shape,
                    item0["prob"].shape if scored else None,
                    b_img, bucket_w, out_h, use_cls) not in self._warmed:
                for w in works:
                    self._run_group([w])
                return
            bsz = self.batch_ladder[-1]
        else:
            bsz = next((b for b in self.batch_ladder if n <= b),
                       self.batch_ladder[-1])
        bsz = max(bsz, n)
        eye = np.eye(3, dtype=np.float32)

        def pack(key, pad_val=None):
            out = np.concatenate([w.item[key] for w in works])
            if bsz > n:
                pad = np.zeros((bsz - n,) + out.shape[1:], out.dtype) \
                    if pad_val is None else \
                    np.tile(pad_val, (bsz - n,) + (1,) * pad_val.ndim)
                out = np.concatenate([out, pad])
            return out

        img_idx = np.zeros(bsz, np.int32)
        img_idx[:n] = np.repeat(np.arange(n_img, dtype=np.int32), sizes)
        # padding pages pass page 0 again
        pages = [w.item for w in works] + [item0] * (b_img - n_img)
        images = _stack_pages([p["image"] for p in pages])
        mats = (pack("cls_mats", eye), pack("cls_valid"),
                pack("rec_mats", eye), pack("rot_mats", eye),
                pack("rec_valid"), out_h, bucket_w)
        if scored:
            probs = torch.stack([p["prob"] for p in pages])
            rhw = np.stack([p["rhw"] for p in pages])
            fn = partial(fused.call_multi_scored, use_cls=use_cls)
            args = (images, probs, rhw, img_idx,
                    pack("pre_quads", np.zeros((4, 2), np.float32)), *mats)
        else:
            fn = partial(fused.call_multi, use_cls=use_cls)
            args = (images, img_idx, *mats)
        if CAPTURE.enabled:
            # a one-page scored run is this route's per-page fused program:
            # the name the JAX package's bench looks for
            CAPTURE.record("fused_scored" if (b_img == 1 and scored) else
                           "rec_multi%s_i%d" % ("_scored" if scored else "",
                                                b_img), fn, args)
        packed = fn(*args).cpu().numpy()
        T = (packed.shape[1] - 1) // 2 if scored else packed.shape[1] // 2
        idx = packed[:, :T].astype(np.int32)
        prob = packed[:, T:2 * T]
        off = 0
        for w, k in zip(works, sizes):
            # the run width rides along: a promoted group may have run
            # wider than the page's own bucket (decode stride run_w // T)
            rows = slice(off, off + k)
            w.result = (idx[rows], prob[rows], packed[rows, 2 * T],
                        bucket_w) if scored else \
                (idx[rows], prob[rows], bucket_w)
            off += k
            w.event.set()


def _stack_pages(images: Sequence[torch.Tensor]) -> torch.Tensor:
    """(H, W, 3) pages on the device → (B, H, W, 3), copied on the device."""
    return torch.stack(list(images))


class BatchedForward:
    """A forward (the recognizer's `RecForward` or the classifier's
    `ClsForward`) behind a MicroBatcher: concurrent calls' positional
    arguments (the crops and, for the rec forward, the per-row token
    counts, or None) are stacked along the row axis and run as one call;
    each caller gets its rows of the outputs, left on the device as the
    forward returns them. Other attributes are the forward's."""

    def __init__(self, forward, max_batch: int = 64,
                 max_wait_ms: float = 4.0):
        self.forward = forward
        self.batcher = MicroBatcher(lambda args: forward(*args),
                                    max_batch=max_batch,
                                    max_wait_ms=max_wait_ms,
                                    to_host=lambda out: out)

    def __getattr__(self, name):
        return getattr(self.forward, name)

    def __call__(self, *args):
        return self.batcher.submit(tuple(args))

    def close(self):
        self.batcher.close()

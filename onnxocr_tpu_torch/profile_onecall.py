"""Where the time goes in the ported paths on one GPU.

    python3 -m onnxocr_tpu_torch.profile_onecall [--pages N] [--out DIR]
        [--path onecall|onecall_cls|staged_device|staged_host]
        [--warp-stage off|shear] [--family v5|v4|server]

Runs ONNXPaddleOcr(device="cuda") (TF32 off, the committed checkpoints of
`--family`: PP-OCRv5 by default, PP-OCRv4, or the ch_ppocr_server_v2.0
ResNet18-vd DBNet + CRNN; a stand-in dictionary) over committed held-out
pages — `onecall`: the
one-call path at the 960² det canvas with the label-keyed reductions,
classifier off; `onecall_cls`: the same with the slot-keyed reductions and
the (untrained) angle classifier; `staged_device`: the staged device-det
path on each page's own det canvas with the slot-keyed reductions and the
classifier, cls + rec fused per width bucket; `staged_host`: the defaults,
the staged bitmap wire (upload, det forward + bitpack, bitmap download,
host candidates: contour trace, min-area fit, unclip; scored fused calls,
decode) — in the crop warp form `--warp-stage` (default: the config's),
and reports, per page on average:

* stage times: each stage of the path re-run on its own with a device
  synchronize after it (host clock, so launch overhead counts), the cls
  and rec crop warps among them, and how many crops the shear form takes;
  for the CRNN also `rec_bilstm`, its two BiLSTM calls (on the staged
  paths: those within the fused or scored passes, already part of them);
* end-to-end page time (`ocr()`, host clock) and the device busy share
  over a steady window (sum of CUDA kernel time from torch.profiler over
  the window's wall time), with the kernels that take the most device time.

Prints one JSON object as its last line; writes a chrome trace to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from . import ONNXPaddleOcr, config
from .ops import ctc, db_device, det_pre, native, resize_dev, warp_dev
from .ops import warp as warp_ops
from .ops.kernels import build, ctc_head, seg_reduce, seg_reduce2
from .pipeline.system import sorted_boxes
from .utils.png import read_bgr

KWARGS = {
    "onecall": dict(tpu_pipeline="onecall", use_angle_cls=False),
    "onecall_cls": dict(tpu_pipeline="onecall", tpu_db_reduce="pallas",
                        use_angle_cls=True, tpu_allow_untrained=True),
    "staged_device": dict(tpu_pipeline="staged", tpu_det_postprocess="device",
                          tpu_db_reduce="pallas", use_angle_cls=True,
                          tpu_allow_untrained=True),
    "staged_host": {},
}
# family → (model kwargs, dictionary stand-in: file name, entries)
FAMILIES = {
    "v5": ({}, "ppocrv5_dict.txt", 18383),
    "v4": (dict(det_model_dir=config.find_asset("ppocrv4/det/det.onnx"),
                rec_model_dir=config.find_asset("ppocrv4/rec/rec.onnx")),
           "ppocrv5_dict.txt", 18383),
    "server": (dict(
        det_model_dir=config.find_asset("ch_ppocr_server_v2.0/det/det.onnx"),
        rec_model_dir=config.find_asset("ch_ppocr_server_v2.0/rec/rec.onnx")),
        "ppocr_keys_v1.txt", 6623),
}


def _timer(acc):
    def t(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        acc[name] = acc.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out
    return t


def timed_bilstm(ocr, acc):
    """Time the CRNN's BiLSTM calls under `rec_bilstm` (nothing for SVTR)
    → undo."""
    rec = ocr.text_recognizer.forward
    if rec.arch != "crnn":
        return lambda: None
    t = _timer(acc)
    lstms = (rec.model.lstm1, rec.model.lstm2)
    for lstm in lstms:
        real = lstm.forward
        lstm.forward = lambda *a, real=real, **kw: t(
            "rec_bilstm", lambda: real(*a, **kw))

    def undo():
        for lstm in lstms:
            del lstm.forward
    return undo


class _TimedFused:
    """The fused cls + rec step, each call timed under its (width bucket,
    batch size) and counted."""

    def __init__(self, fused, t, calls):
        self.fused, self.t, self.calls = fused, t, calls

    def __call__(self, image, cls_m, cls_v, rec_m, rot_m, rec_v, out_h,
                 out_w, use_cls=True):
        name = f"cls_rec_w{out_w}_b{len(rec_v)}"
        self.calls[name] = self.calls.get(name, 0) + 1
        return self.t(name, lambda: self.fused(
            image, cls_m, cls_v, rec_m, rot_m, rec_v, out_h, out_w,
            use_cls=use_cls))


def _timed_warps(fused, t, counts):
    """Time the fused step's crop warps as `cls_warp` / `rec_warp` (by the
    crop height and width) and count their live and shear-eligible crops
    into `counts`; → a function that undoes it."""
    def warp(image, mats, valid_w, out_h, out_w):
        kind = "cls" if (out_h, out_w) == (fused.cls_h, fused.cls_w) \
            else "rec"
        live = valid_w > 0
        elig = warp_ops._shear_mask(mats, valid_w, out_h) & live
        counts[f"{kind}_crops"] = counts.get(f"{kind}_crops", 0) + \
            int(live.sum())
        counts[f"{kind}_shear_eligible"] = \
            counts.get(f"{kind}_shear_eligible", 0) + int(elig.sum())
        return t(f"{kind}_warp", lambda: type(fused).warp(
            fused, image, mats, valid_w, out_h, out_w))

    fused.warp = warp
    return lambda: vars(fused).pop("warp")


# substrings of the names of the kernels in csrc/
OWN_KERNELS = ("ctc_head_partial", "ctc_head_combine", "moment_sums_kernel",
               "proj_extents_kernel", "seg_sum_kernel", "seg_min_kernel")


@torch.inference_mode()
def _stages_staged(ocr, img, acc, calls, counts):
    """One page through the staged device-det path, stage by stage."""
    det, rec, fused = ocr.text_detector, ocr.text_recognizer, ocr._fused
    args, pp = ocr.args, det.postprocess_op
    t = _timer(acc)
    image, h, w = t("upload", lambda: resize_dev.put_src_bucket(
        img, ocr.device))
    rh, rw = det_pre.det_resize_target(h, w, det.limit_side_len)
    hb, wb = (det_pre.round_up(v, det.bucket) for v in (rh, rw))
    x = t("det_resize", lambda: resize_dev.resize_normalize_det(
        image, h, w, rh, rw, hb, wb))
    prob = t("det_forward", lambda: det.model(
        x.permute(2, 0, 1)[None], valid_hw=(rh, rw))[0]).contiguous()
    K = int(args.tpu_det_max_boxes)
    sy, sx = db_device.parse_extract_scale(args.tpu_det_extract_scale)
    grid, _, gh, gw = db_device.working_grid(prob, rh, rw, sy, sx)
    grid = grid.contiguous()
    lab, ids, _ = t("db_label", lambda: db_device.label_components(
        grid, gh, gw, K, pp.thresh))
    slot, hit = t("db_slot_map", lambda: db_device.label_slots(lab, K))

    def stats_fn():
        fx, fy = db_device.cell_coords(*lab.shape, sy, sx, lab.device)
        return fx, fy, db_device.moment_stats(grid, hit, fx, fy)

    fx, fy, stats = t("db_stats", stats_fn)
    sums = t("db_seg_sum", lambda: seg_reduce.seg_sum_bands(slot, stats, K))
    cols = t("db_axes_cols", lambda: db_device.proj_columns(
        slot, hit, db_device.pca_axes(sums), fx, fy))
    t("db_seg_min", lambda: seg_reduce.seg_min_bands(slot, cols, K))
    # the whole extraction on this page's map, slot-keyed as the path runs
    # it and label-keyed (the default of the one-call path) beside it
    for name, reduce in (("db_device_boxes_total", str(args.tpu_db_reduce)),
                         ("db_device_boxes_pallas2", "pallas2")):
        t(name, lambda: db_device.device_boxes(
            prob, rh, rw, max_k=K, thresh=pp.thresh,
            box_thresh=pp.box_thresh, unclip_ratio=pp.unclip_ratio,
            min_size=float(pp.min_size), scale=(sy, sx), reduce=reduce,
            score_k=int(args.tpu_det_score_k)))
    t("det_packed_total", lambda: det.boxes_packed(image, h, w, rh, rw))
    raw = t("det_total_with_download", lambda: det.infer_boxes_device(
        image, h, w))
    boxes = t("host_filter_sort", lambda: sorted_boxes(
        det.filter_tag_det_res(raw, img.shape)))
    if len(boxes):
        quads = np.asarray(boxes, np.float32)
        undo = _timed_warps(fused, t, counts)
        undo_lstm = timed_bilstm(ocr, acc)
        try:
            t("cls_rec_total", lambda: rec.run_boxes_fused(
                image, quads, _TimedFused(fused, t, calls),
                (fused.cls_h, fused.cls_w), use_cls=True))
        finally:
            undo()
            undo_lstm()


class _TimedScored:
    """The bitmap wire's scored fused step, each call timed under its
    (width bucket, batch size) and counted."""

    def __init__(self, fused, t, calls):
        self.fused, self.t, self.calls = fused, t, calls

    def call_scored(self, image, prob, rh, rw, quads, *rest, use_cls=True):
        name = f"scored_w{rest[-1]}_b{len(quads)}"
        self.calls[name] = self.calls.get(name, 0) + 1
        return self.t(name, lambda: self.fused.call_scored(
            image, prob, rh, rw, quads, *rest, use_cls=use_cls))


@torch.inference_mode()
def _stages_host(ocr, img, acc, calls):
    """One page through the staged bitmap wire, stage by stage."""
    det, rec, fused = ocr.text_detector, ocr.text_recognizer, ocr._fused
    pp = det.postprocess_op
    t = _timer(acc)
    image, h, w = t("upload", lambda: resize_dev.put_src_bucket(
        img, ocr.device))
    bits, prob, (rh, rw) = t("det_forward_bitpack", lambda: (
        det.bitmap_forward(image, h, w, ocr._fixed_canvas())))
    bitmap = t("bitmap_download", lambda: det_pre.unpack_bitmap(
        bits.cpu().numpy()[:rh, :rw // 8], rw))
    t("host_trace", lambda: native.find_contours_filtered(
        bitmap * 255, float(pp.min_size) ** 2, pp.max_candidates))
    pre, cand = t("host_candidates", lambda: pp.candidates_from_bitmap(
        bitmap, img.shape[1], img.shape[0]))
    boxes, pre = t("host_filter", lambda: ocr._keep_candidates(
        pre, cand, img.shape))
    if len(boxes) == 0:
        return
    real_decode = rec._decode
    rec._decode = lambda *a: t("decode", lambda: real_decode(*a))
    undo_lstm = timed_bilstm(ocr, acc)
    try:
        t("scored_total", lambda: rec.run_candidates_scored(
            image, prob, rh, rw, boxes, pre, _TimedScored(fused, t, calls),
            (fused.cls_h, fused.cls_w), use_cls=False))
    finally:
        del rec._decode
        undo_lstm()
    t("page_total", lambda: ocr.ocr(img, cls=False))


@torch.inference_mode()
def _stages(ocr, img, acc, counts):
    """One page through the one-call step's stages, timed one by one."""
    oc = ocr._onecall
    det = ocr.text_detector
    pp = det.postprocess_op
    t = _timer(acc)

    image, h, w = t("upload", lambda: resize_dev.put_src_bucket(
        img, ocr.device))
    (rh, rw), (hb, wb), (eh, ew) = oc.canvas(h, w)
    x = t("det_resize", lambda: resize_dev.resize_normalize_det(
        image, h, w, rh, rw, hb, wb))
    prob = t("det_forward", lambda: det.model(
        x.permute(2, 0, 1)[None], valid_hw=(rh, rw))[0])
    prob = prob[:eh or hb, :ew or wb].contiguous()
    sy, sx = oc.extract_scale
    grid, _, gh, gw = db_device.working_grid(prob, rh, rw, sy, sx)
    lab, ids, _ = t("db_label", lambda: db_device.label_components(
        grid, gh, gw, oc.k_det, pp.thresh))
    sums = t("db_moment_sums", lambda: seg_reduce2.label_moment_sums(
        lab, grid, ids, sy, sx))
    axes = db_device.pca_axes(sums)
    t("db_proj_extents", lambda: seg_reduce2.label_proj_extents(
        lab, axes, ids, sy, sx))
    quads, scores, valid = t("db_device_boxes_total", lambda:
                             db_device.device_boxes(
        prob, rh, rw, max_k=oc.k_det, thresh=pp.thresh,
        box_thresh=pp.box_thresh, unclip_ratio=pp.unclip_ratio,
        min_size=float(pp.min_size), scale=oc.extract_scale,
        reduce=oc.db_reduce, score_k=oc.score_k))
    fused = oc.fused

    def crop_inputs():  # the step's own source boxes and crop matrices
        _, _, quads_c, _, valid_c = oc.source_boxes(quads, scores, valid, rh,
                                                    rw, h, w)
        rec_m, rot_m, vw, _ = warp_dev.crop_matrices(quads_c, valid_c,
                                                     oc.imgH, oc.rec_w)
        cls_m, _, cls_vw, _ = warp_dev.crop_matrices(
            quads_c, valid_c, fused.cls_h, fused.cls_w)
        return (rec_m, rot_m, torch.where(valid_c, vw, 0), cls_m,
                torch.where(valid_c, cls_vw, 0))

    mats, rot, vw, cls_m, cls_vw = t("crop_matrices", crop_inputs)
    undo = _timed_warps(fused, t, counts)
    try:
        if oc.use_cls(True):
            mats = t("cls_select", lambda: fused.select_mats(
                image, cls_m, cls_vw, mats, rot)[0])
        crops = fused.warp(image, mats, vw, oc.imgH, oc.rec_w)
    finally:
        undo()
    rec = ocr.text_recognizer.forward
    x = crops.permute(0, 3, 1, 2)
    if rec.arch == "crnn":
        feats = t("rec_features", lambda: rec.model.features(x))
        hid = t("rec_bilstm", lambda: rec.model.lstm2(
            rec.model.lstm1(feats)[0])[0])
        t("rec_head_reduce", lambda: ctc.ctc_reduce_logits(
            rec.model.head(hid)))
    else:
        feats = t("rec_features", lambda: rec.model.features(
            x, rec.valid_t(vw)))
        head = rec.model.head
        t("ctc_head", lambda: ctc_head.ctc_head_reduce_batched(
            feats, head.w_split, head.b))
    use_cls = oc.use_cls(True)
    t("step_total", lambda: oc.step(image, h, w, rh, rw, hb, wb, eh, ew,
                                    use_cls))
    packed = oc.step(image, h, w, rh, rw, hb, wb, eh, ew, use_cls)
    t("download_decode", lambda: oc.decode_packed(packed.cpu().numpy(),
                                                  image, use_cls))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pages", type=int, default=8)
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--path", default="onecall", choices=sorted(KWARGS))
    ap.add_argument("--warp-stage", choices=("off", "upright", "shear"),
                    default=config.DEFAULTS["tpu_warp_stage"])
    ap.add_argument("--family", default="v5", choices=sorted(FAMILIES))
    args = ap.parse_args()
    staged = args.path == "staged_device"
    cls = args.path in ("onecall_cls", "staged_device")
    if not torch.cuda.is_available():
        raise SystemExit("profile_onecall: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    heldout = config.ASSETS.parent / "test_images_heldout"
    names = sorted(p.stem for p in heldout.glob("*.png"))[:args.pages]
    pages = [read_bgr(str(heldout / f"{n}.png")) for n in names]
    with tempfile.TemporaryDirectory() as tmp:
        family_kw, dict_name, entries = FAMILIES[args.family]
        dict_path = os.path.join(tmp, dict_name)
        with open(dict_path, "w") as f:
            f.write("".join(f"<{i}>\n" for i in range(entries)))
        ocr = ONNXPaddleOcr(device="cuda", rec_char_dict_path=dict_path,
                            tpu_warp_stage=args.warp_stage,
                            **family_kw, **KWARGS[args.path])
        # every (width, batch) shape the pages reach is used once before
        # anything is timed
        for img in pages:
            ocr.ocr(img, cls=cls)
        stages: dict = {}
        calls: dict = {}
        counts: dict = {}
        for img in pages:
            if staged:
                _stages_staged(ocr, img, stages, calls, counts)
            elif args.path == "staged_host":
                _stages_host(ocr, img, stages, calls)
            else:
                _stages(ocr, img, stages, counts)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for img in pages:
                ocr.ocr(img, cls=cls)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, f"{args.path}_trace.json"))
    cuda = torch.autograd.DeviceType.CUDA
    kern = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == cuda]
    kern.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kern)
    n = len(pages)
    report = {
        "card": smi, "path": args.path, "family": args.family,
        "warp_stage": args.warp_stage,
        "pages": n,
        "page_ms": wall_ms / n,
        # None: the profiler recorded no device time (not measured)
        "device_busy_ms_per_page": busy_ms / n if busy_ms else None,
        "device_busy_share": busy_ms / wall_ms if busy_ms else None,
        "stage_ms_per_page": {k: v / n for k, v in stages.items()},
        # fused cls + rec (or scored) calls by (width bucket, batch size),
        # whole run
        "cls_rec_calls": calls,
        # crops with a valid width, and those the shear form takes, whole run
        "warp_crops": counts,
        # the hand-written kernels: [name, device ms per launch, launches
        # per page]
        "own_kernels": [[k.replace("(anonymous namespace)::", "")
                         .replace("void ", "").split("(")[0], ms / c, c / n]
                        for k, ms, c in kern
                        if any(o in k for o in OWN_KERNELS)],
        "top_kernels_ms_per_page": [
            [k, ms / n, c // n] for k, ms, c in kern[:12]],
    }
    for k, v in report["stage_ms_per_page"].items():
        print(f"{k:24s} {v:8.3f} ms")
    print(json.dumps(report))


if __name__ == "__main__":
    main()

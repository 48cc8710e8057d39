"""Where the time goes in the one-call path on one GPU.

    python3 -m onnxocr_tpu_torch.profile_onecall [--pages N] [--out DIR]

Runs ONNXPaddleOcr(device="cuda") (TF32 off, 960² det canvas, committed v5
checkpoints, a stand-in dictionary) over committed held-out pages and
reports, per page on average:

* stage times: each stage of OneCallPipeline.step re-run on its own with a
  device synchronize after it (host clock, so launch overhead counts);
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

import torch

from . import ONNXPaddleOcr, config
from .ops import db_device, resize_dev, warp_dev
from .ops import warp as warp_ops
from .ops.kernels import build, ctc_head, seg_reduce2
from .utils.png import read_bgr


@torch.inference_mode()
def _stages(ocr, img, acc):
    """One page through the step's stages, timed one by one."""
    oc = ocr._onecall
    det = ocr.text_detector
    pp = det.postprocess_op

    def t(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        acc[name] = acc.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

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
    t("db_moment_sums", lambda: seg_reduce2.label_moment_sums(
        lab, grid, ids, sy, sx))
    quads, scores, valid = t("db_device_boxes_total", lambda:
                             db_device.device_boxes(
        prob, rh, rw, max_k=oc.k_det, thresh=pp.thresh,
        box_thresh=pp.box_thresh, unclip_ratio=pp.unclip_ratio,
        min_size=float(pp.min_size), scale=oc.extract_scale,
        score_k=oc.score_k))
    q = quads[valid][:oc.k_rec]
    qs = warp_dev.order_points_clockwise(q)
    vmask = torch.ones(qs.shape[0], dtype=torch.bool, device=qs.device)
    mats, _, vw, _ = t("crop_matrices", lambda: warp_dev.crop_matrices(
        qs, vmask, oc.imgH, oc.rec_w))
    pad = oc.k_rec - qs.shape[0]
    mats = torch.cat([mats, torch.eye(3, device=mats.device).expand(
        pad, 3, 3)])
    vw = torch.cat([vw, vw.new_zeros(pad)])
    crops = t("rec_warp", lambda: warp_ops.warp_crops(
        image, mats, vw, oc.imgH, oc.rec_w))
    rec = ocr.text_recognizer.forward
    feats = t("rec_features", lambda: rec.model.features(
        crops.permute(0, 3, 1, 2), (vw + 7) // 8))
    head = rec.model.head
    t("ctc_head", lambda: ctc_head.ctc_head_reduce_batched(
        feats, head.w, head.b))
    t("step_total", lambda: oc.step(image, h, w, rh, rw, hb, wb, eh, ew))
    packed = oc.step(image, h, w, rh, rw, hb, wb, eh, ew)
    t("download_decode", lambda: oc.decode_packed(packed.cpu().numpy(),
                                                  image))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pages", type=int, default=8)
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
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
        dict_path = os.path.join(tmp, "ppocrv5_dict.txt")
        with open(dict_path, "w") as f:
            f.write("".join(f"<{i}>\n" for i in range(18383)))
        ocr = ONNXPaddleOcr(device="cuda", use_angle_cls=False,
                            rec_char_dict_path=dict_path)
        for img in pages[:2]:
            ocr.ocr(img, cls=False)
        stages: dict = {}
        for img in pages:
            _stages(ocr, img, stages)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for img in pages:
                ocr.ocr(img, cls=False)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "onecall_trace.json"))
    cuda = torch.autograd.DeviceType.CUDA
    kern = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == cuda]
    kern.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kern)
    n = len(pages)
    report = {
        "card": smi, "pages": n,
        "page_ms": wall_ms / n,
        # None: the profiler recorded no device time (not measured)
        "device_busy_ms_per_page": busy_ms / n if busy_ms else None,
        "device_busy_share": busy_ms / wall_ms if busy_ms else None,
        "stage_ms_per_page": {k: v / n for k, v in stages.items()},
        "top_kernels_ms_per_page": [
            [k, ms / n, c // n] for k, ms, c in kern[:12]],
    }
    for k, v in report["stage_ms_per_page"].items():
        print(f"{k:24s} {v:8.3f} ms")
    print(json.dumps(report))


if __name__ == "__main__":
    main()

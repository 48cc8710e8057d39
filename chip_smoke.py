"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. requires CUDA and prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels from onnxocr_tpu_torch/csrc into
   build/kernels/ (one nvcc per source, started together);
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes — the CTC head at 48 crops × 80 steps over the v5
   head (192 × 18385), the label reductions on a real page's det map on the
   1×2 working grid with K = 1024 — and times kernel, plain version and,
   for the CTC head, the library yardstick (addmm + max + logsumexp);
4. with TF32 off, runs ONNXPaddleOcr(device="cuda") — the committed v5
   checkpoints at the 960² det canvas — on committed held-out pages, checks
   that every kernel launched on that path, and compares one page with the
   same port on the CPU;
5. prints {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

Any failure raises and exits non-zero without the "ok" line. The
recognition dictionary is not in the repository: a stand-in with 18383
unique placeholder entries (blank + 18383 + space = the head's 18385
classes) is written to a temporary directory, so texts are placeholder
strings, identical between runs that decode the same indices.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

PAGES = ("synth_00_doc", "synth_03_doc", "synth_07_table", "synth_08_table",
         "synth_12_scan", "synth_16_photo", "synth_20_lowcontrast",
         "synth_22_dense")
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, float32 and
# float64 (non-tensor-core) FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12


def timed(fn, iters=20, warmup=3):
    """Mean ms per call on the card (CUDA events, warm L2)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_ctc_head(ocr, seed):
    import torch
    from onnxocr_tpu_torch.ops.kernels import ctc_head
    head = ocr.text_recognizer.forward.model.head
    w, b = head.w.contiguous(), head.b.contiguous()
    oc = ocr._onecall
    T = oc.rec_w // 8
    M, D, V = oc.k_rec * T, w.shape[0], w.shape[1]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((M, D), generator=g, device="cuda")
    idx, prob = ctc_head.ctc_head_reduce(x, w, b)
    pidx, pprob = ctc_head.ctc_head_reduce_plain(x, w, b)
    top2 = torch.topk(torch.addmm(b, x, w), 2, dim=1).values
    tie = (top2[:, 0] - top2[:, 1]).abs() <= 1e-5 * top2[:, 0].abs()
    bad = int(((idx != pidx) & ~tie).sum())
    assert bad == 0, f"ctc_head_reduce: {bad} argmax mismatches"
    torch.testing.assert_close(prob, pprob, rtol=1e-5, atol=0)

    def library():
        logits = torch.addmm(b, x, w)
        return logits.max(dim=1), torch.logsumexp(logits, dim=1)

    t, by = bound(4 * (M * D + D * V + V) + 8 * M, 2.0 * M * D * V,
                  F32_FLOPS)
    return {"name": "ctc_head_reduce", "route": "cuda",
            "source": "onnxocr_tpu_torch/csrc/ctc_head.cu",
            "replaces": "onnxocr_tpu/ops/pallas/ctc_head.py:67",
            "shape": [M, D, V], "tie_rows": int(tie.sum()),
            "max_abs_err": float((prob - pprob).abs().max()),
            "ms": timed(lambda: ctc_head.ctc_head_reduce(x, w, b)),
            "plain_ms": timed(lambda: ctc_head.ctc_head_reduce_plain(x, w, b)),
            "library_ms": timed(library), "bound_ms": t, "bound_by": by}


def page_grid(ocr, img):
    """A real page's det map on the working grid, labelled: the inputs the
    label reductions get on the main path."""
    import torch
    from onnxocr_tpu_torch.ops import db_device, resize_dev
    oc = ocr._onecall
    det = ocr.text_detector
    image, h, w = resize_dev.put_src_bucket(img, ocr.device)
    (rh, rw), (hb, wb), (eh, ew) = oc.canvas(h, w)
    with torch.inference_mode():
        x = resize_dev.resize_normalize_det(image, h, w, rh, rw, hb, wb)
        prob = det.model(x.permute(2, 0, 1)[None], valid_hw=(rh, rw))[0]
    prob = prob[:eh or hb, :ew or wb].contiguous()
    sy, sx = oc.extract_scale
    mask_grid, _, gh, gw = db_device.working_grid(prob, rh, rw, sy, sx)
    lab, ids, _ = db_device.label_components(
        mask_grid, gh, gw, oc.k_det, det.postprocess_op.thresh)
    return lab, mask_grid, ids, sy, sx


def check_seg_reduce2(ocr, img):
    import torch
    from onnxocr_tpu_torch.ops import db_device
    from onnxocr_tpu_torch.ops.kernels import seg_reduce2 as sr
    lab, prob, ids, sy, sx = page_grid(ocr, img)
    K, n = ids.shape[0], lab.numel()
    present = ids < db_device.MAXINT
    hits = int(torch.isin(lab, ids[present]).sum())
    assert int(present.sum()) > 0, "the page labelled no component"
    sums = sr.label_moment_sums(lab, prob, ids, sy, sx)
    psums = sr.label_moment_sums_plain(lab, prob, ids, sy, sx)
    torch.testing.assert_close(sums, psums, rtol=1e-5, atol=0)
    axes = db_device.pca_axes(psums)
    ext = sr.label_proj_extents(lab, axes, ids, sy, sx)
    pext = sr.label_proj_extents_plain(lab, axes, ids, sy, sx)
    torch.testing.assert_close(ext, pext, rtol=0, atol=1e-4)
    common = {"route": "cuda", "source": "onnxocr_tpu_torch/csrc/seg_reduce2.cu",
              "grid": list(lab.shape), "K": K,
              "components": int(present.sum()), "labelled_cells": hits,
              "library_ms": None}
    t1, b1 = bound(8 * n + 4 * K + 28 * K, 12.0 * hits, F64_FLOPS)
    t2, b2 = bound(4 * n + 4 * K + 8 * K + 16 * K, 6.0 * hits, F32_FLOPS)
    return [
        dict(common, name="label_moment_sums",
             replaces="onnxocr_tpu/ops/pallas/seg_reduce2.py:74",
             max_abs_err=float((sums - psums).abs().max()),
             ms=timed(lambda: sr.label_moment_sums(lab, prob, ids, sy, sx)),
             plain_ms=timed(lambda: sr.label_moment_sums_plain(
                 lab, prob, ids, sy, sx)), bound_ms=t1, bound_by=b1),
        dict(common, name="label_proj_extents",
             replaces="onnxocr_tpu/ops/pallas/seg_reduce2.py:190",
             max_abs_err=float((ext - pext)[present].abs().max()),
             ms=timed(lambda: sr.label_proj_extents(lab, axes, ids, sy, sx)),
             plain_ms=timed(lambda: sr.label_proj_extents_plain(
                 lab, axes, ids, sy, sx)), bound_ms=t2, bound_by=b2)]


def same_result(got, ref):
    assert len(got) == len(ref), (len(got), len(ref))
    assert [l[1][0] for l in got] == [l[1][0] for l in ref]
    for g, r in zip(got, ref):
        assert np.abs(np.asarray(g[0]) - np.asarray(r[0])).max() <= 2.0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    from onnxocr_tpu_torch import ONNXPaddleOcr, config
    from onnxocr_tpu_torch.ops.kernels import build
    from onnxocr_tpu_torch.utils.png import read_bgr

    print(f"kernels built in {build.build_all():.1f} s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "Used" in line:
                print(f"  {name}: {line.split(':', 1)[1].strip()}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for convolutions and matmuls (float32 parity)")

    heldout = config.ASSETS.parent / "test_images_heldout"
    pages = {p: read_bgr(str(heldout / f"{p}.png")) for p in PAGES}
    with tempfile.TemporaryDirectory() as tmp:
        dict_path = os.path.join(tmp, "ppocrv5_dict.txt")
        with open(dict_path, "w") as f:
            f.write("".join(f"<{i}>\n" for i in range(18383)))
        ocr = ONNXPaddleOcr(device="cuda", use_angle_cls=False,
                            rec_char_dict_path=dict_path)

        kernels = [check_ctc_head(ocr, seed=0)]
        kernels += check_seg_reduce2(ocr, pages[PAGES[0]])
        print("kernels agree with their plain versions on the card")

        ocr.ocr(pages[PAGES[0]], cls=False)          # warm-up page
        torch.cuda.synchronize()
        build.LAUNCHES.clear()
        results, total = {}, 0.0
        for name, img in pages.items():
            t0 = time.perf_counter()
            res = ocr.ocr(img, cls=False)[0]
            ms = (time.perf_counter() - t0) * 1e3
            total += ms
            results[name] = res
            boxes = np.asarray([l[0] for l in res], np.float64)
            scores = np.asarray([l[1][1] for l in res], np.float64)
            assert np.isfinite(boxes).all() and np.isfinite(scores).all()
            print(f"page {name}: {ms:.1f} ms, {len(res)} boxes, "
                  f"{sum(bool(l[1][0]) for l in res)} lines")
        launches = dict(build.LAUNCHES)
        print(f"{len(pages)} pages in {total:.1f} ms "
              f"({total / len(pages):.1f} ms/page); launches {launches}")
        for k in kernels:
            k["kernel_ms"] = k["ms"]
            k["launches"] = launches.get(k["name"], 0)
            assert k["launches"] > 0, f"{k['name']} never launched"
        assert sum(len(r) for r in results.values()) > 0

        cpu = ONNXPaddleOcr(device="cpu", use_angle_cls=False,
                            rec_char_dict_path=dict_path)
        same_result(results[PAGES[0]],
                    cpu.ocr(pages[PAGES[0]], cls=False)[0])
        print(f"page {PAGES[0]}: GPU and CPU runs agree "
              f"({len(results[PAGES[0]])} boxes)")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

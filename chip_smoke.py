"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. requires CUDA and prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels from onnxocr_tpu_torch/csrc into
   build/kernels/ (one nvcc per source, started together);
3. holds each of the five kernels against its plain PyTorch version on the
   card at the shapes every path gives it — the CTC head (three TF32
   tensor-core passes over split operands) against the float32 plain
   version over the v5 head (192 × 18385) at 48 crops × 80 steps
   (one-call) and at 16 and 64 crops × 80 steps (the staged path's batch
   ladder), and on rows built so that their top two logits differ by 1e-4
   relative; the label-keyed and the slot-keyed reductions on a real
   page's det map on the 1×2 working grid with K = 1024, on the one-call
   path's 960² canvas and, for the slot-keyed pair, on the staged path's
   own canvas as well, the moment sums also on three made-up label
   patterns — and times kernel (CUDA events around a loop of calls, and
   the same calls captured into a CUDA graph and replayed, which leaves
   the host out), plain version and, where one PyTorch call computes the
   same function, that call (addmm + max + logsumexp, index_add_,
   scatter_reduce_ amin);
4. with TF32 off and the committed v5 checkpoints, drives four paths on
   committed held-out pages. Each first runs its pages once unmeasured (so
   every (width, batch) shape has been used), then sets the launch counts
   to 0, runs the pages again, reads the counts and checks that its
   kernels launched:
   B  the one-call path (960² det canvas, label-keyed reductions,
      classifier off);
   A  the staged device-det path (per-page det canvas, slot-keyed
      reductions, untrained angle classifier on, fused cls + rec);
   A2 path A with `tpu_fused_cls_rec=False`: the classifier's and the
      recognizer's own `run_boxes`, which must give path A's results;
   B' the one-call path with the slot-keyed reductions and the classifier;
   one page of each is compared with the same port on the CPU, and the
   classifier's probabilities on seeded crops are compared card vs CPU;
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
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense TF32
# tensor-core FLOP/s, float32 and float64 (non-tensor-core) FLOP/s
HBM_BPS = 3.35e12
TF32_FLOPS = 495e12
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


def graph_timed(fn, iters=20, replays=5):
    """Mean ms per call on the card with the host out of the way: `iters`
    calls captured into one CUDA graph (the wrappers' allocations and
    memsets are captured with the launches), the graph replayed."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def both_timed(fn):
    return {"ms": timed(fn), "graph_ms": graph_timed(fn)}


def bound(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def float64_head(x, w, b, chunk=512):
    """The head in float64 on x's device, `chunk` rows at a time → ((M,)
    int32 argmax, (M,) float64 max-prob, (M, 2) float64 top-2 logits)."""
    import torch
    w64, b64 = w.double(), b.double()
    idx, prob, top2 = [], [], []
    for r in range(0, x.shape[0], chunk):
        logits = x[r:r + chunk].double() @ w64 + b64
        top = torch.topk(logits, 2, dim=1)
        idx.append(top.indices[:, 0].to(torch.int32))
        prob.append(1.0 / torch.exp(logits - top.values[:, :1]).sum(1))
        top2.append(top.values)
    return torch.cat(idx), torch.cat(prob), torch.cat(top2)


def max_rel(got, ref):
    return float(((got.double() - ref.double()).abs() / ref.double()).max())


def near_tie_rows(w, b, rows, seed, gap=1e-4):
    """(≤ rows, D) float32 inputs on w's device whose two largest logits
    over (w, b) differ by `gap` relative, the winner being the earlier
    column in one half of the rows and the later one in the other. Built in
    float64: x0 along w1 + w2 lifts columns c1 < c2 over the rest, a step
    along w1 − w2 sets their difference; rows where the float32 rounding of
    x left the gap outside [gap / 2, 2 gap], or another column on top, are
    dropped."""
    import torch
    dev = w.device
    g = torch.Generator(device=dev).manual_seed(seed)
    w64, b64 = w.double(), b.double()
    cols = torch.nonzero(b > -1e29)[:, 0]
    pick = cols[torch.randint(len(cols), (rows, 2), generator=g, device=dev)]
    pick = pick[pick[:, 0] != pick[:, 1]].sort(dim=1).values
    w1, w2 = w64[:, pick[:, 0]].t(), w64[:, pick[:, 1]].t()
    x0 = 40.0 * (w1 + w2) / (w1 + w2).square().sum(1, keepdim=True)
    l1 = (x0 * w1).sum(1) + b64[pick[:, 0]]
    l2 = (x0 * w2).sum(1) + b64[pick[:, 1]]
    sign = torch.where(torch.arange(len(pick), device=dev) % 2 == 0,
                       1.0, -1.0).double()
    step = sign * gap * l1.abs() - (l1 - l2)
    d = w1 - w2
    x = (x0 + step[:, None] * d / d.square().sum(1, keepdim=True)).float()
    top = torch.topk(x.double() @ w64 + b64, 2, dim=1)
    rel = (top.values[:, 0] - top.values[:, 1]) / top.values[:, 0].abs()
    ours = (top.indices.sort(dim=1).values == pick).all(dim=1)
    keep = ours & (rel >= gap / 2) & (rel <= 2 * gap)
    return x[keep].contiguous()


def check_ctc_head(ocr, seed, crops=None):
    """Kernel 1 at M = crops × T rows (crops: the one-call K_rec when not
    given) against the float32 plain version: argmax equal outside rows
    whose top-2 logits tie to 1e-5 relative, max-prob within rtol 1e-5.
    Both are also measured against the head in float64."""
    import torch
    from onnxocr_tpu_torch.ops.kernels import ctc_head
    head = ocr.text_recognizer.forward.model.head
    w, b, w_split = head.w.contiguous(), head.b.contiguous(), head.w_split
    assert w_split.shape == (2, w.shape[1], w.shape[0])
    assert w_split.is_contiguous() and w_split.device == w.device
    oc = ocr._onecall
    T = oc.rec_w // 8
    M, D, V = (crops or oc.k_rec) * T, w.shape[0], w.shape[1]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((M, D), generator=g, device="cuda")
    idx, prob = ctc_head.ctc_head_reduce(x, w_split, b)
    torch.cuda.synchronize()
    pidx, pprob = ctc_head.ctc_head_reduce_plain(x, w, b)
    _, prob64, top2 = float64_head(x, w, b)
    tie = (top2[:, 0] - top2[:, 1]).abs() <= 1e-5 * top2[:, 0].abs()
    bad = int(((idx != pidx) & ~tie).sum())
    rel = max_rel(prob, pprob)
    rel64, plain_rel64 = max_rel(prob, prob64), max_rel(pprob, prob64)
    print(f"ctc_head_reduce M={M}: {bad} argmax mismatches outside "
          f"{int(tie.sum())} tie rows, max-prob max rel err {rel:.2e} "
          f"(against float64: kernel {rel64:.2e}, plain {plain_rel64:.2e})")
    assert bad == 0, f"ctc_head_reduce: {bad} argmax mismatches"
    torch.testing.assert_close(prob, pprob, rtol=1e-5, atol=0)

    def library():
        logits = torch.addmm(b, x, w)
        return logits.max(dim=1), torch.logsumexp(logits, dim=1)

    # the kernel's own work: three TF32 passes over the product, against
    # x, both halves of the split weight and the bias in, two (M,) out
    flops = 3 * 2.0 * M * D * V
    t, by = bound(4 * (M * D + 2 * D * V + V) + 8 * M, flops, TF32_FLOPS)
    return dict(
        both_timed(lambda: ctc_head.ctc_head_reduce(x, w_split, b)),
        name="ctc_head_reduce", route="cuda",
        source="onnxocr_tpu_torch/csrc/ctc_head.cu",
        replaces="onnxocr_tpu/ops/pallas/ctc_head.py:67",
        shape=[M, D, V], tie_rows=int(tie.sum()), argmax_mismatches=bad,
        max_abs_err=float((prob - pprob).abs().max()), max_rel_err=rel,
        max_rel_err_float64=rel64, plain_max_rel_err_float64=plain_rel64,
        plain_ms=timed(lambda: ctc_head.ctc_head_reduce_plain(x, w, b)),
        library_ms=timed(library), bound_ms=t, bound_by=by,
        bound_peak="tf32 tensor cores, 3 passes",
        float32_pipe_bound_ms=2.0 * M * D * V / F32_FLOPS * 1e3)


def check_ctc_head_near_ties(ocr, seed):
    """Kernel 1 on rows whose top two logits differ by 1e-4 relative: the
    argmax must be the float32 plain version's, which must be the float64
    one's. These rows' logits are several times a page's in size, and so
    is the float32 plain version's own error: the max-prob is held to the
    float64 head here (rtol 1e-5), the plain version's distance from it
    printed beside the kernel's."""
    import torch
    from onnxocr_tpu_torch.ops.kernels import ctc_head
    head = ocr.text_recognizer.forward.model.head
    w, b = head.w.contiguous(), head.b.contiguous()
    x = near_tie_rows(w, b, rows=256, seed=seed)
    assert x.shape[0] >= 64, f"only {x.shape[0]} near-tie rows were built"
    idx, prob = ctc_head.ctc_head_reduce(x, head.w_split, b)
    pidx, pprob = ctc_head.ctc_head_reduce_plain(x, w, b)
    idx64, prob64, _ = float64_head(x, w, b)
    assert torch.equal(pidx, idx64), "float32 plain version off on near ties"
    bad = int((idx != pidx).sum())
    assert bad == 0, f"ctc_head_reduce: {bad} argmax mismatches on near ties"
    rel64, plain_rel64 = max_rel(prob, prob64), max_rel(pprob, prob64)
    assert rel64 <= 1e-5, f"ctc_head_reduce: max-prob off by {rel64:.2e}"
    later = int((idx.long() == torch.topk(x @ w + b, 2, dim=1).indices
                 .max(1).values).sum())
    print(f"ctc_head_reduce on {x.shape[0]} rows with top-2 logits 1e-4 "
          f"apart: argmax equal ({later} won by the later column); max-prob "
          f"max rel err against float64: kernel {rel64:.2e}, plain "
          f"{plain_rel64:.2e}")
    return {"rows": int(x.shape[0]), "argmax_mismatches": bad,
            "won_by_later_column": later,
            "max_rel_err": max_rel(prob, pprob),
            "max_rel_err_float64": rel64,
            "plain_max_rel_err_float64": plain_rel64}


def page_grid(ocr, img):
    """A real page's det map on the working grid, labelled: the inputs the
    label reductions get on `ocr`'s path (the one-call canvas and extraction
    window, or the staged path's own canvas per page)."""
    import torch
    from onnxocr_tpu_torch.ops import db_device, det_pre, resize_dev
    oc = ocr._onecall
    det = ocr.text_detector
    image, h, w = resize_dev.put_src_bucket(img, ocr.device)
    if oc is None:
        rh, rw = det_pre.det_resize_target(h, w, det.limit_side_len)
        hb, wb = (det_pre.round_up(v, det.bucket) for v in (rh, rw))
        eh = ew = 0
        k_det = int(ocr.args.tpu_det_max_boxes)
        sy, sx = db_device.parse_extract_scale(
            ocr.args.tpu_det_extract_scale)
    else:
        (rh, rw), (hb, wb), (eh, ew) = oc.canvas(h, w)
        k_det = oc.k_det
        sy, sx = oc.extract_scale
    with torch.inference_mode():
        x = resize_dev.resize_normalize_det(image, h, w, rh, rw, hb, wb)
        prob = det.model(x.permute(2, 0, 1)[None], valid_hw=(rh, rw))[0]
    prob = prob[:eh or hb, :ew or wb].contiguous()
    mask_grid, _, gh, gw = db_device.working_grid(prob, rh, rw, sy, sx)
    lab, ids, _ = db_device.label_components(
        mask_grid.contiguous(), gh, gw, k_det, det.postprocess_op.thresh)
    return lab, mask_grid.contiguous(), ids, sy, sx


def moment_sum_label_runs(prob, K, sy, sx):
    """Kernel 2 on made-up label patterns over the page's grid: what a long
    run of one label costs. `background`: no cell labelled (the floor of a
    one-launch design: read the labels, find nothing); `one_label`: every
    cell in one component (each warp reduces with shuffles, then one shared
    atomic per channel); `alternating`: neighbouring cells in two components
    (every warp holds two groups of lanes)."""
    import torch
    from onnxocr_tpu_torch.ops import db_device
    from onnxocr_tpu_torch.ops.kernels import seg_reduce2 as sr
    i = torch.arange(prob.numel(), device=prob.device, dtype=torch.int32)
    ids = torch.full((K,), db_device.MAXINT, dtype=torch.int32,
                     device=prob.device)
    ids[:2] = torch.tensor([1, 2], dtype=torch.int32)
    out = {}
    for name, lab in (("background", torch.zeros_like(i)),
                      ("one_label", torch.ones_like(i)),
                      ("alternating", 1 + i % 2)):
        lab = lab.reshape(prob.shape).contiguous()
        torch.testing.assert_close(
            sr.label_moment_sums(lab, prob, ids, sy, sx),
            sr.label_moment_sums_plain(lab, prob, ids, sy, sx),
            rtol=1e-5, atol=0)
        out[name] = both_timed(
            lambda: sr.label_moment_sums(lab, prob, ids, sy, sx))
    return out


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
    # bytes this run's data needs: every label, the map's value at the
    # labelled cells only, the ids in and K rows out
    t1, b1 = bound(4 * n + 4 * hits + 4 * K + 28 * K, 12.0 * hits, F64_FLOPS)
    t2, b2 = bound(4 * n + 4 * K + 8 * K + 16 * K, 6.0 * hits, F32_FLOPS)
    return [
        dict(common, name="label_moment_sums",
             replaces="onnxocr_tpu/ops/pallas/seg_reduce2.py:74",
             max_abs_err=float((sums - psums).abs().max()),
             **both_timed(lambda: sr.label_moment_sums(lab, prob, ids, sy,
                                                       sx)),
             plain_ms=timed(lambda: sr.label_moment_sums_plain(
                 lab, prob, ids, sy, sx)), bound_ms=t1, bound_by=b1,
             label_runs=moment_sum_label_runs(prob, K, sy, sx)),
        dict(common, name="label_proj_extents",
             replaces="onnxocr_tpu/ops/pallas/seg_reduce2.py:190",
             max_abs_err=float((ext - pext)[present].abs().max()),
             **both_timed(lambda: sr.label_proj_extents(lab, axes, ids, sy,
                                                        sx)),
             plain_ms=timed(lambda: sr.label_proj_extents_plain(
                 lab, axes, ids, sy, sx)), bound_ms=t2, bound_by=b2)]


def check_seg_reduce(ocr, img):
    """Kernels 4 and 5 on the slot / stats / projection columns that
    db_device builds from a real page's labelled grid."""
    import torch
    from onnxocr_tpu_torch.ops import db_device
    from onnxocr_tpu_torch.ops.kernels import seg_reduce as sr
    lab, prob, ids, sy, sx = page_grid(ocr, img)
    K, n = ids.shape[0], lab.numel()
    slot, hit = db_device.label_slots(lab, K)
    fx, fy = db_device.cell_coords(*lab.shape, sy, sx, lab.device)
    stats = db_device.moment_stats(prob, hit, fx, fy).contiguous()
    hits = int(hit.sum())
    assert hits > 0, "the page labelled no component"
    sums = sr.seg_sum_bands(slot, stats, K)
    psums = sr.seg_sum_bands_plain(slot, stats, K)
    torch.testing.assert_close(sums, psums, rtol=1e-5, atol=0)
    cols = db_device.proj_columns(slot, hit, db_device.pca_axes(psums),
                                  fx, fy).contiguous()
    ext = sr.seg_min_bands(slot, cols, K, db_device.BIG)
    pext = sr.seg_min_bands_plain(slot, cols, K, db_device.BIG)
    torch.testing.assert_close(ext, pext, rtol=0, atol=1e-4)
    # a caller's own sentinel comes back for empty slots
    torch.testing.assert_close(sr.seg_min_bands(slot, cols, K, 1e30),
                               sr.seg_min_bands_plain(slot, cols, K, 1e30),
                               rtol=0, atol=1e-4)
    torch.cuda.synchronize()

    # the library yardsticks: one call each into a (K + 1, C) buffer whose
    # last row takes the no-op cells (index made int64 outside the timing)
    rows = slot.to(torch.int64)
    rows4 = rows[:, None].expand(-1, 4)

    def lib_sum():
        return torch.zeros((K + 1, 7), device=slot.device).index_add_(
            0, rows, stats)

    def lib_min():
        return torch.full((K + 1, 4), db_device.BIG, device=slot.device
                          ).scatter_reduce_(0, rows4, cols, "amin")

    torch.testing.assert_close(lib_sum()[:K], psums, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(lib_min()[:K], pext, rtol=0, atol=1e-4)
    present = ids < db_device.MAXINT
    common = {"route": "cuda", "source": "onnxocr_tpu_torch/csrc/seg_reduce.cu",
              "grid": list(lab.shape), "K": K,
              "components": int(present.sum()), "labelled_cells": hits}
    # bytes this run's data needs: every slot, the C values of the cells
    # whose slot is < K only (a no-op cell's values need not be read), and
    # K rows out; counted by element, not by 32-byte sector
    t4, b4 = bound(4 * n + 28 * hits + 28 * K, 7.0 * hits, F64_FLOPS)
    t5, b5 = bound(4 * n + 16 * hits + 16 * K, 4.0 * hits, F32_FLOPS)
    return [
        dict(common, name="seg_sum_bands",
             replaces="onnxocr_tpu/ops/pallas/seg_reduce.py:118",
             max_abs_err=float((sums - psums).abs().max()),
             **both_timed(lambda: sr.seg_sum_bands(slot, stats, K)),
             plain_ms=timed(lambda: sr.seg_sum_bands_plain(slot, stats, K)),
             library_ms=timed(lib_sum), bound_ms=t4, bound_by=b4),
        dict(common, name="seg_min_bands",
             replaces="onnxocr_tpu/ops/pallas/seg_reduce.py:127",
             max_abs_err=float((ext - pext).abs().max()),
             **both_timed(lambda: sr.seg_min_bands(slot, cols, K)),
             plain_ms=timed(lambda: sr.seg_min_bands_plain(slot, cols, K)),
             library_ms=timed(lib_min), bound_ms=t5, bound_by=b5)]


def check_classifier(gpu, cpu, seed):
    """The angle classifier on the card vs on the CPU, on seeded crops."""
    import torch
    rng = np.random.default_rng(seed)
    crops = torch.from_numpy(rng.uniform(-1, 1, size=(16, 48, 192, 3))
                             .astype(np.float32))
    got = gpu.text_classifier.forward(crops.cuda()).cpu()
    want = cpu.text_classifier.forward(crops)
    assert got.shape == (16, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    return float((got - want).abs().max())


def drive(ocr, pages, names, cls, label):
    """Run `names` through ocr() once unmeasured, so that every (width,
    batch) shape the pages reach has been used; then set the launch counts
    to 0 and run them again → (results by page name, launch counts of the
    second pass)."""
    import torch
    from onnxocr_tpu_torch.ops.kernels import build
    first = []
    for name in names:
        t0 = time.perf_counter()
        ocr.ocr(pages[name], cls=cls)
        first.append((time.perf_counter() - t0) * 1e3)
    print(f"path {label} first pass (first use of each shape), ms/page: "
          + " ".join(f"{t:.1f}" for t in first))
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    results, times = {}, []
    for name in names:
        t0 = time.perf_counter()
        res = ocr.ocr(pages[name], cls=cls)[0]
        ms = (time.perf_counter() - t0) * 1e3
        times.append(ms)
        results[name] = res
        boxes = np.asarray([l[0] for l in res], np.float64)
        scores = np.asarray([l[1][1] for l in res], np.float64)
        assert np.isfinite(boxes).all() and np.isfinite(scores).all()
        print(f"path {label} page {name}: {ms:.1f} ms, {len(res)} boxes, "
              f"{sum(bool(l[1][0]) for l in res)} lines")
    launches = dict(build.LAUNCHES)
    print(f"path {label}: {len(names)} pages in {sum(times):.1f} ms "
          f"(mean {np.mean(times):.1f}, median {np.median(times):.1f} "
          f"ms/page); launches {launches}")
    assert sum(len(r) for r in results.values()) > 0
    return results, launches


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
        def model(device, **kw):
            return ONNXPaddleOcr(device=device, rec_char_dict_path=dict_path,
                                 **kw)

        # B: one-call, label-keyed reductions, classifier off
        kw_b = dict(use_angle_cls=False)
        # A: staged device-det, slot-keyed reductions, classifier on
        kw_a = dict(tpu_pipeline="staged", tpu_det_postprocess="device",
                    tpu_db_reduce="pallas", use_angle_cls=True,
                    tpu_allow_untrained=True)
        # A2: the same with the classifier and the recognizer as two steps
        kw_a2 = dict(kw_a, tpu_fused_cls_rec=False)
        # B': one-call, slot-keyed reductions, classifier on
        kw_b2 = dict(tpu_db_reduce="pallas", use_angle_cls=True,
                     tpu_allow_untrained=True)
        ocr = model("cuda", **kw_b)
        ocr_a = model("cuda", **kw_a)
        ocr_a2 = model("cuda", **kw_a2)
        ocr_b2 = model("cuda", **kw_b2)

        # each entry: a kernel at the shapes of the path named in "path";
        # the same kernel at another path's shapes goes under "other_shapes"
        page = pages[PAGES[0]]
        kernels = [dict(check_ctc_head(ocr, seed=0), path="B",
                        near_ties=check_ctc_head_near_ties(ocr, seed=1))]
        kernels += [dict(k, path="B") for k in check_seg_reduce2(ocr, page)]
        kernels += [dict(k, path="B'") for k in check_seg_reduce(ocr_b2, page)]
        staged_ctc = [check_ctc_head(ocr, seed=2 + i, crops=c)
                      for i, c in enumerate(ocr_a.text_recognizer.batch_ladder
                                            [-2:])]
        others = {"ctc_head_reduce": staged_ctc}
        for k in check_seg_reduce(ocr_a, page):
            others[k["name"]] = [k]
        for k in kernels:
            k["other_shapes"] = [
                dict({key: o[key] for key in (
                    "max_abs_err", "ms", "graph_ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by")},
                     path="A", shape=o.get("shape") or o["grid"],
                     labelled_cells=o.get("labelled_cells"))
                for o in others.get(k["name"], ())]
            for o in k["other_shapes"]:
                print(f"{k['name']} at path A's shape {o['shape']}: max abs "
                      f"err {o['max_abs_err']:.2e}, {o['ms']:.4f} ms, "
                      f"{o['graph_ms']:.4f} in a graph (plain "
                      f"{o['plain_ms']:.4f}, library {o['library_ms']:.4f}, "
                      f"bound {o['bound_ms']:.6f} by {o['bound_by']})")
        print("kernels agree with their plain versions on the card")

        slot_keyed = ("ctc_head_reduce", "seg_sum_bands", "seg_min_bands")
        runs, found = {}, {}
        for label, gpu, kw, names, cls, needs in (
                ("B", ocr, kw_b, PAGES[:4], False,
                 ("ctc_head_reduce", "label_moment_sums",
                  "label_proj_extents")),
                ("A", ocr_a, kw_a, PAGES, True, slot_keyed),
                ("A2", ocr_a2, kw_a2, PAGES[:3], True, slot_keyed),
                ("B'", ocr_b2, kw_b2, PAGES[:3], True, slot_keyed)):
            results, launches = drive(gpu, pages, names, cls, label)
            for name in needs:
                assert launches.get(name, 0) > 0, \
                    f"path {label}: {name} never launched"
            runs[label], found[label] = launches, results
            cpu = model("cpu", **kw)
            same_result(results[PAGES[0]],
                        cpu.ocr(pages[PAGES[0]], cls=cls)[0])
            print(f"path {label} page {PAGES[0]}: GPU and CPU runs agree "
                  f"({len(results[PAGES[0]])} boxes)")
            if label == "A":
                err = check_classifier(gpu, cpu, seed=1)
                print(f"classifier on the card vs the CPU: max abs err "
                      f"{err:.2e} over 16 seeded crops")
        for name, res in found["A2"].items():
            same_result(res, found["A"][name])
        print(f"path A2 gives path A's results on {len(found['A2'])} pages")
        # launches: the count of the path whose shapes the entry holds
        for k in kernels:
            k["launches"] = runs[k["path"]].get(k["name"], 0)
            k["launches_by_path"] = {p: r.get(k["name"], 0)
                                     for p, r in runs.items()}
            assert k["launches"] > 0, f"{k['name']} never launched"
            for o in k["other_shapes"]:
                o["launches"] = runs[o["path"]].get(k["name"], 0)
                assert o["launches"] > 0

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

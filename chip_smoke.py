"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. requires CUDA and prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels from onnxocr_tpu_torch/csrc into
   build/kernels/ (one nvcc per source, started together) and, at the same
   time, the host C++ library of the DB postprocess into build/host/;
3. holds each of the five kernels against its plain PyTorch version on the
   card at the shapes every path gives it — the CTC head (three TF32
   tensor-core passes over split operands) against the float32 plain
   version over the v5 head (192 × 18385) at 48 crops × 80 steps
   (one-call) and at 16 and 64 crops × 80 steps (the staged paths' batch
   ladder), and on rows built so that their top two logits differ by 1e-4
   relative; the label-keyed and the slot-keyed reductions on a real
   page's det map on the 1×2 working grid with K = 1024, on the one-call
   path's 960² canvas and, for the slot-keyed pair, on the staged path's
   own canvas as well; all four reductions on the seeded grids of
   `ops/kernels/patterns.py` (every branch of the kernels: a slot span past
   the shared window, labels that are not kept, slots outside [0, K), a
   ragged cell count on misaligned storage, ...) and, at the page's size, on
   three made-up runs (all background: the floor of a one-launch design;
   one label or slot everywhere; two alternating cell by cell) — and times
   kernel (CUDA events around a loop of calls, and
   the same calls captured into a CUDA graph and replayed, which leaves
   the host out), plain version and, where one PyTorch call computes the
   same function, that call (addmm + max + logsumexp, index_add_,
   scatter_reduce_ amin);
4. runs every crop warp form (gather, upright, shear) × interpolation
   (bilinear, bicubic) on the crop matrices that one page of path B and of
   path A give their warps, on the card against the same port on the CPU,
   counts the shear-eligible crops on both and times each form;
5. with TF32 off and the committed v5 checkpoints, drives six paths on
   committed held-out pages, all at the default shear-staged warp. Each
   first runs its pages once unmeasured (so every (width, batch) shape has
   been used), then sets the launch counts to 0, runs the pages again,
   reads the counts and checks that its kernels launched (and, on path C,
   that the four reductions did not):
   C  `ONNXPaddleOcr()` at its defaults, the JAX package's default
      pipeline: the staged bitmap wire (DBNet → bitpacked DB bitmap → host
      contours, min-area quads and unclip in the C++ host library, built
      with g++ beside the kernels → fused rec pass per width bucket that
      also scores the candidates on the card); its DB bitmap of one page
      is held against the CPU's, every differing pixel a tie;
   C' the map route (`tpu_det_wire='map'`: the uint8 map downloaded, the
      host DB postprocess scores) with the untrained classifier on, and
      the bitmap wire's overflow branch on one page (batch ladder (4,):
      more than 16 candidates download the map and score on the host);
   B  the one-call path (960² det canvas, label-keyed reductions,
      classifier off);
   A  the staged device-det path (per-page det canvas, slot-keyed
      reductions, untrained angle classifier on, fused cls + rec);
   A2 path A with `tpu_fused_cls_rec=False`: the classifier's and the
      recognizer's own `run_boxes`, which must give path A's results;
   B' the one-call path with the slot-keyed reductions and the classifier;
   one page of each (C': each page) is compared with the same port on the
   CPU, and the classifier's probabilities on seeded crops are compared
   card vs CPU;
6. drives path Q, path C behind both cross-request batchers as the JAX
   package's serving engine runs it (`ONNXPaddleOcr(tpu_det_microbatch=
   True, tpu_rec_microbatch=True)` at the defaults): the canonical
   multi-page shapes warmed (`warm_canonical`), one unmeasured concurrent
   pass, each page serially, then 8 threads over 3 rounds of the pages
   with the launch counts set to 0 before and read after, and the same 8
   threads on path C's model without the batchers. Every concurrent
   result must equal the serial one, one page the CPU's; a det wave and a
   rec group of two pages or more must occur, and the CTC head must launch
   fewer times than without the batchers. Kernel 1 is also held and timed
   at the 960-wide coalesced group's M = 64 × 120;
7. drives path W, the one-call path with the wave coalescer
   (`tpu_pipeline='onecall', tpu_onecall_wave=True`): tiers 2 and 4
   warmed with `warm_sync`, waves of 2 and of 4 pages forced with `_hold`
   that must equal the single-page program's results at the gather warp
   (`tpu_warp_stage='off'`, the wave's own form), one 4-page wave step
   that must launch the CTC head once and kernels 2–3 once a page, its
   first two pages' buffers decoded as the CPU port's; W′, a held wave of
   2 with the slot-keyed reductions (kernels 4–5); then 8 threads over 3
   rounds of the pages, counted, against path B's single pages on the
   same threads; no tier's warm may fail. Kernel 1 is also held and timed
   at a 4-page wave's M = 4 × 48 × 80 = 15360;
8. drives path H, the host image operations (numpy twins of cv2's
   resize, perspective warp and rotate): `tpu_det_input='host'`,
   `tpu_crop_backend='host'` with the classifier, the det-only, rec-only
   and cls-only forms of `ocr()`, a tiny page (h + w < 64) at the
   defaults and through path Q's batchers, the det batcher's maps wire
   and boxes mode, each on one page against the same port on the CPU;
9. drives path F, the two other families of the JAX package's registry
   with their committed checkpoints on two held-out pages (`phase_f`):
   the ch_ppocr_server_v2.0 pair (ResNet18-vd DBNet, CRNN with two
   BiLSTMs, whose logits are reduced without the head kernel) on C, A, B
   and, behind both batchers from 4 threads, Q (per-page det canvases,
   CRNN chunks alone), and PP-OCRv4 on C and B; each checks its launches
   (kernel 1 on v4 and never on the CRNN, kernels 2–3 on B, 4–5 on A, no
   reduction on C) and holds one page against the CPU; it also times the
   BiLSTMs' share of a server C page, the ResNet DBNet at 960², the CRNN
   at widths 320 / 640 / 1280 (batch 16) and the CRNN's peak memory at
   64 × 1280;
10. drives path S, the port's HTTP service (`phase_s`): the app of
   `python -m onnxocr_tpu_torch.service` served in this process on a
   socket at 127.0.0.1, on the card, with the stand-in dictionary under
   an ONNXOCR_TPU_ASSETS root and the untrained classifier, in three
   engine modes — the default (the staged bitmap wire behind both
   batchers), PIPELINE_MODE=onecall, and onecall with WAVE_BATCH=1 (its
   tiers warmed through WARMUP_SRC_BUCKETS). Each waits for readyz 200
   (failing on the engine's warmup_error), sends a document and a table
   page, each four times, as v1 base64 PNG, v1 base64 JPEG and v2
   multipart from 8 clients (24 requests a round; one unmeasured
   round, then two counted rounds between launch-count reads), holds each
   response against the CPU port's ocr() of that page at the engine's
   kwargs, requires the CTC head (and under onecall kernels 2–3) to have
   launched during the served requests, times a serial pass of 40
   requests (p50, p95), and answers
   one return_image and one multi-file text / zip request; the codec's
   decode ms a page and the preview's encode ms are timed too;
11. prints {"warp": [...]}, {"batch": {...}} (pages/s with and without the
   batchers, serial ms a page, det wave sizes, rec groups with real and
   padded rows, CTC-head launches a page), {"wave": {...}, "host": {...}}
   (path W's pages/s against path B's, serial ms a page, wave sizes, warm
   ms, launches; the host twins' ms a page), {"families": {...}} (path F's
   ms a page, launches, the BiLSTM share and the models' times),
   {"serve": {...}} (path S's requests/s, serial p50 / p95 ms, seconds to
   readiness and CTC-head launches a request by mode, decode and preview
   ms), {"kernels": [...]} and, last, {"ok": true, "device": {...}}; the run's
   seconds on a line before them.

Any failure raises and exits non-zero without the "ok" line. The
recognition dictionaries are not in the repository: stand-ins with 18383
(v5, v4) and 6623 (server) unique placeholder entries (blank + entries +
space = the heads' 18385 and 6625 classes) are written to a temporary
directory, so texts are placeholder strings, identical between runs that
decode the same indices.
"""
import io
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


def check_ctc_head(ocr, seed, crops=None, rows=None):
    """Kernel 1 at M = crops × T rows (crops: the one-call K_rec when not
    given; `rows`: M itself) against the float32 plain version: argmax
    equal outside rows whose top-2 logits tie to 1e-5 relative, max-prob
    within rtol 1e-5. Both are also measured against the head in
    float64."""
    import torch
    from onnxocr_tpu_torch.ops.kernels import ctc_head
    head = ocr.text_recognizer.forward.model.head
    w, b, w_split = head.w.contiguous(), head.b.contiguous(), head.w_split
    assert w_split.shape == (2, w.shape[1], w.shape[0])
    assert w_split.is_contiguous() and w_split.device == w.device
    oc = ocr._onecall
    T = oc.rec_w // 8
    M, D, V = rows or (crops or oc.k_rec) * T, w.shape[0], w.shape[1]
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


def on_device(a, device, misaligned=False):
    """The numpy array as a contiguous tensor on `device`; `misaligned`: as
    a view that starts one element into its storage, so its address is no
    multiple of 16 bytes."""
    import torch
    t = torch.from_numpy(np.ascontiguousarray(a))
    if not misaligned:
        return t.to(device)
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def check_patterns(device="cuda"):
    """Every seeded grid of ops/kernels/patterns.py through the four
    reduction wrappers and their plain versions on `device` → {kernel:
    {case: max abs err}}. Sums rtol 1e-5 (float64 accumulation on both
    sides: one float32 rounding apart at most); extents and mins atol 1e-4
    (a min is exact in any order; the slack covers a projection rounded
    another way)."""
    import torch
    from onnxocr_tpu_torch.ops.kernels import patterns
    from onnxocr_tpu_torch.ops.kernels import seg_reduce as band
    from onnxocr_tpu_torch.ops.kernels import seg_reduce2 as lab2
    errs = {name: {} for name in ("label_moment_sums", "label_proj_extents",
                                  "seg_sum_bands", "seg_min_bands")}

    def hold(kernel, case, got, want, **tol):
        torch.testing.assert_close(got, want, **tol, msg=lambda m: (
            f"{kernel} on pattern {case}: {m}"))
        errs[kernel][case] = float((got - want).abs().max())

    for c in patterns.label_cases():
        lab, prob, ids, axes = (
            on_device(c[k], device, c["misaligned"] and k in ("lab", "prob"))
            for k in ("lab", "prob", "ids", "axes"))
        sy, sx = c["sy"], c["sx"]
        hold("label_moment_sums", c["name"],
             lab2.label_moment_sums(lab, prob, ids, sy, sx),
             lab2.label_moment_sums_plain(lab, prob, ids, sy, sx),
             rtol=1e-5, atol=0)
        hold("label_proj_extents", c["name"],
             lab2.label_proj_extents(lab, axes, ids, sy, sx),
             lab2.label_proj_extents_plain(lab, axes, ids, sy, sx),
             rtol=0, atol=1e-4)
    for c in patterns.slot_cases():
        slot, vals = (on_device(c[k], device, c["misaligned"])
                      for k in ("slot", "vals"))
        K = c["K"]
        hold("seg_sum_bands", c["name"], band.seg_sum_bands(slot, vals, K),
             band.seg_sum_bands_plain(slot, vals, K), rtol=1e-5, atol=0)
        hit = ((slot >= 0) & (slot < K))[:, None]
        masked = torch.where(hit, vals, band.BIG).contiguous()
        hold("seg_min_bands", c["name"], band.seg_min_bands(slot, masked, K),
             band.seg_min_bands_plain(slot, masked, K), rtol=0, atol=1e-4)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return errs


def device_counts(fn, calls=3):
    """What `calls` calls of `fn` put on the card, from torch.profiler →
    {"calls", "kernels", "memsets", "memcpys"} (the profiler now and then
    drops a memset's record)."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {"calls": calls, "kernels": 0, "memsets": 0, "memcpys": 0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = ("memsets" if e.key.startswith("Memset") else
                "memcpys" if e.key.startswith("Memcpy") else "kernels")
        out[kind] += e.count
    return out


def device_ops(fn, name, calls=3):
    """device_counts of the reduction `fn`. Raises unless a call is one
    kernel launch and no copy; the one memset before it (accumulator and
    ticket counter) is counted as the profiler records it."""
    out = device_counts(fn, calls)
    assert out["kernels"] == calls and out["memcpys"] == 0 and \
        out["memsets"] <= calls, f"{name}: {out}"
    return out


def run_grids(shape, K, device):
    """Made-up grids of `shape` cells → (ids (K,) int32 holding labels 1 and
    2, {run: lab of `shape`}, {run: slot (n,)}), all int32. `background`:
    no cell labelled, every slot the no-op K (the floor of a one-launch
    design: read the labels, find nothing); `one`: every cell in one
    component (each warp reduces first, then one shared atomic per
    channel); `alternating`: neighbouring cells in two components (every
    warp holds two groups of lanes)."""
    import torch
    from onnxocr_tpu_torch.ops import db_device
    n = int(np.prod(shape))
    i = torch.arange(n, device=device, dtype=torch.int32)
    ids = torch.full((K,), db_device.MAXINT, dtype=torch.int32,
                     device=device)
    ids[:2] = torch.tensor([1, 2], dtype=torch.int32)
    slots = {"background": torch.full_like(i, K), "one": torch.zeros_like(i),
             "alternating": i % 2}
    labs = {name: torch.where(s < K, s + 1, 0).reshape(shape).contiguous()
            for name, s in slots.items()}
    return ids, labs, slots


def label_runs(prob, K, sy, sx):
    """Kernels 2 and 3 on the label grids of run_grids over the page's grid
    → {kernel: {run: times}}. Each is first held against the plain
    version."""
    import torch
    from onnxocr_tpu_torch.ops.kernels import seg_reduce2 as sr
    dev = prob.device
    ids, labs, _ = run_grids(prob.shape, K, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    axes = torch.nn.functional.normalize(
        torch.randn((K, 2), generator=g, device=dev), dim=1).contiguous()
    out = {"label_moment_sums": {}, "label_proj_extents": {}}
    for name, lab in labs.items():
        torch.testing.assert_close(
            sr.label_moment_sums(lab, prob, ids, sy, sx),
            sr.label_moment_sums_plain(lab, prob, ids, sy, sx),
            rtol=1e-5, atol=0)
        torch.testing.assert_close(
            sr.label_proj_extents(lab, axes, ids, sy, sx),
            sr.label_proj_extents_plain(lab, axes, ids, sy, sx),
            rtol=0, atol=1e-4)
        out["label_moment_sums"][name] = both_timed(
            lambda: sr.label_moment_sums(lab, prob, ids, sy, sx))
        out["label_proj_extents"][name] = both_timed(
            lambda: sr.label_proj_extents(lab, axes, ids, sy, sx))
    return out


def slot_runs(n, K, device="cuda"):
    """Kernels 4 and 5 on the slot runs of run_grids at the page's size →
    {kernel: {run: times}}. Each is first held against the plain version."""
    import torch
    from onnxocr_tpu_torch.ops.kernels import seg_reduce as sr
    g = torch.Generator(device=device).manual_seed(0)
    stats = torch.rand((n, 7), generator=g, device=device)
    cols = torch.rand((n, 4), generator=g, device=device)
    out = {"seg_sum_bands": {}, "seg_min_bands": {}}
    for name, slot in run_grids((n,), K, device)[2].items():
        torch.testing.assert_close(sr.seg_sum_bands(slot, stats, K),
                                   sr.seg_sum_bands_plain(slot, stats, K),
                                   rtol=1e-5, atol=0)
        torch.testing.assert_close(sr.seg_min_bands(slot, cols, K),
                                   sr.seg_min_bands_plain(slot, cols, K),
                                   rtol=0, atol=1e-4)
        out["seg_sum_bands"][name] = both_timed(
            lambda: sr.seg_sum_bands(slot, stats, K))
        out["seg_min_bands"][name] = both_timed(
            lambda: sr.seg_min_bands(slot, cols, K))
    return out


def print_runs(runs):
    for kernel, by_run in runs.items():
        print(f"{kernel} runs, ms in a graph (by events): " + ", ".join(
            f"{r} {t['graph_ms']:.4f} ({t['ms']:.4f})"
            for r, t in by_run.items()))


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
    runs = label_runs(prob, K, sy, sx)
    print_runs(runs)
    return [
        dict(common, name="label_moment_sums",
             replaces="onnxocr_tpu/ops/pallas/seg_reduce2.py:74",
             max_abs_err=float((sums - psums).abs().max()),
             **both_timed(lambda: sr.label_moment_sums(lab, prob, ids, sy,
                                                       sx)),
             plain_ms=timed(lambda: sr.label_moment_sums_plain(
                 lab, prob, ids, sy, sx)), bound_ms=t1, bound_by=b1,
             device_ops=device_ops(lambda: sr.label_moment_sums(
                 lab, prob, ids, sy, sx), "label_moment_sums"),
             label_runs=runs["label_moment_sums"]),
        dict(common, name="label_proj_extents",
             replaces="onnxocr_tpu/ops/pallas/seg_reduce2.py:190",
             max_abs_err=float((ext - pext)[present].abs().max()),
             **both_timed(lambda: sr.label_proj_extents(lab, axes, ids, sy,
                                                        sx)),
             plain_ms=timed(lambda: sr.label_proj_extents_plain(
                 lab, axes, ids, sy, sx)), bound_ms=t2, bound_by=b2,
             device_ops=device_ops(lambda: sr.label_proj_extents(
                 lab, axes, ids, sy, sx), "label_proj_extents"),
             label_runs=runs["label_proj_extents"])]


def check_seg_reduce(ocr, img, with_runs=False):
    """Kernels 4 and 5 on the slot / stats / projection columns that
    db_device builds from a real page's labelled grid; `with_runs`: also on
    the made-up slot runs of the same size."""
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
    runs = slot_runs(n, K, slot.device) if with_runs else None
    if runs:
        print_runs(runs)

    def extra(name, fn):
        return dict(device_ops=device_ops(fn, name),
                    slot_runs=runs[name]) if runs else {}

    return [
        dict(common, name="seg_sum_bands",
             replaces="onnxocr_tpu/ops/pallas/seg_reduce.py:118",
             max_abs_err=float((sums - psums).abs().max()),
             **both_timed(lambda: sr.seg_sum_bands(slot, stats, K)),
             plain_ms=timed(lambda: sr.seg_sum_bands_plain(slot, stats, K)),
             library_ms=timed(lib_sum), bound_ms=t4, bound_by=b4,
             **extra("seg_sum_bands",
                     lambda: sr.seg_sum_bands(slot, stats, K))),
        dict(common, name="seg_min_bands",
             replaces="onnxocr_tpu/ops/pallas/seg_reduce.py:127",
             max_abs_err=float((ext - pext).abs().max()),
             **both_timed(lambda: sr.seg_min_bands(slot, cols, K)),
             plain_ms=timed(lambda: sr.seg_min_bands_plain(slot, cols, K)),
             library_ms=timed(lib_min), bound_ms=t5, bound_by=b5,
             **extra("seg_min_bands",
                     lambda: sr.seg_min_bands(slot, cols, K)))]


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


def warp_calls(ocr, img, cls):
    """The warp_crops calls one ocr() of `img` makes → [(image, mats,
    valid_w, out_h, out_w)], each at most once per (out_h, out_w)."""
    from onnxocr_tpu_torch.ops import warp
    seen, real = {}, warp.warp_crops

    def spy(image, mats, valid_w, out_h, out_w, *rest, **form):
        seen.setdefault((out_h, out_w), (image, mats.clone(), valid_w.clone(),
                                         out_h, out_w))
        return real(image, mats, valid_w, out_h, out_w, *rest, **form)

    warp.warp_crops = spy
    try:
        ocr.ocr(img, cls=cls)
    finally:
        warp.warp_crops = real
    return list(seen.values())


def shear_vs_gather_ok(crop, gather, width):
    """tests/test_warp.py's bound between a shear-form crop and its gather
    form over the valid width, in levels: mean < 1, p99 < 10, max < 80."""
    d = (crop[:, :width] - gather[:, :width]).abs().double() * 127.5
    return (float(d.mean()) < 1.0 and float(d.quantile(0.99)) < 10.0
            and float(d.max()) < 80.0), float(d.max())


def check_warp(label, calls):
    """Every warp form × interpolation on the crop matrices a path's page
    gave its warps, on the card against the same port on the CPU (atol 1e-4
    in normalized units), the shear eligibility counted on both, each form
    timed. A crop whose eligibility differs between the two is held to
    tests/test_warp.py's shear-vs-gather bound instead, and reported. →
    [{path, shape, crops, eligible, flipped, forms: {form: times and what
    one call puts on the card}}]."""
    import torch
    from onnxocr_tpu_torch.ops import warp
    out = []
    for image, mats, vw, out_h, out_w in calls:
        cpu = [t.cpu() for t in (image, mats, vw)]
        elig = warp._shear_mask(mats, vw, out_h).cpu()
        elig_cpu = warp._shear_mask(*cpu[1:], out_h)
        live = cpu[2] > 0
        flips = torch.nonzero((elig != elig_cpu) & live)[:, 0].tolist()
        entry = {"path": label, "shape": [int(mats.shape[0]), out_h, out_w],
                 "crops": int(live.sum()),
                 "eligible": int((elig & live).sum()),
                 "eligible_cpu": int((elig_cpu & live).sum()),
                 "flipped": [], "forms": {}}
        for staged in (False, True, "shear"):
            for interp in ("bilinear", "bicubic"):
                got = warp.warp_crops(image, mats, vw, out_h, out_w, interp,
                                      staged).cpu()
                want = warp.warp_crops(*cpu, out_h, out_w, interp, staged)
                keep = torch.ones(len(got), dtype=torch.bool)
                if staged == "shear" and interp == "bilinear":
                    for i in flips:
                        ok, worst = shear_vs_gather_ok(got[i], want[i],
                                                       int(cpu[2][i]))
                        assert ok, (f"warp on path {label}: crop {i} flips "
                                    f"its shear verdict, {worst:.1f} levels")
                        entry["flipped"].append({"crop": i, "levels": worst})
                        keep[i] = False
                torch.testing.assert_close(
                    got[keep], want[keep], rtol=0, atol=1e-4,
                    msg=lambda m: f"warp {staged} {interp} on path {label}: "
                                  f"{m}")
        for name, staged, interp in (("off", False, "bilinear"),
                                     ("upright", "upright", "bilinear"),
                                     ("shear", "shear", "bilinear"),
                                     ("bicubic", False, "bicubic")):
            def call():
                return warp.warp_crops(image, mats, vw, out_h, out_w, interp,
                                       staged)

            entry["forms"][name] = dict(ms=timed(call),
                                        graph_ms=graph_timed(call),
                                        **device_counts(call, calls=1))
        print(f"warp on path {label} at {entry['shape']}: "
              f"{entry['eligible']} of {entry['crops']} crops shear-eligible "
              f"on the card, {entry['eligible_cpu']} on the CPU, "
              f"{len(flips)} flipped; ms by events (in a graph), kernels a "
              f"call: " + ", ".join(
                  f"{n} {t['ms']:.3f} ({t['graph_ms']:.3f}), {t['kernels']}"
                  for n, t in entry["forms"].items()))
        out.append(entry)
    return out


def drive(ocr, pages, names, cls, label, times=None):
    """Run `names` through ocr() once unmeasured, so that every (width,
    batch) shape the pages reach has been used; then set the launch counts
    to 0 and run them again → (results by page name, launch counts of the
    second pass); the second pass's ms a page are appended to `times`."""
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
    results, ms_list = {}, []
    for name in names:
        t0 = time.perf_counter()
        res = ocr.ocr(pages[name], cls=cls)[0]
        ms = (time.perf_counter() - t0) * 1e3
        ms_list.append(ms)
        results[name] = res
        boxes = np.asarray([l[0] for l in res], np.float64)
        scores = np.asarray([l[1][1] for l in res], np.float64)
        assert np.isfinite(boxes).all() and np.isfinite(scores).all()
        print(f"path {label} page {name}: {ms:.1f} ms, {len(res)} boxes, "
              f"{sum(bool(l[1][0]) for l in res)} lines")
    launches = dict(build.LAUNCHES)
    if times is not None:
        times.extend(ms_list)
    print(f"path {label}: {len(names)} pages in {sum(ms_list):.1f} ms "
          f"(mean {np.mean(ms_list):.1f}, median {np.median(ms_list):.1f} "
          f"ms/page); launches {launches}")
    assert sum(len(r) for r in results.values()) > 0
    return results, launches


def bitmap_ties(gpu, cpu, img):
    """Path C's DB bitmap of `img` on the card against the CPU's → (pixels
    that differ, max abs difference of the two maps over the valid
    region). A map that differs by float rounding may flip a pixel whose
    probability lies that close to det_db_thresh; every differing pixel
    must be such a tie."""
    from onnxocr_tpu_torch.ops import det_pre, resize_dev
    out = []
    for ocr in (gpu, cpu):
        image, h, w = resize_dev.put_src_bucket(img, ocr.device)
        bits, prob, (rh, rw) = ocr.text_detector.bitmap_forward(
            image, h, w, ocr._fixed_canvas())
        out.append((det_pre.unpack_bitmap(bits.cpu().numpy()[:rh, :rw // 8],
                                          rw), prob.cpu().numpy()[:rh, :rw]))
    (bm, prob), (bm_cpu, prob_cpu) = out
    diff = bm != bm_cpu
    err = float(np.abs(prob - prob_cpu).max())
    thresh = cpu.text_detector.postprocess_op.thresh
    assert (np.abs(prob_cpu[diff] - thresh) <= err).all(), \
        "path C: a bitmap pixel differs from the CPU's and is no tie"
    return int(diff.sum()), err


def same_result(got, ref):
    assert len(got) == len(ref), (len(got), len(ref))
    assert [l[1][0] for l in got] == [l[1][0] for l in ref]
    for g, r in zip(got, ref):
        assert np.abs(np.asarray(g[0]) - np.asarray(r[0])).max() <= 2.0


def concurrent(ocr, pages, names, threads=8):
    """ocr() of `names` from `threads` threads at once, as the JAX
    package's serving engine calls one model → (results in names order,
    wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        res = list(pool.map(lambda n: ocr.ocr(pages[n], cls=False)[0],
                            names))
    return res, time.perf_counter() - t0


def phase_q(model, ocr_c, pages, rounds=3):
    """Path C behind both cross-request batchers (the default pipeline as
    the JAX package's engine serves it): `ONNXPaddleOcr(tpu_det_microbatch=
    True, tpu_rec_microbatch=True)` at the defaults, its canonical
    multi-page shapes warmed for the pages' source bucket, one unmeasured
    concurrent pass, then each page serially (ms a page, both 8 ms waits
    included), then 8 threads over `rounds` × the pages, counted, and the
    same 8 threads on `ocr_c` (no batchers). Each concurrent result must
    equal the serial one, one page the CPU's; a det wave and a rec group
    must have held two pages or more, and the CTC head must launch fewer
    times than without the batchers. → (summary, launches of the counted
    batched run)."""
    import torch
    from onnxocr_tpu_torch.ops import resize_dev
    from onnxocr_tpu_torch.ops.kernels import build
    kw_q = dict(tpu_det_microbatch=True, tpu_rec_microbatch=True)
    ocr_q = model("cuda", **kw_q)
    try:
        det_b = ocr_q.text_detector._page_batcher
        rec_b = ocr_q.text_recognizer._crop_batcher
        src = {resize_dev.src_bucket_shape(*p.shape[:2])
               for p in pages.values()}
        assert len(src) == 1, f"pages of several source buckets: {src}"
        t0 = time.perf_counter()
        warmed = rec_b.warm_canonical(
            ocr_q._fused, src.pop() + (3,), ocr_q.text_recognizer
            .rec_image_shape[1], use_cls=False, prob_shape=det_b.canvas)
        warm_ms = (time.perf_counter() - t0) * 1e3
        waves, groups = [], []
        det_fn = det_b.batcher.fn
        det_b.batcher.fn = lambda batch: waves.append(
            (int((batch["rhw"][:, 0] > 0).sum()), len(batch["rhw"]))) \
            or det_fn(batch)
        multi = ocr_q._fused.call_multi_scored

        def multi_spy(images, probs, rhw, img_idx, pre_quads, cls_mats,
                      cls_valid, rec_mats, rot_mats, rec_valid, out_h,
                      out_w, **kw):
            real = rec_valid > 0
            groups.append({"pages": int(images.shape[0]),
                           "real_pages": int(np.unique(img_idx[real]).size),
                           "real_rows": int(real.sum()),
                           "rows": int(len(rec_valid)), "width": int(out_w)})
            return multi(images, probs, rhw, img_idx, pre_quads, cls_mats,
                         cls_valid, rec_mats, rot_mats, rec_valid, out_h,
                         out_w, **kw)

        ocr_q._fused.call_multi_scored = multi_spy
        concurrent(ocr_q, pages, PAGES)            # unmeasured
        concurrent(ocr_c, pages, PAGES)
        for name in PAGES:                          # unmeasured, solo shapes
            ocr_q.ocr(pages[name], cls=False)
        serial, serial_ms = {}, []
        for name in PAGES:
            t0 = time.perf_counter()
            serial[name] = ocr_q.ocr(pages[name], cls=False)[0]
            serial_ms.append((time.perf_counter() - t0) * 1e3)
        names = list(PAGES) * rounds
        torch.cuda.synchronize()
        waves.clear()
        groups.clear()
        build.LAUNCHES.clear()
        got, wall = concurrent(ocr_q, pages, names)
        launches = dict(build.LAUNCHES)
        build.LAUNCHES.clear()
        _, base_wall = concurrent(ocr_c, pages, names)
        base_launches = dict(build.LAUNCHES)
        for name, res in zip(names, got):
            same_result(res, serial[name])
        cpu = model("cpu", **kw_q)
        try:
            same_result(serial[PAGES[0]],
                        cpu.ocr(pages[PAGES[0]], cls=False)[0])
        finally:
            cpu.close()
        head = launches.get("ctc_head_reduce", 0)
        base_head = base_launches.get("ctc_head_reduce", 0)
        summary = {
            "threads": 8, "pages": len(names),
            "pages_per_s": len(names) / wall,
            "pages_per_s_unbatched": len(names) / base_wall,
            "serial_ms_per_page": float(np.mean(serial_ms)),
            "serial_ms": serial_ms, "wait_ms": 8.0,
            "warm_canonical": warmed, "warm_ms": warm_ms,
            "det_waves": [{"pages": n, "batch": b} for n, b in waves],
            "rec_groups": groups,
            "ctc_head_launches_per_page": head / len(names),
            "ctc_head_launches_per_page_unbatched": base_head / len(names),
            "launches": launches, "launches_unbatched": base_launches}
        print(f"path Q: {len(names)} pages from 8 threads in {wall:.3f} s "
              f"({summary['pages_per_s']:.2f} pages/s; without the batchers "
              f"{summary['pages_per_s_unbatched']:.2f}); serial "
              f"{summary['serial_ms_per_page']:.1f} ms a page; det waves "
              f"(pages/batch) {waves}; rec groups (real pages, real/padded "
              f"rows, width) " + ", ".join(
                  f"{g['real_pages']} {g['real_rows']}/{g['rows']} "
                  f"w{g['width']}" for g in groups)
              + f"; CTC head {head} launches against {base_head}; "
              f"concurrent results equal the serial ones, one the CPU's")
        assert max(n for n, _ in waves) >= 2, "path Q: no det wave of 2 pages"
        assert max(g["real_pages"] for g in groups) >= 2, \
            "path Q: no rec group of 2 pages"
        assert 0 < head < base_head, \
            f"path Q: CTC head launched {head} times, unbatched {base_head}"
        return summary, launches
    finally:
        ocr_q.close()


def _run_held(ocr, pages, names):
    """ocr() of `names`, one thread each, while the wave dispatcher is held;
    released once all are queued, so they run as one wave → results in
    names order."""
    from concurrent.futures import ThreadPoolExecutor
    wave = ocr._onecall._wave
    wave._hold = True
    with ThreadPoolExecutor(len(names)) as pool:
        futures = [pool.submit(lambda n=n: ocr.ocr(pages[n], cls=False)[0])
                   for n in names]
        deadline = time.time() + 60
        while len(wave._queue) < len(names) and time.time() < deadline:
            time.sleep(0.005)
        assert len(wave._queue) == len(names), "pages did not queue"
        with wave._cv:
            wave._hold = False
            wave._cv.notify_all()
        return [f.result(timeout=300) for f in futures]


def _close_results(got, ref, label):
    """same_result, and scores within 2e-3 → max box difference."""
    same_result(got, ref)
    worst = 0.0
    for g, r in zip(got, ref):
        worst = max(worst, float(np.abs(np.asarray(g[0], np.float64) -
                                        np.asarray(r[0], np.float64)).max()))
        assert abs(g[1][1] - r[1][1]) < 2e-3, f"{label}: score off"
    return worst


def phase_w(model, pages, rounds=3):
    """Path W, the one-call path with the wave coalescer
    (`tpu_onecall_wave=True`, defaults otherwise): tiers 2 and 4 warmed
    with warm_sync; waves of 2 and of 4 pages forced with `_hold` equal to
    the single-page program's results at tpu_warp_stage='off' (the wave
    warps with the gather); one wave's step (`step_wave`) launching the
    CTC head once and kernels 2–3 once a page, its buffers equal to the
    CPU port's; W′, the same with tpu_db_reduce='pallas' (kernels 4–5);
    then 8 threads over `rounds` × the pages, counted, against path B's
    single pages on the same threads. No warm may fail. → (summary, {"W":
    launches of the counted run, "W'": launches of W′'s wave})."""
    import torch
    from onnxocr_tpu_torch.ops import resize_dev
    from onnxocr_tpu_torch.ops.kernels import build
    kw_w = dict(tpu_pipeline="onecall", tpu_onecall_wave=True)
    ocr_w = model("cuda", **kw_w)
    ocr_w2 = model("cuda", **kw_w, tpu_db_reduce="pallas")
    ocr_off = model("cuda", tpu_pipeline="onecall", tpu_warp_stage="off")
    ocr_b = model("cuda", tpu_pipeline="onecall")
    try:
        oc, wave = ocr_w._onecall, ocr_w._onecall._wave
        h, w = pages[PAGES[0]].shape[:2]
        src = resize_dev.src_bucket_shape(h, w) + (3,)
        (rh, rw), (hb, wb), (eh, ew) = oc.canvas(h, w)
        warm_ms = {}
        for ocr_x in (ocr_w, ocr_w2):
            for B in (2, 4):
                t0 = time.perf_counter()
                ocr_x._onecall._wave.warm_sync(False, src, hb, wb, B, eh, ew)
                warm_ms[f"{'W' if ocr_x is ocr_w else 'Wp'}{B}"] = \
                    (time.perf_counter() - t0) * 1e3
        key = (False, src, hb, wb, eh, ew)
        assert {(key, 2), (key, 4)} <= wave._ready, "a tier did not warm"
        single = {n: ocr_off.ocr(pages[n], cls=False)[0] for n in PAGES}
        shear = {n: ocr_w.ocr(pages[n], cls=False)[0] for n in PAGES}
        held_box = 0.0
        for names in (PAGES[:2], PAGES[2:6]):
            before = dict(wave.stats["waves"])
            got = _run_held(ocr_w, pages, names)
            assert wave.stats["waves"].get(len(names), 0) == \
                before.get(len(names), 0) + 1, "the held pages ran apart"
            for n, res in zip(names, got):
                held_box = max(held_box, _close_results(
                    res, single[n], f"path W wave of {len(names)}"))
        print(f"path W: held waves of 2 and 4 pages equal the single-page "
              f"program's at the gather warp (boxes within {held_box:.2e})")

        # one wave's step: launches, and its buffers against the CPU's
        ups = [resize_dev.put_src_bucket(pages[n], "cuda")
               for n in PAGES[:4]]
        images = torch.stack([u[0] for u in ups])
        sizes = [[u[1] for u in ups], [u[2] for u in ups],
                 [rh] * 4, [rw] * 4]
        torch.cuda.synchronize()
        build.LAUNCHES.clear()
        out = oc.step_wave(images, *sizes, hb, wb, eh, ew).cpu().numpy()
        step_launches = dict(build.LAUNCHES)
        assert step_launches == {"ctc_head_reduce": 1,
                                 "label_moment_sums": 4,
                                 "label_proj_extents": 4}, step_launches
        cpu = model("cpu", **kw_w)
        try:
            coc = cpu._onecall
            cout = coc.step_wave(images[:2].cpu(), *(s[:2] for s in sizes),
                                 hb, wb, eh, ew).numpy()
            for b in range(2):
                k = oc.k_rec
                assert out[b, k, 0] == cout[b, k, 0], "n_valid differs"
                got = oc.decode_packed(out[b], images[b])
                want = coc.decode_packed(cout[b], images[b].cpu())
                same_result([[q, r] for q, r in zip(*got)],
                            [[q, r] for q, r in zip(*want)])
        finally:
            cpu.close()
        print(f"path W: one 4-page wave step launched {step_launches}; the "
              f"first two pages' buffers decode as the CPU's")

        # W′: the slot-keyed reductions in a held wave of 2
        torch.cuda.synchronize()
        build.LAUNCHES.clear()
        got = _run_held(ocr_w2, pages, PAGES[:2])
        w2_launches = dict(build.LAUNCHES)
        for n, res in zip(PAGES[:2], got):
            _close_results(res, single[n], "path W'")
        for name in ("ctc_head_reduce", "seg_sum_bands", "seg_min_bands"):
            assert w2_launches.get(name, 0) > 0, f"path W': {name}"
        assert w2_launches["seg_sum_bands"] == 2, w2_launches
        print(f"path W': a held wave of 2 launched {w2_launches}")

        # 8 threads: W against path B's single pages
        names = list(PAGES) * rounds
        concurrent(ocr_b, pages, PAGES)            # unmeasured
        concurrent(ocr_w, pages, PAGES)
        serial_ms = []
        for n in PAGES:
            t0 = time.perf_counter()
            ocr_w.ocr(pages[n], cls=False)
            serial_ms.append((time.perf_counter() - t0) * 1e3)
        before = dict(wave.stats["waves"])
        torch.cuda.synchronize()
        build.LAUNCHES.clear()
        got, wall = concurrent(ocr_w, pages, names)
        launches = dict(build.LAUNCHES)
        waves = {b: n - before.get(b, 0)
                 for b, n in wave.stats["waves"].items()
                 if n - before.get(b, 0)}
        build.LAUNCHES.clear()
        _, base_wall = concurrent(ocr_b, pages, names)
        base_launches = dict(build.LAUNCHES)
        for n, res in zip(names, got):
            try:
                same_result(res, shear[n])
            except AssertionError:
                same_result(res, single[n])
        for name in ("ctc_head_reduce", "label_moment_sums",
                     "label_proj_extents"):
            assert launches.get(name, 0) > 0, f"path W: {name} never launched"
        assert not wave.stats["warm_errors"] and \
            not ocr_w2._onecall._wave.stats["warm_errors"], \
            wave.stats["warm_errors"]
        summary = {
            "threads": 8, "pages": len(names),
            "pages_per_s": len(names) / wall,
            "pages_per_s_path_b": len(names) / base_wall,
            "serial_ms_per_page": float(np.mean(serial_ms)),
            "serial_ms": serial_ms, "wave_sizes": waves,
            "warm_ms": warm_ms, "held_wave_max_box_diff": held_box,
            "wave_step_launches": step_launches,
            "launches": launches, "launches_path_b": base_launches,
            "launches_w_prime": w2_launches,
            "warm_errors": wave.stats["warm_errors"]}
        print(f"path W: {len(names)} pages from 8 threads in {wall:.3f} s "
              f"({summary['pages_per_s']:.2f} pages/s; path B single pages "
              f"{summary['pages_per_s_path_b']:.2f}); serial "
              f"{summary['serial_ms_per_page']:.1f} ms a page; waves by "
              f"size {waves}; launches {launches} against {base_launches}")
        return summary, {"W": launches, "W'": w2_launches}
    finally:
        for m in (ocr_w, ocr_w2, ocr_off, ocr_b):
            m.close()


def phase_h(model, pages):
    """Path H, the host image operations (cv2's pixels from numpy twins):
    each case one page on the card against the same port on the CPU —
    tpu_det_input='host'; tpu_crop_backend='host' with the classifier; the
    det-only form; the rec-only and cls-only forms on host crops; a tiny
    page (h + w < 64) at the defaults and through path Q's batchers; the
    det batcher's maps wire and boxes mode. → (launches over the phase,
    host_times)."""
    import torch
    from onnxocr_tpu_torch.ops.kernels import build
    from onnxocr_tpu_torch.utils.image import get_rotate_crop_image
    cls_kw = dict(use_angle_cls=True, tpu_allow_untrained=True)
    page = pages[PAGES[3]]
    tiny = np.ascontiguousarray(pages[PAGES[0]][37:65, 225:259])
    cases = (
        ("det_input_host", dict(tpu_det_input="host"), "full", page),
        ("crop_backend_host", dict(cls_kw, tpu_crop_backend="host"),
         "full_cls", page),
        ("det_only", {}, "det", page),
        ("rec_only", {}, "rec", page),
        ("cls_only", cls_kw, "cls", page),
        ("tiny_defaults", {}, "full", tiny),
        ("tiny_path_q", dict(tpu_det_microbatch=True,
                             tpu_rec_microbatch=True), "full", tiny),
        ("batcher_maps_wire", dict(tpu_det_microbatch=True,
                                   tpu_det_wire="map"), "full", page),
        ("batcher_boxes_mode", dict(tpu_det_microbatch=True,
                                    tpu_det_postprocess="device"), "full",
         page))
    crops = None
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    for label, kw, form, img in cases:
        outs = []
        for device in ("cuda", "cpu"):
            ocr = model(device, **kw)
            try:
                if form in ("rec", "cls") and crops is None:
                    boxes = ocr.ocr(img, rec=False, cls=False)[0][:12]
                    crops = [get_rotate_crop_image(
                        img, np.asarray(b, np.float32)) for b in boxes]
                if form.startswith("full"):
                    outs.append(ocr.ocr(img, cls=form == "full_cls")[0])
                elif form == "det":
                    outs.append(ocr.ocr(img, rec=False, cls=False)[0])
                elif form == "rec":
                    outs.append(ocr.ocr(crops, det=False, cls=False)[0])
                else:
                    outs.append(ocr.ocr(crops, det=False, rec=False)[0])
            finally:
                ocr.close()
        got, want = outs
        assert len(got) == len(want) > 0, (label, len(got), len(want))
        if form.startswith("full"):
            same_result(got, want)
        elif form == "det":
            assert np.abs(np.asarray(got, np.float64) -
                          np.asarray(want, np.float64)).max() <= 2.0
        else:
            assert [t for t, _ in got] == [t for t, _ in want], label
            assert max(abs(a[1] - b[1]) for a, b in zip(got, want)) < 2e-3
        print(f"path H {label}: the card's {len(got)} results agree with "
              f"the CPU's")
    launches = dict(build.LAUNCHES)
    for name in ("ctc_head_reduce", "label_moment_sums",
                 "label_proj_extents"):
        assert launches.get(name, 0) > 0, f"path H: {name} never launched"
    print(f"path H: launches {launches}")
    return launches, host_times(model, pages)


def host_times(model, pages):
    """Host ms of the numpy twins on the held-out pages (this machine's
    CPU, no device work): the det input (resize to the det target into
    the canvas), the host crops of each page's det boxes and the
    recognizer's resize of those crops."""
    from onnxocr_tpu_torch.ops import det_pre
    from onnxocr_tpu_torch.utils.image import get_rotate_crop_image
    ocr = model("cuda")
    rec = ocr.text_recognizer
    t_det, t_crop, t_resize, n_crops = [], [], [], 0
    for name in PAGES:
        img = pages[name]
        boxes = ocr.text_detector(img)
        t0 = time.perf_counter()
        det_pre.prepare_det_input(img, ocr.text_detector.limit_side_len)
        t1 = time.perf_counter()
        crops = [get_rotate_crop_image(img, np.asarray(b, np.float32))
                 for b in boxes]
        t2 = time.perf_counter()
        for c in crops:
            rec.resize_norm_img(c, 640)
        t3 = time.perf_counter()
        t_det.append((t1 - t0) * 1e3)
        t_crop.append((t2 - t1) * 1e3)
        t_resize.append((t3 - t2) * 1e3)
        n_crops += len(crops)
    out = {"pages": len(PAGES), "crops": n_crops,
           "det_input_ms_per_page": float(np.mean(t_det)),
           "host_crops_ms_per_page": float(np.mean(t_crop)),
           "rec_resize_ms_per_page": float(np.mean(t_resize))}
    print(f"host twins, ms a page over {len(PAGES)} pages: det input "
          f"{out['det_input_ms_per_page']:.1f}, host crops "
          f"{out['host_crops_ms_per_page']:.1f} ({n_crops} crops), rec "
          f"resize {out['rec_resize_ms_per_page']:.1f}")
    return out


# ------------------------------------------------------------ phase S
# a document page and a table page, each sent four times a round in each
# of three forms (24 requests a round; two rounds are counted), then 20
# times each serially (40 requests, enough for a p95); the CPU references
# they need (a PNG and a JPEG each, per pipeline) bound the phase's time
SERVE_PAGES = (PAGES[0], PAGES[3])
SERVE_COUNTED_ROUNDS = 2
SERVE_SERIAL = 20
SERVE_MODES = (
    ("staged", {}),
    ("onecall", {"PIPELINE_MODE": "onecall"}),
    ("onecall_waves", {"PIPELINE_MODE": "onecall", "WAVE_BATCH": "1"}))


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _multipart(files, fields=None):
    """→ (body, content type) of a multipart/form-data upload."""
    import uuid
    boundary = uuid.uuid4().hex
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"'
             f'\r\n\r\n{v}\r\n'.encode() for k, v in (fields or {}).items()]
    for field, name, blob, ctype in files:
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{field}"; filename="{name}"\r\nContent-Type: '
                     f'{ctype}\r\n\r\n'.encode() + blob + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


class _Client:
    """One keep-alive HTTP/1.1 connection to the server on 127.0.0.1."""

    def __init__(self, port):
        import http.client
        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=300)

    def request(self, method, path, body=b"", ctype=None):
        headers = {"content-type": ctype} if ctype else {}
        self.conn.request(method, path, body=body, headers=headers)
        resp = self.conn.getresponse()
        return resp.status, resp.getheader("content-type"), resp.read()

    def close(self):
        self.conn.close()


def _request_of(kind, name, blobs):
    """The request of `kind` ('v1_png', 'v1_jpeg', 'v2_png') for a page →
    (method, path, body, content type)."""
    import base64
    if kind.startswith("v1"):
        fmt = kind[3:]
        return ("POST", "/ocr", json.dumps({"image": base64.b64encode(
            blobs[fmt][name]).decode()}).encode(), "application/json")
    body, ctype = _multipart([("file", f"{name}.png", blobs["png"][name],
                               "image/png")])
    return "POST", "/api/v2/ocr", body, ctype


def _as_lines(results):
    """HTTP results → ocr() lines [[box, (text, score)], ...]."""
    return [[r["bounding_box"], (r["text"], r["confidence"])]
            for r in results]


def _serve_mode(label, env, pages, blobs, cpu_ref, threads=8):
    """One engine mode behind the port's HTTP server on 127.0.0.1 (in
    this process, on the card): readiness, every page as v1 PNG, v1 JPEG
    and v2 multipart from `threads` clients (one unmeasured round, then
    SERVE_COUNTED_ROUNDS counted rounds between LAUNCHES reads), a serial
    pass of SERVE_SERIAL requests a page, one
    return_image and one multi-file text/zip request. → (summary,
    launches of the counted rounds)."""
    import asyncio
    import threading
    import zipfile
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from onnxocr_tpu_torch.ops.kernels import build
    from onnxocr_tpu_torch.service import engine as engine_mod
    from onnxocr_tpu_torch.service.http import serve
    from onnxocr_tpu_torch.service.routes import build_app
    from onnxocr_tpu_torch.utils import imcodec

    saved = {k: os.environ.get(k) for k in
             ("PIPELINE_MODE", "WAVE_BATCH", "WARMUP_SRC_BUCKETS")}
    for k in saved:
        os.environ.pop(k, None)
    os.environ.update(env)
    if "WAVE_BATCH" in env:
        h, w = pages[PAGES[0]].shape[:2]
        os.environ["WARMUP_SRC_BUCKETS"] = f"{h}x{w}"
    engine_mod.reset_engine_manager()
    em = engine_mod.get_engine_manager()
    port = _free_port()
    loop = asyncio.new_event_loop()
    task = {}

    def run_server():
        asyncio.set_event_loop(loop)
        task["t"] = loop.create_task(serve(build_app(), "127.0.0.1", port))
        try:
            loop.run_until_complete(task["t"])
        except asyncio.CancelledError:
            pass

    t0 = time.perf_counter()
    server = threading.Thread(target=run_server, daemon=True)
    server.start()
    try:
        ready_s = None
        while time.perf_counter() - t0 < 300:
            try:
                c = _Client(port)
                status, _, _ = c.request("GET", "/api/v2/readyz")
                c.close()
                if status == 200:
                    ready_s = time.perf_counter() - t0
                    break
            except OSError:
                pass
            if em.warmup_error is not None:
                raise RuntimeError(f"path S {label}: warm-up failed: "
                                   f"{em.warmup_error!r}")
            time.sleep(0.05)
        assert ready_s is not None, f"path S {label}: never ready"
        assert em.warmup_error is None
        model = em.get_model()
        kinds = ("v1_png", "v1_jpeg", "v2_png")
        round_ = [(k, n) for n in SERVE_PAGES for k in kinds] * 4
        reqs = round_ * SERVE_COUNTED_ROUNDS

        def call(client_req):
            k, n = client_req
            c = _Client(port)
            try:
                t = time.perf_counter()
                status, ctype, body = c.request(*_request_of(k, n, blobs))
                ms = (time.perf_counter() - t) * 1e3
            finally:
                c.close()
            assert status == 200 and ctype == "application/json", \
                (label, k, n, status, body[:200])
            return json.loads(body)["results"], ms

        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(call, round_))                 # unmeasured
            torch.cuda.synchronize()
            build.LAUNCHES.clear()
            t1 = time.perf_counter()
            got = list(pool.map(call, reqs))
            wall = time.perf_counter() - t1
            launches = dict(build.LAUNCHES)
        serial_ms = [call(("v1_png", n))[1]
                     for n in SERVE_PAGES * SERVE_SERIAL]
        kwargs = em._get_model_kwargs(em.default_model)

        def held(lines, fmt, n):
            """lines against the CPU port's ocr() of page n at the same
            kwargs → max box difference; a wave's pages warp with the
            gather (tpu_warp_stage='off'), a lone page with the shear."""
            try:
                return _close_results(lines, cpu_ref(kwargs, fmt, n),
                                      f"path S {label}")
            except AssertionError:
                if "WAVE_BATCH" not in env:
                    raise
                return _close_results(lines, cpu_ref(
                    dict(kwargs, tpu_warp_stage="off"), fmt, n),
                    f"path S {label}")

        worst = max(held(_as_lines(res), "jpeg" if "jpeg" in k else "png", n)
                    for (k, n), (res, _) in zip(reqs, got))
        needs = ["ctc_head_reduce"]
        if label != "staged":
            needs += ["label_moment_sums", "label_proj_extents"]
        for name in needs:
            assert launches.get(name, 0) > 0, \
                f"path S {label}: {name} never launched in served requests"
        # one return_image request and one multi-file text / zip request
        c = _Client(port)
        try:
            body, ctype = _multipart([("file", "p.png",
                                       blobs["png"][PAGES[0]], "image/png")],
                                     {"return_image": "true"})
            status, _, out = c.request("POST", "/api/v2/ocr", body, ctype)
            import base64
            preview = imcodec.imdecode(base64.b64decode(
                json.loads(out)["preview_image"]))
            assert status == 200 and preview.shape == pages[PAGES[0]].shape
            body, ctype = _multipart(
                [("files", f"{n}.png", blobs["png"][n], "image/png")
                 for n in SERVE_PAGES], {"output_format": "text"})
            status, _, out = c.request("POST", "/api/v2/ocr", body, ctype)
            data = json.loads(out)
            assert status == 200 and data["zip_url"], data
            status, ctype, blob = c.request("GET", data["zip_url"])
            assert status == 200 and ctype == "application/zip"
            with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                texts = {n: zf.read(f"{n}.txt").decode()
                         for n in SERVE_PAGES}
            for item, n in zip(data["items"], SERVE_PAGES):
                assert texts[n] == item["text"]
                lines = texts[n].split("\n")
                held([[ref[0], (t, ref[1][1])] for t, ref in zip(
                    lines, cpu_ref(kwargs, "png", n))], "png", n)
        finally:
            c.close()
        head = launches.get("ctc_head_reduce", 0)
        summary = {
            "mode": label, "env": env, "threads": threads,
            "requests": len(reqs), "requests_s": wall,
            "requests_per_s": len(reqs) / wall,
            "serial_requests": len(serial_ms), "serial_ms": serial_ms,
            "serial_p50_ms": float(np.percentile(serial_ms, 50)),
            "serial_p95_ms": float(np.percentile(serial_ms, 95)),
            "ready_s": ready_s, "launches": launches,
            "ctc_head_launches_per_request": head / len(reqs),
            "max_box_diff_vs_cpu": worst,
            "route": model.route}
        print(f"path S {label}: ready in {ready_s:.1f} s; {len(reqs)} "
              f"requests from {threads} clients in {wall:.3f} s "
              f"({summary['requests_per_s']:.2f} requests/s); "
              f"{len(serial_ms)} serial: p50 "
              f"{summary['serial_p50_ms']:.1f} ms, p95 "
              f"{summary['serial_p95_ms']:.1f} ms; launches {launches} "
              f"({summary['ctc_head_launches_per_request']:.2f} CTC heads a "
              f"request); every response agrees with the CPU port (boxes "
              f"within {worst:.2e}); preview and zip answered")
        return summary, launches
    finally:
        loop.call_soon_threadsafe(lambda: task["t"].cancel())
        server.join(timeout=30)
        assert not server.is_alive(), f"path S {label}: server still runs"
        em.close()
        engine_mod.reset_engine_manager()
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def phase_s(pages, tmp):
    """Path S: the port's HTTP service (python -m onnxocr_tpu_torch.
    service's app and server) on the card in three engine modes — the
    default (staged bitmap wire behind both batchers), PIPELINE_MODE=
    onecall, and onecall with WAVE_BATCH=1 (tiers warmed through
    WARMUP_SRC_BUCKETS) — with the stand-in dictionary under an
    ONNXOCR_TPU_ASSETS root and the untrained classifier; also the codec's
    decode ms a page (PNG, JPEG) and the preview's encode ms. → (summary,
    {"S-<mode>": launches})."""
    from onnxocr_tpu_torch import ONNXPaddleOcr, config
    from onnxocr_tpu_torch.service import routes
    from onnxocr_tpu_torch.service.settings import settings
    from onnxocr_tpu_torch.utils import imcodec
    heldout = config.ASSETS.parent / "test_images_heldout"
    root = os.path.join(tmp, "serve_assets")
    os.makedirs(os.path.join(root, "ppocrv5"), exist_ok=True)
    with open(os.path.join(root, "ppocrv5", "ppocrv5_dict.txt"), "w") as f:
        f.write("".join(f"<{i}>\n" for i in range(18383)))
    saved = {k: os.environ.get(k) for k in
             ("ONNXOCR_TPU_ASSETS", "ONNXOCR_TPU_ALLOW_UNTRAINED")}
    os.environ["ONNXOCR_TPU_ASSETS"] = root
    os.environ["ONNXOCR_TPU_ALLOW_UNTRAINED"] = "1"
    settings.RESULTS_DIR = os.path.join(tmp, "serve_results")
    settings.DEVICE = "cuda"
    blobs = {"png": {}, "jpeg": {}}
    decode = {"png": [], "jpeg": []}
    for n in SERVE_PAGES:
        with open(os.path.join(heldout, f"{n}.png"), "rb") as f:
            blobs["png"][n] = f.read()
        blobs["jpeg"][n] = imcodec.imencode_jpeg(pages[n], 95)
    for fmt in ("png", "jpeg"):
        for n in SERVE_PAGES:
            t = time.perf_counter()
            img = imcodec.imdecode(blobs[fmt][n])
            decode[fmt].append((time.perf_counter() - t) * 1e3)
            if fmt == "png":
                assert np.array_equal(img, pages[n])
    cpu_models, refs = {}, {}

    def cpu_ref(kwargs, fmt, name):
        # the CPU runs pages one at a time: a lone page runs the wave
        # coalescer's single-page step, so the waves flag is left out
        kwargs = {k: v for k, v in kwargs.items() if k != "tpu_onecall_wave"}
        key = json.dumps(kwargs, sort_keys=True)
        if (key, fmt, name) not in refs:
            if key not in cpu_models:
                cpu_models[key] = ONNXPaddleOcr(device="cpu", **kwargs)
            img = imcodec.imdecode(blobs[fmt][name])
            refs[key, fmt, name] = cpu_models[key].ocr(img)[0]
        return refs[key, fmt, name]

    t_phase = time.perf_counter()
    try:
        modes, runs = {}, {}
        for label, env in SERVE_MODES:
            modes[label], runs[f"S-{label}"] = _serve_mode(
                label, env, pages, blobs, cpu_ref)
        page = pages[PAGES[0]]
        res = next(v for k, v in refs.items() if k[1:] == ("png", PAGES[0]))
        enc = []
        for _ in range(5):
            t = time.perf_counter()
            routes._render_preview(page, [res])
            enc.append((time.perf_counter() - t) * 1e3)
    finally:
        for m in cpu_models.values():
            m.close()
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    summary = {"modes": modes, "seconds": time.perf_counter() - t_phase,
               "decode_ms_per_page": {k: float(np.mean(v))
                                      for k, v in decode.items()},
               "page_shape": list(pages[PAGES[0]].shape),
               "preview_encode_ms": float(np.median(enc))}
    print(f"path S ran {summary['seconds']:.1f} s; codec: decode ms a page "
          f"PNG {summary['decode_ms_per_page']['png']:.2f}, JPEG "
          f"{summary['decode_ms_per_page']['jpeg']:.2f}; preview (draw + "
          f"JPEG q85) {summary['preview_encode_ms']:.2f} ms")
    return summary, runs


# the two other families of the JAX package's model registry run on two
# held-out pages that the CPU tests do not use
FAMILY_PAGES = PAGES[1:3]


def family_kwargs(tmp, v5_dict):
    """→ {family: ONNXPaddleOcr kwargs}: the ch_ppocr_server_v2.0 pair
    (ResNet18-vd DBNet, CRNN) with a stand-in of its dictionary (6623
    unique entries named ppocr_keys_v1.txt: blank + 6623 + space = the
    head's 6625), and PP-OCRv4 with the v5 stand-in, as the JAX package's
    registry pairs them."""
    from onnxocr_tpu_torch import config
    server_dict = os.path.join(tmp, "ppocr_keys_v1.txt")
    with open(server_dict, "w") as f:
        f.write("".join(f"<{i}>\n" for i in range(6623)))
    a = config.ASSETS
    return {
        "server": dict(
            det_model_dir=str(a / "ch_ppocr_server_v2.0/det/det.onnx"),
            rec_model_dir=str(a / "ch_ppocr_server_v2.0/rec/rec.onnx"),
            rec_char_dict_path=server_dict),
        "v4": dict(det_model_dir=str(a / "ppocrv4/det/det.onnx"),
                   rec_model_dir=str(a / "ppocrv4/rec/rec.onnx"),
                   rec_char_dict_path=v5_dict)}


def bilstm_share(ocr, pages, names):
    """One more pass of `names` with the CRNN's BiLSTM calls timed as
    `profile_onecall` times them (a synchronize before and after each,
    host clock) → (BiLSTM ms a page, page ms a page)."""
    from onnxocr_tpu_torch.profile_onecall import timed_bilstm
    acc = {}
    undo = timed_bilstm(ocr, acc)
    try:
        t0 = time.perf_counter()
        for name in names:
            ocr.ocr(pages[name], cls=False)
        page_ms = (time.perf_counter() - t0) * 1e3 / len(names)
    finally:
        undo()
    return acc["rec_bilstm"] / len(names), page_ms


def family_forwards(ocr):
    """The server pair's models alone on seeded inputs (CUDA events, TF32
    off): the ResNet DBNet at 960², the CRNN at widths 320 / 640 / 1280
    with batch 16 (whole forward with the reduce, and its conv stack, two
    BiLSTMs and head + reduce apart), and the CRNN forward's peak memory
    above its input at 64 × 1280 (T = 320), beside its logits' size."""
    import torch
    from onnxocr_tpu_torch.ops import ctc
    det = ocr.text_detector.model
    rec = ocr.text_recognizer.forward
    m = rec.model
    vocab = m.head.out_features
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    with torch.inference_mode():
        x = torch.randn(1, 3, 960, 960, device="cuda", generator=g)
        out["resnet_dbnet_960_ms"] = timed(lambda: det(x), iters=10)
        for w in (320, 640, 1280):
            crops = torch.rand(16, 48, w, 3, device="cuda",
                               generator=g) * 2 - 1
            xx = crops.permute(0, 3, 1, 2)
            feats = m.features(xx)
            hid = m.lstm2(m.lstm1(feats)[0])[0]
            out[f"crnn_16x{w}"] = {
                "ms": timed(lambda: rec(crops), iters=10),
                "conv_ms": timed(lambda: m.features(xx), iters=10),
                "bilstm_ms": timed(lambda: m.lstm2(m.lstm1(feats)[0]),
                                   iters=10),
                "head_reduce_ms": timed(
                    lambda: ctc.ctc_reduce_logits(m.head(hid)), iters=10)}
        crops = torch.rand(64, 48, 1280, 3, device="cuda",
                           generator=g) * 2 - 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        idx, prob = rec(crops)
        torch.cuda.synchronize()
        assert idx.shape == (64, 320) and torch.isfinite(prob).all()
        out["crnn_64x1280_peak_mib"] = \
            (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        out["crnn_64x1280_logits_mib"] = 64 * 320 * vocab * 4 / 2 ** 20
    print("family forwards (CUDA events, TF32 off): ResNet DBNet 960² "
          f"{out['resnet_dbnet_960_ms']:.3f} ms; CRNN batch 16 " + ", ".join(
              f"{k[7:]} {v['ms']:.3f} ms (conv {v['conv_ms']:.3f}, BiLSTMs "
              f"{v['bilstm_ms']:.3f}, head + reduce "
              f"{v['head_reduce_ms']:.3f})"
              for k, v in out.items() if k.startswith("crnn_16x"))
          + f"; CRNN 64 × 1280 peak {out['crnn_64x1280_peak_mib']:.1f} MiB "
          f"above its input, logits {out['crnn_64x1280_logits_mib']:.1f} MiB")
    return out


def phase_f(kwargs, pages):
    """The other two families (TF32 off, full width, FAMILY_PAGES): the
    server pair on C (the bitmap wire: the ResNet on each page's own
    canvas, CRNN crops in their own width buckets, logits reduced without
    the head kernel), A (staged device-det, slot-keyed reductions) and B
    (one-call, label-keyed reductions), PP-OCRv4 on C and B, each driven
    as `drive` does with its launches checked (kernel 1 on v4 and never
    on the CRNN; kernels 2–3 on B; 4–5 on A; no reduction on C) and one
    page held against the CPU; then the server pair behind both batchers
    (Q: per-page det canvases resized on the host, CRNN chunks alone) from
    4 threads, each result equal to the serial one, one the CPU's; the
    BiLSTMs' share of a server C page and the models' own times
    (`family_forwards`). → (summary, launches by path)."""
    import torch
    from onnxocr_tpu_torch import ONNXPaddleOcr
    from onnxocr_tpu_torch.ops.kernels import build
    head = ("ctc_head_reduce",)
    label_keyed = ("label_moment_sums", "label_proj_extents")
    slot_keyed = ("seg_sum_bands", "seg_min_bands")
    kw_a = dict(tpu_pipeline="staged", tpu_det_postprocess="device",
                tpu_db_reduce="pallas")
    kw_b = dict(tpu_pipeline="onecall")
    cases = (
        ("F-server-C", "server", {}, "bitmap", (),
         head + label_keyed + slot_keyed),
        ("F-server-A", "server", kw_a, "device", slot_keyed,
         head + label_keyed),
        ("F-server-B", "server", kw_b, "onecall", label_keyed,
         head + slot_keyed),
        ("F-v4-C", "v4", {}, "bitmap", head, label_keyed + slot_keyed),
        ("F-v4-B", "v4", kw_b, "onecall", head + label_keyed, slot_keyed))
    runs, summary = {}, {}
    for label, family, kw, route, needs, absent in cases:
        gpu = ONNXPaddleOcr(device="cuda", **kwargs[family], **kw)
        try:
            assert gpu.route == route, (label, gpu.route)
            arch = (gpu.text_detector.arch, gpu.text_recognizer.forward.arch)
            assert arch == (("resnet18", "crnn") if family == "server"
                            else ("mbv3", "svtr")), (label, arch)
            times = []
            results, launches = drive(gpu, pages, FAMILY_PAGES, False,
                                      label, times)
            for name in needs:
                assert launches.get(name, 0) > 0, \
                    f"path {label}: {name} never launched"
            for name in absent:
                assert launches.get(name, 0) == 0, \
                    f"path {label}: {name} launched"
            cpu = ONNXPaddleOcr(device="cpu", **kwargs[family], **kw)
            page = FAMILY_PAGES[0]
            same_result(results[page], cpu.ocr(pages[page], cls=False)[0])
            print(f"path {label} page {page}: GPU and CPU runs agree "
                  f"({len(results[page])} boxes)")
            runs[label] = launches
            summary[label] = {"ms_per_page": float(np.mean(times)),
                              "ms": times, "launches": launches}
            if label == "F-server-C":
                lstm_ms, page_ms = bilstm_share(gpu, pages, FAMILY_PAGES)
                summary["bilstm_in_server_c"] = {
                    "bilstm_ms_per_page": lstm_ms,
                    "page_ms_synchronized": page_ms,
                    "share": lstm_ms / page_ms}
                print(f"path {label}: the two BiLSTMs take {lstm_ms:.2f} of "
                      f"{page_ms:.2f} ms a page ({lstm_ms / page_ms:.3f}, "
                      f"synchronized)")
                summary["forwards"] = family_forwards(gpu)
        finally:
            gpu.close()
    kw_q = dict(kwargs["server"], tpu_det_microbatch=True,
                tpu_rec_microbatch=True)
    ocr_q = ONNXPaddleOcr(device="cuda", **kw_q)
    try:
        det_b = ocr_q.text_detector._page_batcher
        rec_b = ocr_q.text_recognizer._crop_batcher
        assert det_b.canvas is None, "path F-server-Q: a fixed det canvas"
        waves, groups = [], []
        det_fn = det_b.batcher.fn
        det_b.batcher.fn = lambda batch: waves.append(
            (int((batch["rhw"][:, 0] > 0).sum()), len(batch["rhw"]),
             tuple(batch["pages"].shape[1:3]))) or det_fn(batch)
        run_group = rec_b._run_group
        rec_b._run_group = lambda works: groups.append(len(works)) or \
            run_group(works)
        names = list(FAMILY_PAGES) * 4
        concurrent(ocr_q, pages, names, threads=4)     # unmeasured
        serial = {n: ocr_q.ocr(pages[n], cls=False)[0] for n in FAMILY_PAGES}
        torch.cuda.synchronize()
        waves.clear()
        groups.clear()
        build.LAUNCHES.clear()
        got, wall = concurrent(ocr_q, pages, names, threads=4)
        launches = dict(build.LAUNCHES)
        for name, res in zip(names, got):
            same_result(res, serial[name])
        assert groups and max(groups) == 1, \
            f"path F-server-Q: CRNN chunks grouped {groups}"
        for name in head + label_keyed + slot_keyed:
            assert launches.get(name, 0) == 0, \
                f"path F-server-Q: {name} launched"
        cpu = ONNXPaddleOcr(device="cpu", **kw_q)
        try:
            page = FAMILY_PAGES[0]
            same_result(serial[page], cpu.ocr(pages[page], cls=False)[0])
        finally:
            cpu.close()
        runs["F-server-Q"] = launches
        summary["F-server-Q"] = {
            "threads": 4, "pages": len(names),
            "pages_per_s": len(names) / wall,
            "det_waves": [{"pages": n, "batch": b, "canvas": list(c)}
                          for n, b, c in waves],
            "rec_group_chunks": groups, "launches": launches}
        print(f"path F-server-Q: {len(names)} pages from 4 threads in "
              f"{wall:.3f} s ({len(names) / wall:.2f} pages/s); det waves "
              f"(pages/batch canvas) {waves}; {len(groups)} rec runs of one "
              f"chunk each; results equal the serial ones, one the CPU's")
    finally:
        ocr_q.close()
    return summary, runs


def main() -> int:
    import torch
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    from concurrent.futures import ThreadPoolExecutor
    from onnxocr_tpu_torch import ONNXPaddleOcr, config
    from onnxocr_tpu_torch.ops import native
    from onnxocr_tpu_torch.ops.kernels import build
    from onnxocr_tpu_torch.utils import imcodec
    from onnxocr_tpu_torch.utils.png import read_bgr

    with ThreadPoolExecutor(2) as pool:
        t0 = time.perf_counter()
        host = pool.submit(native.build)
        codec = pool.submit(native.build, imcodec.SOURCE, "libocrimcodec")
        print(f"kernels built in {build.build_all():.1f} s")
        print(f"host libraries {host.result().name}, {codec.result().name} "
              f"built, {time.perf_counter() - t0:.1f} s from the start of "
              f"the build")
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

        # C: ONNXPaddleOcr() at its defaults (staged, bitmap wire)
        kw_c = {}
        # C': the map route with the classifier; the bitmap wire's overflow
        # branch (more candidates than 4 × a top batch size of 4)
        kw_c2 = dict(tpu_det_wire="map", use_angle_cls=True,
                     tpu_allow_untrained=True)
        kw_c3 = dict(use_angle_cls=True, tpu_allow_untrained=True,
                     tpu_batch_buckets=(4,))
        # B: one-call, label-keyed reductions, classifier off
        kw_b = dict(tpu_pipeline="onecall", use_angle_cls=False)
        # A: staged device-det, slot-keyed reductions, classifier on
        kw_a = dict(tpu_pipeline="staged", tpu_det_postprocess="device",
                    tpu_db_reduce="pallas", use_angle_cls=True,
                    tpu_allow_untrained=True)
        # A2: the same with the classifier and the recognizer as two steps
        kw_a2 = dict(kw_a, tpu_fused_cls_rec=False)
        # B': one-call, slot-keyed reductions, classifier on
        kw_b2 = dict(tpu_pipeline="onecall", tpu_db_reduce="pallas",
                     use_angle_cls=True, tpu_allow_untrained=True)
        ocr_c = model("cuda", **kw_c)
        ocr_c2 = model("cuda", **kw_c2)
        ocr_c3 = model("cuda", **kw_c3)
        assert (ocr_c.route, ocr_c2.route, ocr_c3.route) == ("bitmap", "map",
                                                             "bitmap")
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
        kernels += [dict(k, path="B'")
                    for k in check_seg_reduce(ocr_b2, page, with_runs=True)]
        # the staged paths' shapes (C and A share the batch and width
        # ladders), counted under the default path C
        staged_ctc = [dict(check_ctc_head(ocr, seed=2 + i, crops=c), path="C")
                      for i, c in enumerate(ocr_c.text_recognizer.batch_ladder
                                            [-2:])]
        # a coalesced rec group at the 960 coalesce width: 64 × 120 rows
        staged_ctc.append(dict(check_ctc_head(ocr, seed=4, rows=64 * 120),
                               path="Q"))
        # a 4-page wave of path W: 4 × K_rec 48 crops × 80 steps
        staged_ctc.append(dict(check_ctc_head(ocr, seed=5, rows=4 * 48 * 80),
                               path="W"))
        others = {"ctc_head_reduce": staged_ctc}
        for k in check_seg_reduce(ocr_a, page):
            others[k["name"]] = [dict(k, path="A")]
        for k in kernels:
            k["other_shapes"] = [
                dict({key: o[key] for key in (
                    "max_abs_err", "ms", "graph_ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by")},
                     path=o["path"], shape=o.get("shape") or o["grid"],
                     labelled_cells=o.get("labelled_cells"))
                for o in others.get(k["name"], ())]
            for o in k["other_shapes"]:
                print(f"{k['name']} at path {o['path']}'s shape {o['shape']}: "
                      f"max abs "
                      f"err {o['max_abs_err']:.2e}, {o['ms']:.4f} ms, "
                      f"{o['graph_ms']:.4f} in a graph (plain "
                      f"{o['plain_ms']:.4f}, library {o['library_ms']:.4f}, "
                      f"bound {o['bound_ms']:.6f} by {o['bound_by']})")
        for kernel, by_case in check_patterns().items():
            print(f"{kernel} on {len(by_case)} seeded patterns: max abs err "
                  f"{max(by_case.values()):.2e}")
            next(k for k in kernels if k["name"] == kernel)["patterns"] = \
                by_case
        warps = check_warp("B", warp_calls(ocr, page, False))
        warps += check_warp("A", warp_calls(ocr_a, page, True))
        print("every warp form agrees with the CPU on the card")
        for k in kernels:
            ops = k.get("device_ops")
            if ops:
                print(f"{k['name']}: {ops['calls']} calls put "
                      f"{ops['kernels']} kernels, {ops['memsets']} memsets, "
                      f"{ops['memcpys']} copies on the card")
        print("kernels agree with their plain versions on the card")

        slot_keyed = ("ctc_head_reduce", "seg_sum_bands", "seg_min_bands")
        reductions = ("label_moment_sums", "label_proj_extents",
                      "seg_sum_bands", "seg_min_bands")
        # the overflow page must not reach the scored passes
        scored = []
        real_scored = ocr_c3.text_recognizer.run_candidates_scored
        ocr_c3.text_recognizer.run_candidates_scored = \
            lambda *a, **kw: scored.append(1) or real_scored(*a, **kw)
        runs, found = {}, {}
        for label, gpu, kw, names, cls, needs, absent, compare in (
                ("C", ocr_c, kw_c, PAGES, False, ("ctc_head_reduce",),
                 reductions, PAGES[:1]),
                ("C'", ocr_c2, kw_c2, PAGES[:3], True, ("ctc_head_reduce",),
                 reductions, PAGES[:3]),
                ("C'o", ocr_c3, kw_c3, PAGES[3:4], True,
                 ("ctc_head_reduce",), reductions, PAGES[3:4]),
                ("B", ocr, kw_b, PAGES[:4], False,
                 ("ctc_head_reduce", "label_moment_sums",
                  "label_proj_extents"), (), PAGES[:1]),
                ("A", ocr_a, kw_a, PAGES, True, slot_keyed, (), PAGES[:1]),
                ("A2", ocr_a2, kw_a2, PAGES[:3], True, slot_keyed, (),
                 PAGES[:1]),
                ("B'", ocr_b2, kw_b2, PAGES[:3], True, slot_keyed, (),
                 PAGES[:1])):
            results, launches = drive(gpu, pages, names, cls, label)
            for name in needs:
                assert launches.get(name, 0) > 0, \
                    f"path {label}: {name} never launched"
            for name in absent:
                assert launches.get(name, 0) == 0, \
                    f"path {label}: {name} launched"
            runs[label], found[label] = launches, results
            cpu = model("cpu", **kw)
            for name in compare:
                same_result(results[name], cpu.ocr(pages[name], cls=cls)[0])
                print(f"path {label} page {name}: GPU and CPU runs agree "
                      f"({len(results[name])} boxes)")
            if label == "C":
                n_diff, map_err = bitmap_ties(gpu, cpu, pages[PAGES[0]])
                print(f"path C page {PAGES[0]}: {n_diff} DB bitmap pixels "
                      f"differ from the CPU's, all ties (maps within "
                      f"{map_err:.2e})")
            if label == "A":
                err = check_classifier(gpu, cpu, seed=1)
                print(f"classifier on the card vs the CPU: max abs err "
                      f"{err:.2e} over 16 seeded crops")
        batch, runs["Q"] = phase_q(model, ocr_c, pages)
        wave_summary, wave_runs = phase_w(model, pages)
        runs.update(wave_runs)
        runs["H"], host = phase_h(model, pages)
        families, family_runs = phase_f(family_kwargs(tmp, dict_path), pages)
        runs.update(family_runs)
        served, serve_runs = phase_s(pages, tmp)
        runs.update(serve_runs)
        assert not scored, "path C'o: the overflow branch was not taken"
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

    print(f"chip_smoke ran {time.perf_counter() - start:.1f} s")
    print(json.dumps({"warp": warps}))
    print(json.dumps({"batch": batch}))
    print(json.dumps({"wave": wave_summary, "host": host}))
    print(json.dumps({"families": families}))
    print(json.dumps({"serve": served}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

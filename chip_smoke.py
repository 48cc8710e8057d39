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
11. drives path P, batch image/PDF OCR (`phase_p`): `OCRLogic(status,
   device=...).run(files, save_txt=True, merge_txt=True, output_img=True)`
   at 4 workers over two held-out pages copied as PNG files, one written as
   a JPEG, scanned PDFs with a /DCTDecode and a /FlateDecode page image, one
   with the committed CMYK JPEG (onnxocr_tpu_torch/assets/samples/, the
   held-out synth_03_doc converted by PIL), a vector PDF (sans, serif and
   mono faces; Tj, TJ with kerning, ', re f), a PDF whose CMYK bitmap the
   rasteriser places rotated, and a broken PDF; once unmeasured and once
   timed on the card (launch counts set to 0 just before), once on the
   CPU; every page's result, the txt and merged-txt files and the overlays'
   sizes must agree, the broken PDF must be reported, and the CTC head must
   have launched; prints pages/s, ms per stage (ingest, recognize, emit),
   overlay ms, CTC-head launches a page and where each DejaVu face was read
   from;
12. runs phase T, the trainers (`phase_t`): from the committed checkpoints
   at full width and seeded batches, a DB step (v5 MobileNetV3 DBNet,
   16 × 320²), a distillation step (server ResNet18-vd student, v5
   teacher), an SVTR CTC step (v5, vocab 18385, 32 × 48 × 320, valid_t)
   and a CRNN CTC step (server, vocab 6625, 16 × 48 × 320), each one step
   on the card held against the port's step on the CPU (loss, every
   gradient, every update), then 20 steps on its fixed batch (ms a step,
   peak MiB, the loss falling to 0.7 of its first value or below); the
   dp × tp SVTR step on `make_mesh()` (1 × 1) and on a 2 × 5 mesh over
   cuda:0 repeated (18385 splits 5 ways, not 2), each against the
   unsharded step; the trained SVTR
   saved with `save_tree` and served on path C, where kernel 1 must launch
   on the head split from the trained weights;
13. runs phase BF (`phase_bf`): paths C, B and A with
   `tpu_dtype='bfloat16'` on one held-out page each, kernel 1 on each,
   kernels 2–3 on B and 4–5 on A, the page held against the CPU port in
   bfloat16, and its ms against the float32 model of the same path;
14. runs phase M, serving across devices (`phase_m`), on `make_mesh()`
   (every card: 1 × 1 on a one-card host) and on a 4 × 1 grid of cuda:0
   repeated: ShardedDetBatch on 5 pages at the 960² canvas against the
   port's DBNet, ShardedRecBatch on 64 crops of 48 × 640 against the
   unsharded SVTR, `sharded_batch_fn(True, mesh)` on 4 pages decoded
   against path B's single pages at the gather warp, with kernels 1–3
   launched for every row (build.count_launch, mesh.current_row) and on
   each row's device (torch.profiler); then the serving engine (MODEL_CONCURRENCY=8,
   DET_BATCH=1, 24 requests from 8 threads) with its det page batch on the
   mesh, against the same engine's model with the maps wave on one device;
   pages a second of every sharded form beside its one-device form (rates
   across cards only where the host has them);
15. runs phase PR, utils/profiling.py (`phase_pr`): the stage timer on,
   paths C, B and A on 4 pages each, whose stage names must be the JAX
   package's (JAX_STAGES), and the captured det_bits, fused_scored and
   onecall programs replayed (replay_ms) and their FLOPs counted (flops);
16. prints {"warp": [...]}, {"batch": {...}} (pages/s with and without the
   batchers, serial ms a page, det wave sizes, rec groups with real and
   padded rows, CTC-head launches a page), {"wave": {...}, "host": {...}}
   (path W's pages/s against path B's, serial ms a page, wave sizes, warm
   ms, launches; the host twins' ms a page), {"families": {...}} (path F's
   ms a page, launches, the BiLSTM share and the models' times),
   {"serve": {...}} (path S's requests/s, serial p50 / p95 ms, seconds to
   readiness and CTC-head launches a request by mode, decode and preview
   ms), {"graph": {...}}, {"batch_ocr": {...}} (path P), {"train": {...}}
   (phase T: ms a step, peak MiB, losses, card-vs-CPU figures),
   {"bf16": {...}} (phase BF: ms a page bf16 and f32), {"multi_device":
   {...}, "profiling": {...}, "card": ...} (phases M and PR),
   {"kernels": [...]}
   and, last, {"ok": true, "device": {...}}; the run's seconds on a line
   before them.

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


# ------------------------------------------------------------ phase P
# the batch layer's inputs: held-out pages as files and inside PDFs
P_PAGES = ("synth_00_doc", "synth_08_table", "synth_03_doc", "synth_07_table",
           "synth_12_scan", "synth_16_photo")


def _pdf(path, content, resources, objects):
    """One-page PDF: `content` (FlateDecode) under `resources`, with extra
    indirect objects numbered from 4."""
    import zlib
    comp = zlib.compress(content)
    objs = [b"1 0 obj\n<< /Type /Catalog /Pages 2 0 R >>\nendobj\n",
            b"2 0 obj\n<< /Type /Pages /Kids [3 0 R] /Count 1 /MediaBox "
            b"[0 0 612 792] >>\nendobj\n",
            b"3 0 obj\n<< /Type /Page /Parent 2 0 R /Resources << " +
            resources + b" >> /Contents 4 0 R >>\nendobj\n",
            b"4 0 obj\n<< /Length %d /Filter /FlateDecode >>\nstream\n" %
            len(comp) + comp + b"\nendstream\nendobj\n"]
    for i, (head, stream) in enumerate(objects):
        body = head if stream is None else (
            head + b" /Length %d >>\nstream\n" % len(stream) + stream +
            b"\nendstream")
        objs.append(b"%d 0 obj\n" % (5 + i) + body + b"\nendobj\n")
    with open(path, "wb") as f:
        f.write(b"%PDF-1.4\n" + b"".join(objs) + b"%%EOF\n")


def _image_pdf(path, data, w, h, flt, cs, cm, text=b""):
    _pdf(path, b"q " + cm + b" /Im0 Do Q " + text,
         b"/XObject << /Im0 5 0 R >> /Font << /F1 6 0 R >>",
         [(b"<< /Type /XObject /Subtype /Image /Width %d /Height %d "
           b"/ColorSpace %s /BitsPerComponent 8 /Filter %s" %
           (w, h, cs, flt), data),
          (b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>", None)])


def phase_p_inputs(pages, root):
    """Phase P's files in `root`: two held-out pages copied as files, one
    written as a JPEG, a scanned PDF with a /DCTDecode page image, one with
    a /FlateDecode RGB image, one with the committed CMYK JPEG, a vector
    PDF (Tf on the sans, serif and mono faces; Tj, TJ with kerning, ',
    re f), a PDF whose CMYK bitmap is placed rotated (the affine route of
    the rasteriser) beside a text run, and a broken PDF. → the file list
    (the broken PDF last)."""
    import shutil
    import zlib
    from onnxocr_tpu_torch import config
    from onnxocr_tpu_torch.utils import imcodec
    heldout = config.ASSETS.parent / "test_images_heldout"
    os.makedirs(root, exist_ok=True)
    files = [shutil.copy(heldout / f"{n}.png", os.path.join(root, f"{n}.png"))
             for n in P_PAGES[:2]]
    path = os.path.join(root, f"{P_PAGES[2]}.jpg")
    with open(path, "wb") as f:
        f.write(imcodec.imencode_jpeg(pages[P_PAGES[2]], 90))
    files.append(path)
    h, w = pages[P_PAGES[3]].shape[:2]
    path = os.path.join(root, "scan_dct.pdf")
    _image_pdf(path, imcodec.imencode_jpeg(pages[P_PAGES[3]], 90), w, h,
               b"/DCTDecode", b"/DeviceRGB", b"612 0 0 792 0 0 cm")
    files.append(path)
    rgb = np.ascontiguousarray(pages[P_PAGES[4]][:, :, ::-1])
    path = os.path.join(root, "scan_flate.pdf")
    _image_pdf(path, zlib.compress(rgb.tobytes()), rgb.shape[1],
               rgb.shape[0], b"/FlateDecode", b"/DeviceRGB",
               b"612 0 0 792 0 0 cm")
    files.append(path)
    cmyk_path = os.path.join(os.path.dirname(config.__file__), "assets",
                             "samples", "synth_03_doc_cmyk.jpg")
    with open(cmyk_path, "rb") as f:
        cmyk = f.read()
    path = os.path.join(root, "scan_cmyk.pdf")
    _image_pdf(path, cmyk, 680, 900, b"/DCTDecode", b"/DeviceCMYK",
               b"612 0 0 792 0 0 cm")
    files.append(path)
    path = os.path.join(root, "vector.pdf")
    _pdf(path,
         b"q 0.85 0.9 0.95 rg 50 560 500 150 re f Q 0 0 0 rg "
         b"BT /F1 28 Tf 60 680 Td (Quarterly Report 2024) Tj ET "
         b"BT /F2 20 Tf 60 640 Td [(Wa) 90 (ter AV To) -250 (tal 1,234.50)] "
         b"TJ ET BT /F3 16 Tf 18 TL 60 600 Td (Mono 42 == x) Tj "
         b"(second line 7) ' ET BT /F4 22 Tf 60 500 Td (Bold Heading) Tj ET",
         b"/Font << /F1 5 0 R /F2 6 0 R /F3 7 0 R /F4 8 0 R >>",
         [(b"<< /Type /Font /Subtype /Type1 /BaseFont /%s >>" % f, None)
          for f in (b"Helvetica", b"Times-Roman", b"Courier",
                    b"Helvetica-Bold")])
    files.append(path)
    # a bitmap the extractor does not take (DeviceCMYK, Flate): the page
    # goes through the rasteriser, which places it rotated
    page = pages[P_PAGES[5]][:, :, ::-1].astype(np.int32)
    k = 255 - page.max(axis=2, keepdims=True)
    c = np.concatenate([255 - page - k, k], axis=2).clip(0, 255)
    path = os.path.join(root, "rotated.pdf")
    _image_pdf(path, zlib.compress(c.astype(np.uint8).tobytes()),
               page.shape[1], page.shape[0], b"/FlateDecode", b"/DeviceCMYK",
               b"330 60 -45 250 200 120 cm",
               b"BT /F1 26 Tf 60 720 Td (Rotated scan) Tj ET")
    files.append(path)
    path = os.path.join(root, "broken.pdf")
    with open(path, "wb") as f:
        f.write(b"%PDF-1.7\n\xde\xad\xbe\xef trailer garbage")
    files.append(path)
    return files


def _p_run(log, files, stages=None):
    """OCRLogic.run over `files` with the stage boundaries recorded: →
    (all_text, results by page content hash, per-stage ms)."""
    import hashlib
    import threading
    from onnxocr_tpu_torch.batch import logic
    marks = {"ingest": [], "recognize": [], "overlay": []}
    results = {}
    lock = threading.Lock()
    model_ocr = log.model.ocr
    real_ingest, real_page, real_sav = log._ingest, log._ocr_page, \
        logic.sav2Img

    def ocr(img, *a, **kw):
        res = model_ocr(img, *a, **kw)
        with lock:
            results[hashlib.sha1(np.ascontiguousarray(img).tobytes())
                    .hexdigest()] = res[0]
        return res

    def timed_call(key, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            with lock:
                marks[key].append(time.perf_counter())
            return out
        return call

    def sav(*a, **kw):
        t = time.perf_counter()
        real_sav(*a, **kw)
        with lock:
            marks["overlay"].append(time.perf_counter() - t)

    log.model.ocr = ocr
    log._ingest = timed_call("ingest", real_ingest)
    log._ocr_page = timed_call("recognize", real_page)
    logic.sav2Img = sav
    try:
        t0 = time.perf_counter()
        all_text = log.run(files, save_txt=True, merge_txt=True,
                           output_img=True, max_workers=4)
        t1 = time.perf_counter()
    finally:
        log.model.ocr = model_ocr
        del log._ingest, log._ocr_page
        logic.sav2Img = real_sav
    t_ing, t_rec = max(marks["ingest"]), max(marks["recognize"])
    ms = {"ingest": (t_ing - t0) * 1e3, "recognize": (t_rec - t_ing) * 1e3,
          "emit": (t1 - t_rec) * 1e3, "total": (t1 - t0) * 1e3,
          "overlay_ms_per_page": float(np.mean(marks["overlay"])) * 1e3}
    return all_text, results, ms


def _txt_files(root):
    out = {}
    for name in sorted(os.listdir(os.path.join(root, "Output_OCR"))):
        if name.endswith(".txt"):
            with open(os.path.join(root, "Output_OCR", name),
                      encoding="utf-8") as f:
                out[name.rsplit("_ocr_", 1)[0]] = f.read()
    return out


def phase_p(pages, tmp):
    """Path P: batch image/PDF OCR (`OCRLogic(status, device=...).run(
    files, save_txt=True, merge_txt=True, output_img=True)`, 4 workers) on
    phase_p_inputs' files, on the card (once unmeasured, once timed with
    the launch counts set to 0 just before and read just after) and on the
    CPU, with the stand-in dictionary under an ONNXOCR_TPU_ASSETS root and
    the untrained classifier (ONNXOCR_TPU_ALLOW_UNTRAINED=1: OCRLogic
    builds ONNXPaddleOcr(use_angle_cls=True)). Each page's result on the
    card must equal the CPU's by the repo's gate (texts equal, boxes within
    2 px, scores within 2e-3), the txt and merged-txt files must be equal,
    every overlay JPEG must decode at the CPU overlay's size with the text
    panel (its black right border), and the broken PDF must
    be reported as read failed. → (summary, {"P": launches})."""
    import torch
    from onnxocr_tpu_torch.batch import logic
    from onnxocr_tpu_torch.ops.kernels import build
    from onnxocr_tpu_torch.utils import font, imcodec
    root = os.path.join(tmp, "batch_assets")
    os.makedirs(os.path.join(root, "ppocrv5"), exist_ok=True)
    with open(os.path.join(root, "ppocrv5", "ppocrv5_dict.txt"), "w") as f:
        f.write("".join(f"<{i}>\n" for i in range(18383)))
    saved = {k: os.environ.get(k) for k in
             ("ONNXOCR_TPU_ASSETS", "ONNXOCR_TPU_ALLOW_UNTRAINED")}
    os.environ["ONNXOCR_TPU_ASSETS"] = root
    os.environ["ONNXOCR_TPU_ALLOW_UNTRAINED"] = "1"
    # the default dictionary path as it resolves with the assets root set
    # (the defaults resolve at import, before this phase set it)
    from onnxocr_tpu_torch import config
    saved_dict = config.DEFAULTS["rec_char_dict_path"]
    config.DEFAULTS["rec_char_dict_path"] = config.find_asset(
        "ppocrv5/ppocrv5_dict.txt")
    faces = {name: font.dejavu_path(name) for name in (
        "DejaVuSans.ttf", "DejaVuSans-Bold.ttf", "DejaVuSerif.ttf",
        "DejaVuSerif-Bold.ttf", "DejaVuSansMono.ttf",
        "DejaVuSansMono-Bold.ttf")}
    for name, path in faces.items():
        where = "system" if path.startswith(str(font.SYSTEM_FONT_DIR)) \
            else "committed copy"
        print(f"path P font {name}: {where} ({path})")
    t_phase = time.perf_counter()
    try:
        msgs = {"cuda": [], "cpu": []}
        logs = {d: logic.OCRLogic(msgs[d].append, device=d)
                for d in ("cuda", "cpu")}
        runs = {}
        for device, label in (("cuda", "warm"), ("cuda", "timed"),
                              ("cpu", "cpu")):
            files = phase_p_inputs(pages, os.path.join(tmp, f"p_{label}"))
            if label == "timed":
                torch.cuda.synchronize()
                build.LAUNCHES.clear()
            runs[label] = _p_run(logs[device], files)
            if label == "timed":
                torch.cuda.synchronize()
                launches = dict(build.LAUNCHES)
        for lg in logs.values():
            lg.model.close()
    finally:
        config.DEFAULTS["rec_char_dict_path"] = saved_dict
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    text, res, ms = runs["timed"]
    text_cpu, res_cpu, _ = runs["cpu"]
    assert text == text_cpu, "path P: GPU and CPU texts differ"
    assert set(res) == set(res_cpu) and len(res) == 8, sorted(res)
    worst_box = worst_score = 0.0
    for key, got in res.items():
        ref = res_cpu[key]
        assert [l[1][0] for l in got] == [l[1][0] for l in ref]
        for g, r in zip(got, ref):
            worst_box = max(worst_box, float(np.abs(
                np.asarray(g[0]) - np.asarray(r[0])).max()))
            worst_score = max(worst_score, abs(g[1][1] - r[1][1]))
    assert worst_box <= 2.0 and worst_score < 2e-3, (worst_box, worst_score)
    gpu_dir = os.path.join(tmp, "p_timed")
    cpu_dir = os.path.join(tmp, "p_cpu")
    assert _txt_files(gpu_dir) == _txt_files(cpu_dir)
    assert "merged" in _txt_files(gpu_dir)
    overlays = sorted(n for n in os.listdir(os.path.join(gpu_dir,
                                                         "Output_OCR"))
                      if n.endswith(".jpg"))
    assert len(overlays) == 8, overlays
    for name in overlays:
        with open(os.path.join(gpu_dir, "Output_OCR", name), "rb") as f:
            got = imcodec.imdecode(f.read())
        with open(os.path.join(cpu_dir, "Output_OCR", name), "rb") as f:
            want = imcodec.imdecode(f.read())
        assert got is not None and got.shape == want.shape, name
        # the text panel: 600 columns a panel, each ending in a black
        # 1 px border
        assert got.shape[1] > 600 and (got[:, -1] < 96).mean() > 0.9, \
            (name, got.shape)
    for device in ("cuda", "cpu"):
        assert any("read failed" in m and "broken.pdf" in m
                   for m in msgs[device]), device
    assert launches.get("ctc_head_reduce", 0) > 0, \
        "path P: the CTC head never launched"
    n_pages = len(res)
    summary = {
        "files": 9, "pages": n_pages, "workers": 4,
        "pages_per_s": n_pages / (ms["total"] / 1e3),
        "stage_ms": {k: ms[k] for k in ("ingest", "recognize", "emit",
                                        "total")},
        "overlay_ms_per_page": ms["overlay_ms_per_page"],
        "ctc_head_launches_per_page":
            launches.get("ctc_head_reduce", 0) / n_pages,
        "launches": launches,
        "max_box_diff_px": worst_box, "max_score_diff": worst_score,
        "fonts": {k: v for k, v in faces.items()},
        "seconds": time.perf_counter() - t_phase}
    print(f"path P: {n_pages} pages from 9 files (the broken PDF reported) "
          f"in {ms['total']:.1f} ms, {summary['pages_per_s']:.2f} pages/s at "
          f"4 workers; stages ms: ingest {ms['ingest']:.1f}, recognize "
          f"{ms['recognize']:.1f}, emit {ms['emit']:.1f}; overlay (draw + "
          f"JPEG q75) {ms['overlay_ms_per_page']:.1f} ms a page; CTC-head "
          f"launches a page {summary['ctc_head_launches_per_page']:.2f}; "
          f"GPU vs CPU: texts and txt files equal, boxes within "
          f"{worst_box:.2f} px, scores within {worst_score:.1e}")
    return summary, {"P": launches}


# ------------------------------------------------------------ graph export
class _GraphBuilder:
    """Nodes and initializers of one ONNX graph, encoded by the repo's test
    encoder (tests/onnx_builder.py); every value gets a fresh name."""

    def __init__(self):
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tests"))
        import onnx_builder
        self.ob = onnx_builder
        self.nodes, self.inits, self.n = [], {}, 0

    def _name(self, prefix):
        self.n += 1
        return f"{prefix}_{self.n}"

    def const(self, arr, prefix="w"):
        name = self._name(prefix)
        self.inits[name] = np.array(arr)  # C order, 0-d kept 0-d
        return name

    def op(self, op_type, inputs, attrs=None, n_out=1):
        outs = [self._name(op_type.lower()) for _ in range(n_out)]
        self.nodes.append(self.ob.node_bytes(op_type, inputs, outs, attrs))
        return outs[0] if n_out == 1 else outs

    def model(self, inputs, outputs):
        return self.ob.build_model(self.nodes, inputs, outputs, self.inits,
                                   opset=11)


def _f32(v):
    return np.asarray(v, np.float32).reshape(())


def _ex_conv(g, x, p, stride=(1, 1), groups=1):
    """Conv from a tree leaf {w: HWIO, b?}: OIHW kernel, pads k // 2."""
    w = np.asarray(p["w"], np.float32)
    k = w.shape[0]
    ins = [x, g.const(w.transpose(3, 2, 0, 1))]
    if "b" in p:
        ins.append(g.const(np.asarray(p["b"], np.float32)))
    return g.op("Conv", ins, {"kernel_shape": [k, k], "pads": [k // 2] * 4,
                              "strides": list(stride), "group": groups})


def _ex_act(g, x, act):
    if act == "relu":
        return g.op("Relu", [x])
    if act == "hswish":
        return g.op("HardSwish", [x])
    return x


def _ex_bn(g, x, bn):
    return g.op("BatchNormalization", [x] + [
        g.const(np.asarray(bn[k], np.float32))
        for k in ("scale", "bias", "mean", "var")])


def _ex_convbn(g, x, p, stride=(1, 1), groups=1, act="none"):
    """Conv followed by an unfolded BatchNormalization, as PaddleOCR's
    exports write it (the executor folds the pair at load)."""
    return _ex_act(g, _ex_bn(g, _ex_conv(g, x, p["conv"], stride, groups),
                             p["bn"]), act)


def _ex_se(g, x, p):
    s = g.op("GlobalAveragePool", [x])
    s = g.op("Relu", [_ex_conv(g, s, p["reduce"])])
    s = g.op("HardSigmoid", [_ex_conv(g, s, p["expand"])],
             {"alpha": 0.2, "beta": 0.5})
    return g.op("Mul", [x, s])


def _ex_mbv3(g, x, p, cfg_name, scale, taps=()):
    """The MobileNetV3 backbone → the block inputs at `taps` + the last map."""
    from onnxocr_tpu_torch.models import mobilenetv3 as mbv3
    table, _ = mbv3.CONFIGS[cfg_name]
    cin = p["stem"]["conv"]["w"].shape[-1]
    x = _ex_convbn(g, x, p["stem"], (2, 2), act="hswish")
    feats = []
    for i, ((k, exp, cout, se, act, s), blk) in enumerate(
            zip(mbv3.scaled_cfg(table, scale), p["blocks"])):
        if i in taps:
            feats.append(x)
        y = _ex_convbn(g, x, blk["expand"], act=act)
        y = _ex_convbn(g, y, blk["dw"], s, groups=exp, act=act)
        if se:
            y = _ex_se(g, y, blk["se"])
        y = _ex_convbn(g, y, blk["project"])
        if tuple(s) == (1, 1) and cin == cout:
            y = g.op("Add", [y, x])
        x, cin = y, cout
    feats.append(_ex_convbn(g, x, p["last"], act="hswish"))
    return feats


def _ex_upsample(g, x, factor):
    """Nearest Resize by `factor` (paddle2onnx's FPN form)."""
    return g.op("Resize", [x, g.const(np.zeros(0, np.float32), "roi"),
                           g.const(np.array([1, 1, factor, factor],
                                            np.float32), "scales")],
                {"mode": "nearest",
                 "coordinate_transformation_mode": "asymmetric",
                 "nearest_mode": "floor"})


def _ex_conv_t(g, x, p):
    """The DB head's 2x transposed conv: the tree's (2, 2, I, O) kernel,
    flipped on both spatial axes, as ONNX's (I, O, 2, 2)."""
    w = np.asarray(p["w"], np.float32)[::-1, ::-1].transpose(2, 3, 0, 1)
    return g.op("ConvTranspose", [x, g.const(w),
                                  g.const(np.asarray(p["b"], np.float32))],
                {"kernel_shape": [2, 2], "strides": [2, 2]})


def _ex_layer_norm(g, x, p, eps=1e-6):
    """LayerNorm over the last axis as paddle2onnx's opset-11 graphs write
    it: ReduceMean, Sub, Pow, ReduceMean, Add, Sqrt, Div, Mul, Add."""
    mean = g.op("ReduceMean", [x], {"axes": [-1], "keepdims": 1})
    d = g.op("Sub", [x, mean])
    var = g.op("ReduceMean", [g.op("Pow", [d, g.const(_f32(2.0), "c")])],
               {"axes": [-1], "keepdims": 1})
    std = g.op("Sqrt", [g.op("Add", [var, g.const(_f32(eps), "c")])])
    y = g.op("Mul", [g.op("Div", [d, std]),
                     g.const(np.asarray(p["scale"], np.float32))])
    return g.op("Add", [y, g.const(np.asarray(p["bias"], np.float32))])


def _ex_linear(g, x, p):
    y = g.op("MatMul", [x, g.const(np.asarray(p["w"], np.float32))])
    return g.op("Add", [y, g.const(np.asarray(p["b"], np.float32))])


def _ex_gelu_tanh(g, x):
    """0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x³))), jax.nn.gelu's
    default form."""
    c = lambda v: g.const(_f32(v), "c")  # noqa: E731
    inner = g.op("Add", [x, g.op("Mul", [g.op("Pow", [x, c(3.0)]),
                                         c(0.044715)])])
    t = g.op("Tanh", [g.op("Mul", [inner, c(np.sqrt(2.0 / np.pi))])])
    cdf = g.op("Mul", [g.op("Add", [t, c(1.0)]), c(0.5)])
    return g.op("Mul", [x, cdf])


def _ex_attention(g, x, p, dim):
    heads = max(1, dim // 32)
    qkv = _ex_linear(g, x, p["qkv"])
    qkv = g.op("Reshape", [qkv, g.const(np.array(
        [0, -1, 3, heads, dim // heads], np.int64), "shape")])
    qkv = g.op("Transpose", [qkv], {"perm": [2, 0, 3, 1, 4]})
    q, k, v = (g.op("Gather", [qkv, g.const(np.array(i, np.int64), "i")],
                    {"axis": 0}) for i in range(3))
    scores = g.op("MatMul", [q, g.op("Transpose", [k],
                                     {"perm": [0, 1, 3, 2]})])
    scores = g.op("Div", [scores, g.const(_f32(np.sqrt(dim // heads)),
                                          "c")])
    out = g.op("MatMul", [g.op("Softmax", [scores], {"axis": -1}), v])
    out = g.op("Transpose", [out], {"perm": [0, 2, 1, 3]})
    # (N, T, D) from the tensor's own shape: Shape → Gather → Concat
    shape = g.op("Shape", [x])
    nt = g.op("Gather", [shape, g.const(np.array([0, 1], np.int64), "i")],
              {"axis": 0})
    tgt = g.op("Concat", [nt, g.const(np.array([dim], np.int64), "d")],
               {"axis": 0})
    return _ex_linear(g, g.op("Reshape", [out, tgt]), p["proj"])


def export_graph(kind: str, tree) -> bytes:
    """A native tree ('det': the MobileNetV3-large DBNet; 'rec': the SVTR;
    'cls': the MobileNetV3-small-0.35 classifier) as an ONNX graph in
    PaddleOCR's export layout: NCHW, OIHW kernels, each Conv followed by an
    unfolded BatchNormalization, HardSwish / HardSigmoid and SE through
    GlobalAveragePool, nearest Resize in the FPN and ConvTranspose + Sigmoid
    in the DB head; the SVTR pools its height with an AveragePool, writes
    LayerNorm out op by op, GELU in its tanh form, and ends in Softmax. The
    graph computes what the native model computes on the same tree (for
    the DBNet on a canvas without padding)."""
    g = _GraphBuilder()
    if kind == "det":
        from onnxocr_tpu_torch.models import dbnet
        feats = _ex_mbv3(g, "x", tree["backbone"], "large", 0.5,
                         dbnet._TAPS)
        lat = [_ex_conv(g, f, p) for f, p in zip(feats, tree["lateral"])]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = g.op("Add", [lat[i - 1], _ex_upsample(g, lat[i], 2)])
        outs = [_ex_conv(g, f, p) for f, p in zip(lat, tree["smooth"])]
        ups = [o if i == 0 else _ex_upsample(g, o, 2 ** i)
               for i, o in enumerate(outs)]
        h = tree["head"]
        y = _ex_convbn(g, g.op("Concat", ups, {"axis": 1}), h["conv"],
                       act="relu")
        y = g.op("Relu", [_ex_bn(g, _ex_conv_t(g, y, h["up1"]), h["bn1"])])
        out = g.op("Sigmoid", [_ex_conv_t(g, y, h["up2"])])
    elif kind == "rec":
        from onnxocr_tpu_torch.models import svtr
        x = _ex_convbn(g, "x", tree["stem"], (2, 2), act="hswish")
        height = 48 // 2
        for (_, s), st in zip(svtr.STAGES, tree["stages"]):
            cin = st["dw"]["conv"]["w"].shape[-1]
            x = _ex_convbn(g, x, st["dw"], s, groups=cin, act="hswish")
            x = _ex_convbn(g, x, st["pw"], act="hswish")
            height //= s[0]
        x = _ex_convbn(g, x, tree["neck"], act="hswish")
        x = g.op("AveragePool", [x], {"kernel_shape": [height, 2],
                                      "strides": [height, 2]})
        x = g.op("Squeeze", [x], {"axes": [2]})
        x = g.op("Transpose", [x], {"perm": [0, 2, 1]})
        dim = tree["head"]["w"].shape[0]
        for blk in tree["mixer"]:
            x = g.op("Add", [x, _ex_attention(
                g, _ex_layer_norm(g, x, blk["ln1"]), blk, dim)])
            y = _ex_gelu_tanh(g, _ex_linear(
                g, _ex_layer_norm(g, x, blk["ln2"]), blk["fc1"]))
            x = g.op("Add", [x, _ex_linear(g, y, blk["fc2"])])
        out = g.op("Softmax", [_ex_linear(g, x, tree["head"])], {"axis": 2})
    elif kind == "cls":
        f = _ex_mbv3(g, "x", tree["backbone"], "small", 0.35)[-1]
        f = g.op("MaxPool", [f], {"kernel_shape": [2, 2], "strides": [2, 2]})
        f = g.op("Flatten", [g.op("GlobalAveragePool", [f])], {"axis": 1})
        out = g.op("Softmax", [_ex_linear(g, f, tree["fc"])], {"axis": 1})
    else:
        raise ValueError(f"unknown graph kind {kind!r}")
    return g.model(["x"], [out])


GRAPH_PAGES = (PAGES[0], PAGES[2])


def _host_and_device_ms(fn, iters=10):
    """(host ms a call: the time `fn` takes to return, its ops enqueued;
    device ms a call by CUDA events) after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    host = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    end.record()
    torch.cuda.synchronize()
    return float(np.mean(host)), start.elapsed_time(end) / iters


def phase_g(model, pages, tmp):
    """Path G, the graph backend on the card (`tpu_backend='auto'` over a
    user's det.onnx / rec.onnx / cls.onnx): the committed v5 det and rec
    checkpoints and the seeded classifier exported as full-width ONNX
    graphs (`export_graph`) into a model tree; the executor against the
    native models on the same weights (det at a 960² canvas without
    padding, rec probabilities at 16 × 640, max abs err ≤ 1e-4), the det
    graph forward making no device→host copy; the lifted classifier equal
    to its source tree; and four pipeline forms on two held-out pages,
    each against the same port on the CPU, with their kernels counted:
    C (graph det + graph rec + the lifted classifier, staged bitmap wire),
    C′ (graph det + native rec: kernel 1), B (one-call: kernels 2–3) and A
    (staged device-det, `pallas`: kernels 4–5) → (summary, launches by
    form)."""
    import torch
    from onnxocr_tpu_torch import config
    from onnxocr_tpu_torch.models import cls as cls_model
    from onnxocr_tpu_torch.models import convert, lift
    from onnxocr_tpu_torch.onnx import ir
    from onnxocr_tpu_torch.onnx.executor import GraphExecutor
    from onnxocr_tpu_torch.ops import resize_dev
    from onnxocr_tpu_torch.pipeline.detector import GraphDBNet
    from onnxocr_tpu_torch.utils.params_io import load_tree

    t_start = time.perf_counter()
    trees = {k: load_tree(config.find_asset(f"ppocrv5/{k}/native_params.npz"))
             for k in ("det", "rec")}
    trees["cls"] = cls_model.init_tree(0)
    paths, nodes, folded, raw_nodes = {}, {}, {}, {}
    for kind, tree in trees.items():
        blob = export_graph(kind, tree)
        d = os.path.join(tmp, "graph", kind)
        os.makedirs(d, exist_ok=True)
        paths[kind] = os.path.join(d, f"{kind}.onnx")
        with open(paths[kind], "wb") as f:
            f.write(blob)
        ex = GraphExecutor(ir.parse_model(blob), device="cpu")
        nodes[kind], folded[kind] = len(ex.nodes), ex.folded_bn
        raw_nodes[kind] = len(ir.parse_model(blob).graph.nodes)
        print(f"path G: {kind} graph {len(blob) / 2**20:.1f} MiB, "
              f"{raw_nodes[kind]} nodes, {folded[kind]} BNs folded → "
              f"{nodes[kind]} nodes run")
    lifted = convert.flatten(lift.lift_cls(ir.load_model(paths["cls"])))
    src = convert.flatten(trees["cls"])
    assert set(lifted) == set(src) and all(
        lifted[k].dtype == src[k].dtype and np.array_equal(lifted[k], src[k])
        for k in src), "path G: lift_cls is not the exported tree"
    print(f"path G: lift_cls of the exported classifier equals "
          f"init_tree(0) on all {len(src)} leaves")

    # the executor against the native models on the same weights
    dev = torch.device("cuda")
    det_graph = GraphDBNet(paths["det"], dev)
    det_native = convert.build_dbnet(trees["det"], dev)
    image, h, w = resize_dev.put_src_bucket(pages[GRAPH_PAGES[0]], dev)
    x = resize_dev.resize_normalize_det(image, h, w, 960, 960, 960, 960)
    x = x.permute(2, 0, 1)[None].contiguous()
    with torch.inference_mode():
        det_err = float((det_graph(x) - det_native(x)).abs().max())
        rec_ex = GraphExecutor(paths["rec"], name="rec", device=dev)
        rec_native = convert.build_svtr(trees["rec"], dev)
        crops = torch.from_numpy(np.random.default_rng(7).uniform(
            -1, 1, (16, 3, 48, 640)).astype(np.float32)).to(dev)
        rec_err = float((rec_ex({"x": crops})[0] - torch.softmax(
            rec_native(crops), -1)).abs().max())
    print(f"path G: det graph vs native DBNet at 960², max abs err "
          f"{det_err:.2e}; rec graph vs softmax(native SVTR) at 16 × 640, "
          f"{rec_err:.2e}")
    assert det_err <= 1e-4 and rec_err <= 1e-4, "path G: graph ≠ native"
    with torch.inference_mode():
        det_copies = device_counts(lambda: det_graph(x))
    print(f"path G: a det graph forward puts {det_copies}")
    assert det_copies["memcpys"] == 0, \
        "path G: the det graph forward copies to or from the host"
    with torch.inference_mode():
        fwd = {}
        for name, fn in (
                ("det_graph", lambda: det_graph(x)),
                ("det_native", lambda: det_native(x)),
                ("rec_graph", lambda: rec_ex({"x": crops})),
                ("rec_native", lambda: torch.softmax(rec_native(crops), -1))):
            fwd[name + "_host_ms"], fwd[name + "_ms"] = \
                _host_and_device_ms(fn)
    print("path G forwards: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(fwd.items())))

    # the pipeline forms, each against the same port on the CPU
    v5_rec = config.find_asset("ppocrv5/rec/rec.onnx")
    base = dict(det_model_dir=paths["det"], rec_model_dir=paths["rec"],
                cls_model_dir=paths["cls"])
    kernels = ("ctc_head_reduce", "label_moment_sums", "label_proj_extents",
               "seg_sum_bands", "seg_min_bands")
    forms = (
        ("G-C", dict(base, use_angle_cls=True), True, ()),
        ("G-C'", dict(base, rec_model_dir=v5_rec), False,
         ("ctc_head_reduce",)),
        ("G-B", dict(base, tpu_pipeline="onecall"), False,
         ("label_moment_sums", "label_proj_extents")),
        ("G-A", dict(base, use_angle_cls=True, tpu_det_postprocess="device",
                     tpu_db_reduce="pallas"), True,
         ("seg_sum_bands", "seg_min_bands")))
    runs, page_ms, box_err = {}, {}, {}
    for label, kw, cls, needs in forms:
        gpu = model("cuda", **kw)
        assert gpu.text_detector.backend == "graph"
        assert gpu.text_recognizer.forward.backend == (
            "native" if label == "G-C'" else "graph")
        if cls:
            assert gpu.text_classifier.forward.backend == "native"
        times = []
        results, launches = drive(gpu, pages, GRAPH_PAGES, cls, label, times)
        for name in kernels:
            assert (launches.get(name, 0) > 0) == (name in needs), \
                f"path {label}: {name} launched {launches.get(name, 0)}"
        cpu = model("cpu", **kw)
        box_err[label] = max(_close_results(
            results[name], cpu.ocr(pages[name], cls=cls)[0], label)
            for name in GRAPH_PAGES)
        print(f"path {label}: GPU and CPU agree on {len(GRAPH_PAGES)} pages "
              f"(boxes within {box_err[label]:.1f} px)")
        runs[label], page_ms[label] = launches, float(np.mean(times))
        gpu.close()
    summary = {"nodes": nodes, "raw_nodes": raw_nodes, "folded_bn": folded,
               "det_max_abs_err": det_err, "rec_max_abs_err": rec_err,
               "det_forward_device_ops": det_copies, "forward_ms": fwd,
               "page_ms": page_ms, "box_err_px": box_err,
               "launches": runs,
               "seconds": time.perf_counter() - t_start}
    print(f"phase G {summary['seconds']:.1f} s")
    return summary, runs


# ------------------------------------------------------------ phase T
TRAIN_STEPS = 20
TRAIN_LR = 1e-3
# the loss of a step's fixed batch after TRAIN_STEPS steps must be at most
# this share of the first step's
TRAIN_DROP = 0.7


def det_train_batch(b, hw=320, seed=0):
    """Seeded det batch: light pages with 3–6 dark filled rectangles,
    ImageNet-normalized (B, hw, hw, 3); shrink maps the rectangles shrunk
    by a quarter of their height on each side; full shrink masks."""
    from onnxocr_tpu_torch.ops import det_pre
    rng = np.random.default_rng(seed)
    img = np.full((b, hw, hw, 3), 0.9, np.float32)
    maps = np.zeros((b, hw, hw), np.float32)
    for i in range(b):
        for _ in range(rng.integers(3, 7)):
            h, w = rng.integers(12, 40), rng.integers(40, 200)
            y, x = rng.integers(0, hw - h), rng.integers(0, hw - w)
            img[i, y:y + h, x:x + w] = rng.uniform(0.0, 0.3)
            s = max(2, h // 4)
            maps[i, y + s:y + h - s, x + s:x + w - s] = 1.0
    img += rng.normal(0.0, 0.03, img.shape).astype(np.float32)
    img = (img - det_pre.IMAGENET_MEAN) / det_pre.IMAGENET_STD
    return img.astype(np.float32), maps, np.ones_like(maps)


def rec_train_batch(b, vocab, width=320, seed=0, max_len=15):
    """Seeded rec batch: (B, 48, width, 3) crops in [−1, 1], labels of 5–15
    classes in 1..vocab−1 right-padded with 0 (at most 29 steps with
    repeats: feasible for the SVTR's 40 and the CRNN's 80), paddings, and
    valid token counts in [30, width / 8]."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (b, 48, width, 3)).astype(np.float32)
    lens = rng.integers(5, max_len + 1, b)
    labels = np.zeros((b, max_len), np.int32)
    for i, n in enumerate(lens):
        labels[i, :n] = rng.integers(1, vocab, n)
    pads = (np.arange(max_len)[None] >= lens[:, None]).astype(np.float32)
    valid_t = rng.integers(30, width // 8 + 1, b).astype(np.int32)
    return images, labels, pads, valid_t


def _tree_np(model, grads=False):
    from onnxocr_tpu_torch.models import convert
    from onnxocr_tpu_torch.utils.params_io import flatten
    return {k: np.asarray(v, np.float32)
            for k, v in flatten(convert.tree_from_model(model, grads)).items()}


def step_record(step, model, batch, tree=None):
    """One step → {"loss", "grads", "p0", "p1"} (numpy trees)."""
    tree = tree or (lambda grads=False: _tree_np(model, grads))
    p0 = tree()
    loss = float(step(model, *batch))
    return {"loss": loss, "grads": tree(grads=True), "p0": p0, "p1": tree()}


def check_step(got, ref, label):
    """One AdamW step of the port on the card (`got`) against the CPU's
    (`ref`) with the tolerances of tests/test_torch_train.py: loss relative
    1e-5, gradients max |dg| / max |g| 1e-4, each element's update / lr
    within what its gradient difference explains (Adam's first update is
    g / (|g| + eps): 2 |dg| / (max |g| + eps), at most 2) plus 4 spacings
    of the parameter and 1e-4. → the figures."""
    rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    assert rel <= 1e-5, f"{label}: loss {got['loss']} vs {ref['loss']}"
    gmax = max(np.abs(v).max() for v in ref["grads"].values())
    gerr = max(np.abs(got["grads"][k] - v).max()
               for k, v in ref["grads"].items())
    assert gerr <= 1e-4 * gmax, f"{label}: gradients {gerr} of {gmax}"
    worst = 0.0
    for k, v0 in ref["p0"].items():
        assert np.array_equal(got["p0"][k], v0), f"{label}: init {k}"
        du = np.abs((got["p1"][k] - v0) - (ref["p1"][k] - v0)) / TRAIN_LR
        g, gc = ref["grads"][k], got["grads"][k]
        bound = np.minimum(2.0, 2.0 * np.abs(gc - g) /
                           (np.maximum(np.abs(g), np.abs(gc)) + 1e-8))
        spacing = np.spacing(np.maximum(np.abs(v0), np.abs(ref["p1"][k])))
        excess = du - bound - 4 * spacing / TRAIN_LR - 1e-4
        assert excess.max() <= 0, f"{label}: update of {k}"
        worst = max(worst, float(du.max()))
    return {"loss_rel": rel, "grad_rel": float(gerr / gmax),
            "max_update_diff": worst}


def train_loop(step, model, batch, label):
    """TRAIN_STEPS steps on one fixed batch already on the card: ms a step
    (CUDA events around the loop), peak MiB, first and last loss."""
    import torch
    step(model, *batch)                      # first use of every shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [step(model, *batch) for _ in range(TRAIN_STEPS)]
    end.record()
    torch.cuda.synchronize()
    losses = [float(v) for v in losses]
    out = {"ms_a_step": start.elapsed_time(end) / TRAIN_STEPS,
           "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
           "loss_first": losses[0], "loss_last": losses[-1]}
    assert all(np.isfinite(losses)), f"{label}: loss {losses}"
    assert losses[-1] <= TRAIN_DROP * losses[0], \
        f"{label}: loss {losses[0]} → {losses[-1]} in {TRAIN_STEPS} steps"
    print(f"phase T {label}: {out['ms_a_step']:.2f} ms a step, peak "
          f"{out['peak_mib']:.0f} MiB, loss {losses[0]:.4f} → "
          f"{losses[-1]:.4f} in {TRAIN_STEPS} steps")
    return out


def ctc_loss_ms(shape, labels, pads):
    """ms of the CTC loss's forward + backward alone at a step's logits
    shape (B, T, V) on seeded logits (CUDA events): the port's loss (optax's
    recursion) and F.ctc_loss (the library's fused kernel, inf on an
    infeasible label) on the same feasible labels."""
    import torch
    import torch.nn.functional as F
    from onnxocr_tpu_torch.train import rec_trainer
    g = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn(*shape, device="cuda", generator=g,
                         requires_grad=True)
    lab = torch.as_tensor(labels, device="cuda")
    pad = torch.as_tensor(pads, device="cuda")
    steps = torch.full((shape[0],), shape[1], device="cuda")
    lens = (1 - pad).sum(1).long()

    def ours():
        rec_trainer.ctc_loss(logits, lab, pad).mean().backward()

    def library():
        F.ctc_loss(torch.log_softmax(logits, -1).transpose(0, 1), lab.long(),
                   steps, lens, reduction="none").mean().backward()

    return {"ms": timed(ours, iters=5), "library_ms": timed(library, iters=5)}


def phase_t(model, pages, tmp):
    """Phase T, the trainers at full width with TF32 off, from the
    committed checkpoints (seeded batches; `det_train_batch`,
    `rec_train_batch`): a DB step (the v5 MobileNetV3 DBNet, batch 16 ×
    320²), a distillation step (the server ResNet18-vd student, the v5
    DBNet teacher), an SVTR CTC step (v5, vocab 18385, batch 32 × 48 × 320,
    valid_t) and a CRNN CTC step (server, vocab 6625, batch 16 × 48 × 320).
    Each: one step on the card held against the same step of the port on
    the CPU (on the first 4 images / 8 crops of the batch, `check_step`),
    then TRAIN_STEPS steps on the whole batch (ms a step, peak MiB, the
    loss falling to TRAIN_DROP of its first value; for the CTC steps the
    loss's own ms, `ctc_loss_ms`). The sharded SVTR step
    on `make_mesh()` (1 × 1) and on a 2 × 5 mesh over cuda:0 repeated (the
    v5 vocabulary splits 5 ways, not 2), each held against the unsharded
    step. Then the trained SVTR is saved with
    `save_tree`, served by ONNXPaddleOcr(rec_model_dir=...) on path C, and
    one page read with the launch counts set to 0: kernel 1 must launch, on
    the head operand split from the trained head. → (summary, {"T":
    launches})."""
    import torch
    from onnxocr_tpu_torch import config
    from onnxocr_tpu_torch.models import convert
    from onnxocr_tpu_torch.parallel import mesh
    from onnxocr_tpu_torch.train import det_trainer, optim, rec_trainer
    from onnxocr_tpu_torch.utils.params_io import load_tree, save_tree
    a = config.ASSETS
    trees = {k: load_tree(str(a / k / "native_params.npz")) for k in (
        "ppocrv5/det", "ppocrv5/rec", "ch_ppocr_server_v2.0/det",
        "ch_ppocr_server_v2.0/rec")}

    def fresh(build, tree, dev, **kw):
        m = build(tree, dev, **kw)
        return m, optim.adamw(optim.trainable(m), TRAIN_LR, weight_decay=1e-5)

    def on(batch, dev):
        return tuple(torch.as_tensor(v, device=dev) for v in batch)

    summary = {}
    det_b = det_train_batch(16)
    rec_v5 = rec_train_batch(32, 18385)
    rec_srv = rec_train_batch(16, 6625, seed=1)[:3]
    teacher = {d: convert.build_dbnet(trees["ppocrv5/det"], d)
               for d in ("cuda", "cpu")}
    cases = (
        ("db", convert.build_dbnet, "ppocrv5/det", {},
         lambda opt, d: det_trainer.make_train_step(opt, device=d), det_b, 4),
        ("distill", convert.build_dbnet, "ch_ppocr_server_v2.0/det",
         {"arch": "resnet18"},
         lambda opt, d: (lambda m, *b, s=det_trainer.make_distill_step(
             opt, device=d): s(m, teacher[d], *b)), det_b, 4),
        ("svtr_ctc", convert.build_svtr, "ppocrv5/rec", {},
         lambda opt, d: rec_trainer.make_train_step(opt, device=d), rec_v5,
         8),
        ("crnn_ctc", convert.build_crnn, "ch_ppocr_server_v2.0/rec", {},
         lambda opt, d: rec_trainer.make_train_step(opt, device=d), rec_srv,
         8))
    trained_svtr = None
    for label, build, key, kw, make, batch, n_cmp in cases:
        small = tuple(v[:n_cmp] for v in batch)
        m_gpu, o_gpu = fresh(build, trees[key], "cuda", **kw)
        m_cpu, o_cpu = fresh(build, trees[key], "cpu", **kw)
        got = step_record(make(o_gpu, "cuda"), m_gpu, on(small, "cuda"))
        ref = step_record(make(o_cpu, "cpu"), m_cpu, small)
        figures = check_step(got, ref, f"phase T {label}")
        print(f"phase T {label}: one step on the card vs the CPU (batch "
              f"{n_cmp}): loss rel {figures['loss_rel']:.2e}, gradients "
              f"{figures['grad_rel']:.2e} of the largest, max update diff "
              f"{figures['max_update_diff']:.3g} lr")
        m_gpu, o_gpu = fresh(build, trees[key], "cuda", **kw)
        summary[label] = dict(train_loop(make(o_gpu, "cuda"), m_gpu,
                                         on(batch, "cuda"), label),
                              batch=int(batch[0].shape[0]),
                              card_vs_cpu=figures)
        if label.endswith("_ctc"):
            steps = batch[0].shape[2] // (8 if label == "svtr_ctc" else 4)
            vocab = 18385 if label == "svtr_ctc" else 6625
            loss_ms = ctc_loss_ms((batch[0].shape[0], steps, vocab),
                                  batch[1], batch[2])
            summary[label]["ctc_loss_ms"] = loss_ms
            print(f"phase T {label}: the CTC loss alone, forward + "
                  f"backward: {loss_ms['ms']:.2f} ms (F.ctc_loss "
                  f"{loss_ms['library_ms']:.2f})")
        if label == "svtr_ctc":
            trained_svtr = m_gpu
        del m_gpu, o_gpu, m_cpu, o_cpu
    # the dp × tp step: 1 × 1 on make_mesh(), 2 × 5 over cuda:0 repeated
    images, labels, pads, _ = rec_v5
    shard_b = (images[:8], labels[:8], pads[:8])
    m_ref, o_ref = fresh(convert.build_svtr, trees["ppocrv5/rec"], "cuda")
    ref = step_record(rec_trainer.make_train_step(o_ref, device="cuda"),
                      m_ref, on(shard_b, "cuda"))
    # the v5 vocabulary, 18385 = 5 × 3677, splits 5 ways, not 2 (JAX's
    # NamedSharding refuses an uneven split too)
    for name, grid in (("1x1", mesh.make_mesh()),
                       ("2x5", mesh.make_mesh(10, 5, ["cuda:0"] * 10))):
        m, _ = fresh(convert.build_svtr, trees["ppocrv5/rec"], "cuda")
        placed = mesh.shard_rec_params(m, grid)
        opt = optim.adamw(placed.parameters(), TRAIN_LR, weight_decay=1e-5)
        step = rec_trainer.make_sharded_train_step(grid, opt)

        def tree(grads=False, placed=placed):
            from onnxocr_tpu_torch.utils.params_io import flatten
            if not grads:
                t = placed.tree()
            else:
                t = convert.tree_from_model(placed.body[0], grads=True)
                t["head"] = {
                    "w": torch.cat([p.grad for p in placed.head_w.shards[0]],
                                   1).cpu().numpy(),
                    "b": torch.cat([p.grad for p in placed.head_b.shards[0]]
                                   ).cpu().numpy()}
            return {k: np.asarray(v, np.float32)
                    for k, v in flatten(t).items()}

        got = step_record(step, placed, shard_b, tree=tree)
        figures = check_step(got, ref, f"phase T sharded {name}")
        for (i, j), t in np.ndenumerate(placed.head_w.shards):
            assert t.device == torch.device(grid.devices[i, j]), name
        summary[f"sharded_{name}"] = figures
        print(f"phase T sharded step on a {name} mesh vs the unsharded "
              f"step (batch 8): loss rel {figures['loss_rel']:.2e}, "
              f"gradients {figures['grad_rel']:.2e}, max update diff "
              f"{figures['max_update_diff']:.3g} lr")
    # serve the trained SVTR
    rec_dir = os.path.join(tmp, "trained", "rec")
    save_tree(os.path.join(rec_dir, "native_params.npz"),
              convert.tree_from_model(trained_svtr))
    ocr = model("cuda", rec_model_dir=os.path.join(rec_dir, "rec.onnx"))
    head = ocr.text_recognizer.forward.model.head
    want = trained_svtr.head.w.detach().half().float()
    assert torch.equal(head.w, want), "the served head is not the trained one"
    assert not torch.equal(head.w, torch.as_tensor(
        trees["ppocrv5/rec"]["head"]["w"], device=head.w.device))
    assert torch.equal((head.w_split[0] + head.w_split[1]).t(), head.w)
    _, launches = drive(ocr, pages, PAGES[:1], False, "T")
    assert launches.get("ctc_head_reduce", 0) > 0, \
        "phase T: the trained SVTR's page launched no CTC head"
    return summary, {"T": launches}


# ------------------------------------------------------------ phase BF
BF_PAGE = PAGES[2]


def phase_bf(model, f32_models, pages):
    """Phase BF, bfloat16 compute (`tpu_dtype='bfloat16'`, TF32 off): paths
    C, B and A, one held-out page each (BF_PAGE) driven as `drive` does,
    the launch counts set to 0 before the counted pass (kernel 1 on each,
    kernels 2–3 on B, 4–5 on A), the page held against the port on the CPU
    in bfloat16 (`same_result`: texts equal, boxes within 2 px), and the
    page's ms timed against the float32 model of the same path, in turns
    (f32, bf16, bf16, f32). → (summary, {"BF-<path>": launches})."""
    import torch
    kw_b = dict(tpu_pipeline="onecall", use_angle_cls=False)
    kw_a = dict(tpu_pipeline="staged", tpu_det_postprocess="device",
                tpu_db_reduce="pallas", use_angle_cls=True,
                tpu_allow_untrained=True)
    slot_keyed = ("ctc_head_reduce", "seg_sum_bands", "seg_min_bands")
    label_keyed = ("ctc_head_reduce", "label_moment_sums",
                   "label_proj_extents")
    summary, runs = {}, {}
    img = pages[BF_PAGE]
    for label, kw, cls, needs in (("C", {}, False, ("ctc_head_reduce",)),
                                  ("B", kw_b, False, label_keyed),
                                  ("A", kw_a, True, slot_keyed)):
        gpu = model("cuda", tpu_dtype="bfloat16", **kw)
        assert next(gpu.text_detector.model.parameters()).dtype == \
            torch.bfloat16
        results, launches = drive(gpu, pages, [BF_PAGE], cls, f"BF-{label}")
        for name in needs:
            assert launches.get(name, 0) > 0, \
                f"path BF-{label}: {name} never launched"
        cpu = model("cpu", tpu_dtype="bfloat16", **kw)
        same_result(results[BF_PAGE], cpu.ocr(img, cls=cls)[0])
        ms = {"float32": [], "bfloat16": []}
        for dt, m in (("float32", f32_models[label]), ("bfloat16", gpu),
                      ("bfloat16", gpu), ("float32", f32_models[label])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.ocr(img, cls=cls)
            torch.cuda.synchronize()
            ms[dt].append((time.perf_counter() - t0) * 1e3)
        summary[label] = {"ms_a_page": {k: float(np.mean(v))
                                        for k, v in ms.items()},
                          "boxes": len(results[BF_PAGE]),
                          "launches": launches}
        runs[f"BF-{label}"] = launches
        print(f"path BF-{label} page {BF_PAGE}: bfloat16 agrees with the "
              f"CPU's bfloat16 ({len(results[BF_PAGE])} boxes); ms a page "
              f"bfloat16 {summary[label]['ms_a_page']['bfloat16']:.1f} vs "
              f"float32 {summary[label]['ms_a_page']['float32']:.1f}")
    return summary, runs


M_DET_PAGES = PAGES[:5]
M_ONECALL_PAGES = PAGES[:4]
M_REQUESTS = 24
# the stages the JAX package's pipeline/system.py opens on one page of
# each route (C: the staged bitmap wire, B: one-call, A: the staged device
# det postprocess with the fused cls + rec pass)
JAX_STAGES = {"C": ("cls_rec_fused", "det", "img_upload"),
              "B": ("onecall",),
              "A": ("cls_rec_fused", "det", "img_upload")}


def _rate(fn, n_items, calls=3):
    """Items a second of `fn` on the card: one unmeasured call, then
    `calls` calls between two synchronisations."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return n_items * calls / (time.perf_counter() - t0)


def _system_order(boxes, rec_res, drop_score):
    """A one-call page's decoded (boxes, results) as ocr() returns them:
    sorted_boxes order, drop_score applied."""
    from onnxocr_tpu_torch.pipeline.system import _sorted_pair_order
    order = _sorted_pair_order(boxes)
    return [[boxes[i].tolist(), rec_res[i]] for i in order
            if rec_res[i][1] >= drop_score]


def _row_launches(fn):
    """Run fn() while recording for which mesh row (mesh.current_row) each
    kernel launched → (fn's result, {kernel: [rows]})."""
    from onnxocr_tpu_torch.ops.kernels import build
    from onnxocr_tpu_torch.parallel.mesh import current_row
    seen = {}
    real = build.count_launch

    def spy(name):
        seen.setdefault(name, []).append(current_row())
        real(name)

    build.count_launch = spy
    try:
        return fn(), seen
    finally:
        build.count_launch = real


def _kernels_by_device(fn):
    """Kernel launches of fn() on each CUDA device, from torch.profiler →
    {device index: {kernel name: count}} for the port's kernels."""
    import torch
    names = ("ctc_head_partial", "moment_sums_kernel", "proj_extents_kernel")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for n in names:
                if n in e.name:
                    d = out.setdefault(int(e.device_index), {})
                    d[n] = d.get(n, 0) + 1
    return out


def _m_mesh(label, m, ocr_b, ocr_off, pages, crops, canv):
    """Phase M on one mesh: ShardedDetBatch, ShardedRecBatch and
    sharded_batch_fn against their one-device forms → summary."""
    import torch
    from onnxocr_tpu_torch.ops import ctc, det_pre, resize_dev
    from onnxocr_tpu_torch.ops.kernels import build
    from onnxocr_tpu_torch.parallel import serving
    n_rows = m.shape["data"]
    devices = sorted({str(d) for d in m.devices.flat})
    det_model = ocr_b.text_detector.model
    rec_model = ocr_b.text_recognizer.forward.model
    out = {"mesh": list(m.devices.shape), "devices": devices}

    # det: 5 pages on the 960² canvas, padded to a multiple of the rows
    pages_u8, rhw = canv
    det = serving.ShardedDetBatch(det_model, m)
    got = det(pages_u8, rhw)

    def plain_det():
        # the one-device form of the same call, host pages uploaded
        x = det_pre.normalize_det(torch.from_numpy(pages_u8).cuda())
        ext = torch.from_numpy(rhw).cuda()
        return det_model(x.permute(0, 3, 1, 2),
                         valid_hw=(ext[:, 0], ext[:, 1]))

    with torch.inference_mode():
        ref = plain_det()
    err = float((got.to(ref.device) - ref).abs().max())
    assert err <= 1e-4, f"phase M {label}: sharded det differs by {err}"
    n = len(pages_u8)
    out["det"] = {"pages": n, "max_abs_err": err,
                  "pages_per_s": _rate(lambda: det(pages_u8, rhw), n),
                  "pages_per_s_one_device": _rate(plain_det, n)}
    det.close()

    # rec: 64 crops of 48 × 640, full logits + ctc_reduce_logits
    rec = serving.ShardedRecBatch(rec_model, m)
    idx, prob = rec(crops)
    def plain_rec():
        xc = torch.from_numpy(crops).cuda().permute(0, 3, 1, 2)
        return ctc.ctc_reduce_logits(rec_model(xc).float())

    with torch.inference_mode():
        logits = rec_model(torch.from_numpy(crops).cuda().permute(
            0, 3, 1, 2)).float()
        ref_idx, ref_prob = ctc.ctc_reduce_logits(logits)
    idx, prob = idx.to(ref_idx.device), prob.to(ref_idx.device)
    differ = idx != ref_idx
    if differ.any():   # only where the top two logits tie within 1e-5
        gap = logits.amax(-1) - logits.gather(
            -1, idx.long()[..., None])[..., 0]
        assert float(gap[differ].max()) <= 1e-5, \
            f"phase M {label}: sharded rec argmax differs"
    perr = float((prob - ref_prob).abs().max())
    assert perr <= 1e-5, f"phase M {label}: rec prob differs by {perr}"
    out["rec"] = {"crops": len(crops), "argmax_differ": int(differ.sum()),
                  "prob_max_abs_err": perr,
                  "crops_per_s": _rate(lambda: rec(crops), len(crops)),
                  "crops_per_s_one_device": _rate(plain_rec, len(crops))}
    rec.close()

    # one-call: 4 pages, each row's step_wave on its own thread
    oc = ocr_b._onecall
    ups = [resize_dev.put_src_bucket(pages[nm], "cuda")
           for nm in M_ONECALL_PAGES]
    images = torch.stack([u[0] for u in ups])
    sh, sw = [u[1] for u in ups], [u[2] for u in ups]
    cv = [oc.canvas(h, w) for h, w in zip(sh, sw)]
    rh, rw = [c[0][0] for c in cv], [c[0][1] for c in cv]
    (hb, wb), _ = cv[0][1:]
    fn = oc.sharded_batch_fn(True, m)
    fn(images, sh, sw, rh, rw)          # unmeasured (first use of shapes)
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    packed, rows_of = _row_launches(lambda: fn(images, sh, sw, rh, rw))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    by_device = _kernels_by_device(lambda: fn(images, sh, sw, rh, rw))
    packed = packed.cpu().numpy()
    use_cls = oc.use_cls(True)
    lines = 0
    for b, nm in enumerate(M_ONECALL_PAGES):
        boxes, res = oc.decode_packed(packed[b], ups[b][0], use_cls)
        got = _system_order(boxes, res, ocr_b.drop_score)
        same_result(got, ocr_off.ocr(pages[nm], cls=False)[0])
        lines += len(got)
    for k in ("ctc_head_reduce", "label_moment_sums", "label_proj_extents"):
        rows_seen = set(rows_of.get(k, []))
        assert rows_seen == set(range(n_rows)), \
            f"phase M {label}: {k} launched on rows {sorted(rows_seen)}"
        assert launches.get(k, 0) >= n_rows
    for d in {torch.device(dv).index or 0 for dv in m.devices.flat}:
        assert by_device.get(d, {}).get("ctc_head_partial", 0) >= 1, \
            f"phase M {label}: no CTC head on cuda:{d} ({by_device})"
    n = len(M_ONECALL_PAGES)
    out["onecall"] = {
        "pages": n, "lines": lines, "launches": launches,
        "kernels_by_device": {str(k): v for k, v in by_device.items()},
        "pages_per_s": _rate(lambda: fn(images, sh, sw, rh, rw).cpu(), n),
        "pages_per_s_one_device": _rate(lambda: oc.step_wave(
            images, sh, sw, rh, rw, hb, wb, 0, 0, use_cls).cpu(), n)}
    fn.rows.close()
    print(f"phase M {label} ({m.devices.shape[0]} x {m.devices.shape[1]} "
          f"over {devices}): det {out['det']['pages']} pages max abs err "
          f"{err:.2e}, "
          f"{out['det']['pages_per_s']:.1f} pages/s vs one device "
          f"{out['det']['pages_per_s_one_device']:.1f}; rec {len(crops)} crops "
          f"argmax equal ({out['rec']['argmax_differ']} ties differ), prob "
          f"{perr:.2e}, {out['rec']['crops_per_s']:.0f} crops/s vs "
          f"{out['rec']['crops_per_s_one_device']:.0f}; one-call "
          f"{n} pages equal path B's ({lines} lines), "
          f"{out['onecall']['pages_per_s']:.1f} pages/s vs step_wave "
          f"{out['onecall']['pages_per_s_one_device']:.1f}; launches "
          f"{launches} by device {by_device}")
    return out, launches


def _m_engine(m, pages, tmp):
    """The serving engine with the det page batch on the mesh:
    MODEL_CONCURRENCY=8, DET_BATCH=1, 24 requests from 8 threads, against
    the same engine's model with the maps wave on one device (the route
    the mesh's maps wave takes) → summary."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from onnxocr_tpu_torch import ONNXPaddleOcr
    from onnxocr_tpu_torch.service import engine as engine_mod
    from onnxocr_tpu_torch.service.settings import settings
    root = os.path.join(tmp, "m_assets")
    os.makedirs(os.path.join(root, "ppocrv5"), exist_ok=True)
    with open(os.path.join(root, "ppocrv5", "ppocrv5_dict.txt"), "w") as f:
        f.write("".join(f"<{i}>\n" for i in range(18383)))
    keys = ("ONNXOCR_TPU_ASSETS", "ONNXOCR_TPU_ALLOW_UNTRAINED", "DET_BATCH",
            "REC_BATCH", "PIPELINE_MODE", "MICRO_BATCH", "WAVE_BATCH")
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(ONNXOCR_TPU_ASSETS=root, ONNXOCR_TPU_ALLOW_UNTRAINED="1",
                      DET_BATCH="1")
    settings.DEVICE = "cuda"
    em = engine_mod.EngineManager(concurrency=8, device="cuda")
    ref = None
    try:
        multi_card = torch.cuda.device_count() >= 2
        model = em.get_model()
        if not multi_card:
            # one card: _maybe_shard_det leaves it be, as in JAX; the
            # mesh goes in through the detector's own switch
            assert em._det_mesh() is None
            model.text_detector.enable_page_batching(mesh=m)
        pb = model.text_detector._page_batcher
        assert pb.mode == "maps" and pb.mesh is not None and \
            model.route == "map"
        waves = []
        fn = pb.batcher.fn
        pb.batcher.fn = lambda batch: waves.append(
            (int((batch["rhw"][:, 0] > 0).sum()), len(batch["rhw"]))) \
            or fn(batch)
        kw = em._get_model_kwargs("PP-OCRv5")
        ref = ONNXPaddleOcr(device="cuda", tpu_det_wire="map", **kw)
        assert ref.text_detector._page_batcher.mode == "maps" and \
            ref.text_detector._page_batcher.mesh is None
        names = list(PAGES[:4]) * (M_REQUESTS // 4)

        def run(target):
            with ThreadPoolExecutor(8) as pool:
                t0 = time.perf_counter()
                res = list(pool.map(lambda nm: target(pages[nm]), names))
                return res, time.perf_counter() - t0

        run(lambda img: em._sync_ocr(img))           # unmeasured
        run(lambda img: ref.ocr(img))
        waves.clear()
        got, wall = run(lambda img: em._sync_ocr(img)[1])
        want, ref_wall = run(lambda img: ref.ocr(img))
        for g, w in zip(got, want):
            same_result(g[0], w[0])
        summary = {
            "mesh": list(pb.mesh.devices.shape),
            "through": "_maybe_shard_det" if multi_card else
            "enable_page_batching(mesh=)",
            "ladder": list(pb.batcher.batch_ladder),
            "waves": [{"pages": a, "batch": b} for a, b in waves],
            "requests": len(names), "threads": 8,
            "pages_per_s": len(names) / wall,
            "pages_per_s_one_device": len(names) / ref_wall}
        if multi_card:
            summary["pages_per_s_per_card"] = summary["pages_per_s"] / \
                torch.cuda.device_count()
        print(f"phase M engine ({summary['through']}, mesh "
              f"{summary['mesh']}): ladder {summary['ladder']}, det waves "
              f"(pages/batch) {waves}; {len(names)} requests from 8 threads "
              f"equal the one-device maps engine's; "
              f"{summary['pages_per_s']:.2f} pages/s vs "
              f"{summary['pages_per_s_one_device']:.2f}")
        return summary
    finally:
        em.close()
        if ref is not None:
            ref.close()
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def phase_m(model, pages, tmp):
    """Phase M, serving across devices (TF32 off, the v5 checkpoints, the
    held-out pages) on `make_mesh()` (every card) and on a 4 × 1 grid of
    cuda:0 repeated: ShardedDetBatch on 5 pages at the 960² canvas against
    the port's DBNet on the card, ShardedRecBatch on 64 crops of 48 × 640
    against the unsharded SVTR (argmax equal, prob within 1e-5),
    sharded_batch_fn(True, mesh) on 4 pages decoded against path B's
    single pages at the gather warp, kernels 1–3 launched for every row
    and on each row's device; then the engine with the det batch on
    the 4 × 1 grid (or, on a host with several cards, on every card through
    _maybe_shard_det). Pages (or crops) a second of each sharded form next
    to its one-device form. → (summary, {"M": launches of sharded_batch_fn
    on the 4 × 1 grid})."""
    import torch
    from onnxocr_tpu_torch.ops import det_pre
    from onnxocr_tpu_torch.parallel import mesh as mesh_lib
    from onnxocr_tpu_torch.utils.image import get_rotate_crop_image
    t_phase = time.perf_counter()
    ocr_b = model("cuda", tpu_pipeline="onecall", use_angle_cls=False)
    ocr_off = model("cuda", tpu_pipeline="onecall", use_angle_cls=False,
                    tpu_warp_stage="off")
    ocr_c = model("cuda")
    try:
        canv = [det_pre.prepare_det_input(pages[n], 960, "max", bucket=320,
                                          canvas=(960, 960))
                for n in M_DET_PAGES]
        pages_u8 = np.stack([c[0] for c in canv])
        rhw = np.array([c[2] for c in canv], np.int32)
        crops = []
        rec = ocr_c.text_recognizer
        for n in PAGES:
            for box in ocr_c.text_detector(pages[n]):
                crop = get_rotate_crop_image(pages[n], np.asarray(
                    box, np.float32))
                crops.append(rec.resize_norm_img(crop, 640)[0])
                if len(crops) == 64:
                    break
            if len(crops) == 64:
                break
        crops = np.stack(crops)
        meshes = {"make_mesh()": mesh_lib.make_mesh(),
                  "4x1 cuda:0": mesh_lib.make_mesh(
                      4, devices=["cuda:0"] * 4)}
        summary, runs = {"meshes": {}}, {}
        for label, m in meshes.items():
            summary["meshes"][label], launches = _m_mesh(
                label, m, ocr_b, ocr_off, pages, crops, (pages_u8, rhw))
            if label == "4x1 cuda:0":
                runs["M"] = launches
        summary["engine"] = _m_engine(meshes["4x1 cuda:0"] if
                                      torch.cuda.device_count() < 2 else
                                      meshes["make_mesh()"], pages, tmp)
    finally:
        for o in (ocr_b, ocr_off, ocr_c):
            o.close()
    summary["cards"] = torch.cuda.device_count()
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"phase M ran {summary['seconds']:.1f} s on "
          f"{summary['cards']} card(s)")
    return summary, runs


def phase_pr(ocrs, pages):
    """Phase PR, utils/profiling.py: with the stage timer on (what
    ONNXOCR_TPU_PROFILE=1 sets at import), paths C, B and A each read 4
    pages; the stage names of each route must be the JAX package's
    (JAX_STAGES), one count a page each; with CAPTURE on, the captured
    det_bits, fused_scored and onecall programs replayed back to back
    (replay_ms, CUDA synchronised once at the end) and their FLOPs counted
    (flops: PyTorch's matmuls and convolutions). → summary."""
    from onnxocr_tpu_torch.utils import profiling
    timer, cap = profiling.GLOBAL, profiling.CAPTURE
    stages = {}
    names = PAGES[:4]
    try:
        timer.enabled = cap.enabled = True
        for label in ("C", "B", "A"):
            timer.reset()
            for n in names:
                ocrs[label].ocr(pages[n], cls=label == "A")
            summ = timer.summary()
            assert tuple(sorted(summ)) == JAX_STAGES[label], \
                f"phase PR path {label}: stages {sorted(summ)}"
            for k, v in summ.items():
                assert v["count"] >= len(names), (label, k, v)
            stages[label] = summ
            print(f"phase PR path {label}: stages (mean ms) " + ", ".join(
                f"{k} {v['mean_ms']:.2f} x{v['count']}"
                for k, v in sorted(summ.items())))
        programs = {}
        for name in ("det_bits", "fused_scored", "onecall"):
            assert name in cap.names(), f"phase PR: {name} not captured"
            programs[name] = {"replay_ms": cap.replay_ms(name, n=10),
                              "flops": cap.flops(name)}
            print(f"phase PR program {name}: {programs[name]['replay_ms']:.3f}"
                  f" ms a replay, {programs[name]['flops'] or 0:.3e} FLOPs "
                  f"(matmuls and convolutions)")
    finally:
        timer.enabled = cap.enabled = False
        timer.reset()
        cap._calls.clear()
    return {"stages": stages, "programs": programs}


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
    from onnxocr_tpu_torch.utils import font, imcodec
    from onnxocr_tpu_torch.utils.png import read_bgr

    with ThreadPoolExecutor(3) as pool:
        t0 = time.perf_counter()
        host = pool.submit(native.build)
        codec = pool.submit(native.build, imcodec.SOURCE, "libocrimcodec")
        ttf = pool.submit(native.build, font.SOURCE, "libocrttf")
        print(f"kernels built in {build.build_all():.1f} s")
        print(f"host libraries {host.result().name}, {codec.result().name}, "
              f"{ttf.result().name} built, {time.perf_counter() - t0:.1f} s "
              f"from the start of the build")
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
        graph, graph_runs = phase_g(model, pages, tmp)
        runs.update(graph_runs)
        batch_ocr, p_runs = phase_p(pages, tmp)
        runs.update(p_runs)
        trained, t_runs = phase_t(model, pages, tmp)
        runs.update(t_runs)
        bf16, bf_runs = phase_bf(model, {"C": ocr_c, "B": ocr, "A": ocr_a},
                                 pages)
        runs.update(bf_runs)
        multi, m_runs = phase_m(model, pages, tmp)
        runs.update(m_runs)
        prof = phase_pr({"C": ocr_c, "B": ocr, "A": ocr_a}, pages)
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
    print(json.dumps({"graph": graph}))
    print(json.dumps({"batch_ocr": batch_ocr}))
    print(json.dumps({"train": trained}))
    print(json.dumps({"bf16": bf16}))
    print(json.dumps({"multi_device": multi, "profiling": prof,
                      "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

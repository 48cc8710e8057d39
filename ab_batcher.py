"""Path C (the default pipeline) called from several threads at once, with
and without the cross-request batchers, timed in turns on one NVIDIA GPU.

    python3 ab_batcher.py [--threads 1,2,4,8] [--rounds 3]
                          [--switch-ms 5,0.5] [--out FILE]

  plain    `ONNXPaddleOcr()` at its defaults: every thread runs its own
           det forward and scored rec passes;
  batched  `ONNXPaddleOcr(tpu_det_microbatch=True, tpu_rec_microbatch=
           True)`: the det batcher runs the waiting pages' DBNet forwards
           as one wave, the rec batcher their crop chunks as one
           multi-page scored pass (runtime/batcher.py), each after up to
           8 ms of waiting.

Both models first run every held-out page once from 8 threads and once
serially (first use of every shape), and the batched one warms its
canonical multi-page shapes. Then for each GIL switch interval
(`sys.setswitchinterval`, default 5 ms, the interval after which a thread
that wants the GIL asks the holder to drop it) and each thread count,
`rounds` × the pages run from that many threads, in the order plain,
batched, batched, plain: pages/s from the host clock around the whole run,
the CTC head's launches a page. Last, at 8 threads and the default
interval, and at 1 thread, each model once more under torch.profiler
(host and card): the card's busy time a page (sum of its kernels' time),
its share of the window, and the host entries (operators, CUDA runtime
calls) with the most self time.
Prints the card's name and power limit, a line per run and one JSON object;
--out also writes it to a file.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import chip_smoke


def run(ocr, pages, names, threads):
    """→ (pages/s, CTC-head launches a page) of `names` from `threads`
    threads."""
    import torch
    from onnxocr_tpu_torch.ops.kernels import build
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    _, wall = chip_smoke.concurrent(ocr, pages, names, threads)
    head = build.LAUNCHES.get("ctc_head_reduce", 0)
    return len(names) / wall, head / len(names)


def profiled(ocr, pages, names, threads):
    """torch.profiler (host and card) over one run → {device busy ms a
    page, its share of the window (None where the profiler recorded no
    device time), the host entries with the most self time: [name, ms a
    page, calls a page]}. A host entry's self time adds up over threads."""
    import torch
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # every thread's operators, and the CUDA synchronisations as events
    config = torch.profiler._ExperimentalConfig(
        profile_all_threads=True, enable_cuda_sync_events=True)
    with torch.profiler.profile(activities=acts,
                                experimental_config=config) as prof:
        _, wall = chip_smoke.concurrent(ocr, pages, names, threads)
        torch.cuda.synchronize()
    n = len(names)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    ms = sum(e.device_time_total for e in events
             if e.device_type == cuda) / 1e3
    host = sorted((e for e in events if e.device_type != cuda),
                  key=lambda e: -e.self_cpu_time_total)[:12]
    return {"threads": threads, "page_ms": wall * 1e3 / n,
            "device_busy_ms_per_page": ms / n if ms else None,
            "device_busy_share": ms / (wall * 1e3) if ms else None,
            "host_self_ms_per_page": [
                [e.key, e.self_cpu_time_total / 1e3 / n, e.count / n]
                for e in host]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", default="1,2,4,8")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--switch-ms", default="5,0.5")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_batcher: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    from onnxocr_tpu_torch import ONNXPaddleOcr, config
    from onnxocr_tpu_torch.ops import resize_dev
    from onnxocr_tpu_torch.ops.kernels import build
    from onnxocr_tpu_torch.utils.png import read_bgr
    build.build_all()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    heldout = config.ASSETS.parent / "test_images_heldout"
    pages = {p: read_bgr(str(heldout / f"{p}.png"))
             for p in chip_smoke.PAGES}
    names = list(chip_smoke.PAGES) * args.rounds
    threads = [int(t) for t in args.threads.split(",")]
    switches = [float(s) for s in args.switch_ms.split(",")]
    default_switch = sys.getswitchinterval()
    report = {"card": smi, "pages": len(names), "runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        dict_path = os.path.join(tmp, "ppocrv5_dict.txt")
        with open(dict_path, "w") as f:
            f.write("".join(f"<{i}>\n" for i in range(18383)))
        models = {
            "plain": ONNXPaddleOcr(rec_char_dict_path=dict_path),
            "batched": ONNXPaddleOcr(rec_char_dict_path=dict_path,
                                     tpu_det_microbatch=True,
                                     tpu_rec_microbatch=True)}
        try:
            batched = models["batched"]
            src = resize_dev.src_bucket_shape(
                *pages[chip_smoke.PAGES[0]].shape[:2])
            batched.text_recognizer._crop_batcher.warm_canonical(
                batched._fused, src + (3,), 48, use_cls=False,
                prob_shape=batched.text_detector._page_batcher.canvas)
            for ocr in models.values():
                chip_smoke.concurrent(ocr, pages, chip_smoke.PAGES)
                for name in chip_smoke.PAGES:
                    ocr.ocr(pages[name], cls=False)
            for switch in switches:
                sys.setswitchinterval(switch / 1e3)
                for n in threads:
                    out = {"plain": [], "batched": []}
                    for label in ("plain", "batched", "batched", "plain"):
                        out[label].append(run(models[label], pages, names,
                                              n))
                    for label, rs in out.items():
                        entry = {"model": label, "switch_ms": switch,
                                 "threads": n,
                                 "pages_per_s": [r[0] for r in rs],
                                 "ctc_head_launches_per_page": rs[0][1]}
                        report["runs"].append(entry)
                        print(f"switch {switch} ms, {n} threads, {label}: "
                              f"pages/s " + ", ".join(
                                  f"{r[0]:.2f}" for r in rs) +
                              f"; CTC head {rs[0][1]:.3f} launches a page")
            sys.setswitchinterval(default_switch)
            report["profiled"] = []
            for n in sorted({min(threads), max(threads)}):
                for label, ocr in models.items():
                    p = dict(profiled(ocr, pages, names, n), model=label)
                    report["profiled"].append(p)
                    print(f"{label}, {n} threads under the profiler: "
                          f"{p['page_ms']:.2f} ms a page, device busy "
                          f"{p['device_busy_ms_per_page']} ms a page, share "
                          f"{p['device_busy_share']}; host self ms a page: "
                          + ", ".join(f"{k} {ms:.2f} ({c:.0f})" for k, ms, c
                                      in p["host_self_ms_per_page"][:8]))
        finally:
            models["batched"].close()
    text = json.dumps(report)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

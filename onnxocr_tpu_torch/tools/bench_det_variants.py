"""Time the det → boxes wire variants of the port against each other: the
full det + cls + rec pipeline, identical but for the det wire, as the JAX
package's tools/bench_det_variants.py times it.

  * maps    — download the full quantised probability map, host DB
              postprocess (tpu_det_wire='maps': the map route)
  * bitmap  — download only the bitpacked bitmap; the candidates are
              scored in the fused rec pass (tpu_det_wire='bitmap': the
              default)
  * device  — DB extraction on the device, only K quads cross
              (tpu_det_postprocess='device', ops/db_device.py)

    python -m onnxocr_tpu_torch.tools.bench_det_variants [--rounds 3]
        [--max-images 8] [--device cuda|cpu]

prints ONE JSON line: the median end-to-end ms a page of each variant over
the corpus and its mean box count (an agreement check), and the device:
  {"metric": "e2e_ms_per_page_by_det_wire", "images", "rounds",
   "variants": {name: {"median_ms", "mean_boxes"}}, "device": {...}}

Each variant first runs every page once (warm-up), then `--rounds` timed
passes over the corpus. With BENCH_LAUNCHES_OUT=<file> (as the bench's) it
writes each variant's kernel launches a page of the timed passes there: a
side file, so that the line keeps the JAX tool's keys. The corpus is the
committed onnxocr_tpu/test_images/*.jpg, decoded with utils/imcodec, as the
port's bench entries read it (the JAX tool looks for a reference checkout's
corpus first). The recognition dictionary is found as the package finds it
(ONNXOCR_TPU_ASSETS), and the angle classifier needs its weights or
ONNXOCR_TPU_ALLOW_UNTRAINED=1, as in the JAX tool. Without CUDA and without
--device cpu it exits.
"""
import argparse
import json
import os
import statistics
import sys
import time

from .. import bench

VARIANTS = {
    "maps": dict(tpu_det_wire="maps"),
    "bitmap": dict(tpu_det_wire="bitmap"),
    "device": dict(tpu_det_postprocess="device"),
}


def load_images(max_images: int):
    """The committed corpus's JPEGs, sorted by name, decoded by the codec;
    the first `max_images` that decode."""
    from ..utils import imcodec
    root = bench.REPO / "onnxocr_tpu" / "test_images"
    images = []
    for path in sorted(root.glob("*.jpg")):
        img = imcodec.imdecode(path.read_bytes())
        if img is not None:
            images.append(img)
    return images[:max_images]


def time_variant(model, images, rounds, launches=None):
    """→ (median ms a page, mean boxes a page) over `rounds` passes, after
    one pass that warms every shape; `launches` (a dict) gets the kernel
    launches a page of the timed passes."""
    from ..ops.kernels import build
    for im in images:
        model.ocr(im)
    before = dict(build.LAUNCHES)
    lat = []
    boxes = []
    for _ in range(rounds):
        for im in images:
            t0 = time.perf_counter()
            res = model.ocr(im)
            lat.append((time.perf_counter() - t0) * 1000)
            boxes.append(len(res[0] or []))
    if launches is not None and lat:
        launches.update({k: (n - before.get(k, 0)) / len(lat)
                         for k, n in sorted(build.LAUNCHES.items())
                         if n > before.get(k, 0)})
    return statistics.median(lat), sum(boxes) / max(len(boxes), 1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--max-images", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from .eval_heldout import check_device
    check_device("bench_det_variants", args.device)

    from .. import config as cfg
    from ..pipeline.api import ONNXPaddleOcr
    images = load_images(args.max_images)
    out = {"metric": "e2e_ms_per_page_by_det_wire", "images": len(images),
           "rounds": args.rounds, "variants": {}}
    dict_path = cfg.find_asset("ppocrv5/ppocrv5_dict.txt")
    per_page = {}
    for name, kw in VARIANTS.items():
        model = ONNXPaddleOcr(use_angle_cls=True, use_gpu=False,
                              drop_score=0.0, device=args.device,
                              rec_char_dict_path=dict_path, **kw)
        try:
            ms, mean_boxes = time_variant(model, images, args.rounds,
                                          per_page.setdefault(name, {}))
        finally:
            model.close()
        out["variants"][name] = {"median_ms": round(ms, 1),
                                 "mean_boxes": round(mean_boxes, 1)}
        print(f"[det-variants] {name}: {ms:.1f} ms/page, "
              f"{mean_boxes:.1f} boxes", file=sys.stderr, flush=True)
    out["device"] = bench.device_info(args.device)
    side = os.environ.get("BENCH_LAUNCHES_OUT")
    if side:
        with open(side, "w") as f:
            json.dump({"launches_per_page": per_page}, f)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

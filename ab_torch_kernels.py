"""The four DB-extraction reduction kernels of two or more source trees,
timed in turns on one NVIDIA GPU.

    python3 ab_torch_kernels.py --parent DIR [DIR ...] [--out FILE]

Each DIR is the root of another checkout of this repository (for example
`git archive <commit> | tar -x -C build/parent`), named by its last
component. Its `onnxocr_tpu_torch/ops/kernels` wrappers are loaded beside
this tree's ("change"), each building its own `csrc/` into its own
`build/kernels/`. All get the same tensors: a held-out page's labelled det
map on the one-call path's grid (chip_smoke.page_grid) and made-up runs of
the same size (all background, one label or slot everywhere, two
alternating cell by cell). Every result is first held against this tree's
plain version, then timed in the order parent(s), change, change, parent(s)
reversed, by CUDA events around eager calls (`ms`) and replayed from a CUDA
graph (`graph_ms`). Two runs may land on cards and hosts that differ, so
only numbers of one run compare. Prints the card's name and power limit and
one JSON object; --out also writes it to a file.
"""
import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import chip_smoke


def load_tree(root, alias):
    """The kernel wrappers of the checkout at `root` as package `alias`."""
    pkg = Path(root) / "onnxocr_tpu_torch" / "ops" / "kernels"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return {name: importlib.import_module(f"{alias}.{name}")
            for name in ("build", "seg_reduce", "seg_reduce2")}


def cases(ocr, page):
    """{kernel: {case: (call(tree) → tensor, plain() → tensor, tolerances)}}
    on the page's grid and on the made-up runs of the same size."""
    from onnxocr_tpu_torch.ops import db_device
    from onnxocr_tpu_torch.ops.kernels import seg_reduce as band
    from onnxocr_tpu_torch.ops.kernels import seg_reduce2 as lab2
    lab, prob, ids, sy, sx = chip_smoke.page_grid(ocr, page)
    K, dev = ids.shape[0], lab.device
    axes = db_device.pca_axes(lab2.label_moment_sums_plain(lab, prob, ids,
                                                           sy, sx))
    slot, hit = db_device.label_slots(lab, K)
    fx, fy = db_device.cell_coords(*lab.shape, sy, sx, dev)
    stats = db_device.moment_stats(prob, hit, fx, fy).contiguous()
    cols = db_device.proj_columns(slot, hit, axes, fx, fy).contiguous()
    ids2, labs, slots = chip_smoke.run_grids(lab.shape, K, dev)
    labels = {"page": (lab, ids), **{r: (L, ids2) for r, L in labs.items()}}
    slots = {"page": slot, **slots}
    sums, mins = dict(rtol=1e-5, atol=0), dict(rtol=0, atol=1e-4)
    out = {"label_moment_sums": {}, "label_proj_extents": {},
           "seg_sum_bands": {}, "seg_min_bands": {}}
    for name, (L, I) in labels.items():
        out["label_moment_sums"][name] = (
            lambda t, L=L, I=I: t["seg_reduce2"].label_moment_sums(
                L, prob, I, sy, sx),
            lambda L=L, I=I: lab2.label_moment_sums_plain(L, prob, I, sy, sx),
            sums)
        out["label_proj_extents"][name] = (
            lambda t, L=L, I=I: t["seg_reduce2"].label_proj_extents(
                L, axes, I, sy, sx),
            lambda L=L, I=I: lab2.label_proj_extents_plain(L, axes, I, sy,
                                                           sx), mins)
    for name, S in slots.items():
        out["seg_sum_bands"][name] = (
            lambda t, S=S: t["seg_reduce"].seg_sum_bands(S, stats, K),
            lambda S=S: band.seg_sum_bands_plain(S, stats, K), sums)
        out["seg_min_bands"][name] = (
            lambda t, S=S: t["seg_reduce"].seg_min_bands(S, cols, K),
            lambda S=S: band.seg_min_bands_plain(S, cols, K), mins)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, nargs="+")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_torch_kernels: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    from onnxocr_tpu_torch import ONNXPaddleOcr, config
    from onnxocr_tpu_torch.utils.png import read_bgr
    trees = {Path(d).name: load_tree(d, f"ab_{Path(d).name}")
             for d in args.parent}
    assert "change" not in trees and len(trees) == len(args.parent)
    order = [*trees, "change", "change", *reversed(trees)]
    trees["change"] = load_tree(Path(__file__).resolve().parent, "ab_change")
    for name, tree in trees.items():
        print(f"{name}: kernels built in {tree['build'].build_all():.1f} s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    heldout = config.ASSETS.parent / "test_images_heldout"
    page = read_bgr(str(heldout / f"{chip_smoke.PAGES[0]}.png"))
    with tempfile.TemporaryDirectory() as tmp:
        dict_path = os.path.join(tmp, "ppocrv5_dict.txt")
        with open(dict_path, "w") as f:
            f.write("".join(f"<{i}>\n" for i in range(18383)))
        ocr = ONNXPaddleOcr(device="cuda", rec_char_dict_path=dict_path,
                            tpu_pipeline="onecall", use_angle_cls=False)
        todo = cases(ocr, page)
    report = {"card": smi, "page": chip_smoke.PAGES[0], "kernels": {}}
    for kernel, by_case in todo.items():
        report["kernels"][kernel] = {}
        for case, (call, plain, tol) in by_case.items():
            want = plain()
            for tree in trees.values():
                torch.testing.assert_close(call(tree), want, **tol)
            times = {name: [] for name in trees}
            for name in order:
                times[name].append(chip_smoke.both_timed(
                    lambda: call(trees[name])))
            report["kernels"][kernel][case] = times
            print(f"{kernel:19s} {case:12s} ms in a graph (by events): "
                  + "; ".join(f"{name} " + " ".join(
                      f"{t['graph_ms']:.4f} ({t['ms']:.4f})" for t in ts)
                      for name, ts in times.items()))
    text = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

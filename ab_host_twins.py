"""The host crop twin, the float32 resize twins and the training renderer
that calls them, for two source trees, timed in turns on one host.

    python3 ab_host_twins.py --parent DIR [--out FILE] [--repeats N]

DIR is the root of another checkout of this repository (for example
`git archive <commit> | tar -x -C build/parent`). This process first runs
the port's detector on the CPU over the eight held-out pages of
chip_smoke.PAGES (random weights, as chip_smoke.py builds it) and keeps
its boxes. Each tree's `onnxocr_tpu_torch` then runs in a child process of
its own, in the order parent, change, change, parent, on the same inputs:

* the host-crop route: `utils/image.get_rotate_crop_image` of every one
  of those boxes on its page — its ms a page (the mean over the pages of
  the sum of a page's crops) and the median ms of one crop;
* `utils/cv_ops.resize_cubic` of a 4 × 4 float32 image to 640² and to
  1150 × 720 (the corpus tool's photo_hard page), and `resize_linear` of
  a float32 21 × 24 × 3 image to 313 × 262: the median ms of a call;
* the training renderer (`train/synth.TextRenderer`, seed 0, the
  fractions chip_smoke.py's phase SY gives the CLI): `det_page_hard()` at
  320², `rec_batch(32)` at width 320 and `det_batch(8)` at 320² with hard
  pages 0.3 and tables 0.2 of it: the median ms of a call. Both trees
  draw the same random numbers.

Each child first makes one untimed call of each (a tree that builds host
C++ builds it then), then takes the medians over --repeats rounds. The
parent's and the change's figures are the means of their two turns, and
`ratio` is change over parent. Prints the card's name and power limit
(nvidia-smi; the work is the host's) and one JSON object; --out also
writes it to a file.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

_CHILD = r"""
import json, sys, time
import numpy as np
tree, boxes_path, repeats = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, tree)
from onnxocr_tpu_torch import config
from onnxocr_tpu_torch.train import synth
from onnxocr_tpu_torch.utils import cv_ops
from onnxocr_tpu_torch.utils.image import get_rotate_crop_image
from onnxocr_tpu_torch.utils.png import read_bgr
assert cv_ops.__file__.startswith(tree), cv_ops.__file__
held = config.ASSETS.parent / "test_images_heldout"
saved = np.load(boxes_path)
pages = [(read_bgr(str(held / f"{n}.png")), saved[n]) for n in saved.files]


def median_ms(fn):
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


rng = np.random.default_rng(7)
base = rng.uniform(40, 230, (4, 4, 3)).astype(np.float32)
small = rng.uniform(40, 230, (24, 21, 3)).astype(np.float32)
c2i = {c: i + 1 for i, c in enumerate(dict.fromkeys(synth.DEFAULT_CHARSET))}
renderer = synth.TextRenderer(char_to_idx=c2i, seed=0, structured_frac=0.5,
                              lowres_frac=0.2, photo_frac=0.2,
                              dotmatrix_frac=0.1)
calls = {
    "cubic_4x4_to_640x640": lambda: cv_ops.resize_cubic(base, (640, 640)),
    "cubic_4x4_to_1150x720": lambda: cv_ops.resize_cubic(base, (1150, 720)),
    "linear_21x24_to_313x262": lambda: cv_ops.resize_linear(small,
                                                            (313, 262)),
    "det_page_hard_320": lambda: renderer.det_page_hard(320),
    "rec_batch_32x320": lambda: renderer.rec_batch(32, 320),
    "det_batch_8x320": lambda: renderer.det_batch(8, 320, hard_frac=0.3,
                                                  table_frac=0.2)}
get_rotate_crop_image(pages[0][0], pages[0][1][0])
for fn in calls.values():
    fn()
page_ms, crop_ms = [], []
for _ in range(repeats):
    for page, boxes in pages:
        total = 0.0
        for b in boxes:
            t0 = time.perf_counter()
            get_rotate_crop_image(page, b)
            dt = (time.perf_counter() - t0) * 1e3
            crop_ms.append(dt)
            total += dt
        page_ms.append(total)
out = {"crop_route_ms_per_page": float(np.mean(page_ms)),
       "crop_ms_median": float(np.median(crop_ms))}
for name, fn in calls.items():
    out[name + "_ms"] = median_ms(fn)
print(json.dumps(out))
"""


def det_boxes(path: Path) -> int:
    """The port's CPU detector's boxes on each page of chip_smoke.PAGES,
    saved to `path` (one float32 (N, 4, 2) array a page); → how many."""
    sys.path.insert(0, str(HERE))
    import chip_smoke
    from onnxocr_tpu_torch import ONNXPaddleOcr, config
    from onnxocr_tpu_torch.utils.png import read_bgr
    held = config.ASSETS.parent / "test_images_heldout"
    dict_path = path.with_name("ppocrv5_dict.txt")
    dict_path.write_text("".join(f"<{i}>\n" for i in range(18383)))
    ocr = ONNXPaddleOcr(device="cpu", rec_char_dict_path=str(dict_path))
    try:
        boxes = {n: np.asarray(ocr.text_detector(
            read_bgr(str(held / f"{n}.png"))), np.float32).reshape(-1, 4, 2)
            for n in chip_smoke.PAGES}
    finally:
        ocr.close()
    np.savez(path, **boxes)
    return sum(len(b) for b in boxes.values())


def run(tree: Path, boxes: Path, repeats: int) -> dict:
    done = subprocess.run([sys.executable, "-c", _CHILD, str(tree),
                           str(boxes), str(repeats)], capture_output=True,
                          text=True, timeout=1200)
    if done.returncode != 0:
        raise RuntimeError(f"{tree}: {done.stderr[-3000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    trees = {"parent": Path(args.parent).resolve(), "change": HERE}
    with tempfile.TemporaryDirectory() as tmp:
        boxes = Path(tmp) / "boxes.npz"
        n = det_boxes(boxes)
        print(f"{n} det boxes on the held-out pages", flush=True)
        turns = []
        for name in ("parent", "change", "change", "parent"):
            turns.append((name, run(trees[name], boxes, args.repeats)))
            print(f"{name}: {json.dumps(turns[-1][1])}", flush=True)
    summary = {"boxes": n}
    for name in trees:
        rows = [r for t, r in turns if t == name]
        summary[name] = {k: sum(r[k] for r in rows) / len(rows)
                         for k in rows[0]}
    summary["ratio"] = {k: summary["change"][k] / summary["parent"][k]
                        for k in summary["change"]}
    summary["turns"] = [{"tree": t, **r} for t, r in turns]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError:
        card = "no nvidia-smi"
    print(card)
    summary["card"] = card
    line = json.dumps(summary)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()

"""Render the self-owned test corpus: pages of synthetic text lines with
machine ground truth in gt.json (each line's exact text and its
axis-aligned quad), so accuracy checks are scriptable
(`python -m onnxocr_tpu_torch.tools.eval_corpus`). Counterpart of the JAX
package's tools/make_test_corpus.py: the same pages, seed, composition and
JPEG quality, on the port's renderer (train/synth.py) and codec.

Usage:
  python -m onnxocr_tpu_torch.tools.make_test_corpus [--out build/test_images]

Differences from the JAX tool: the default `--out` is build/test_images/
of the checkout, never the committed onnxocr_tpu/test_images that the JAX
tool writes; the "hard" background's cv2.resize(INTER_CUBIC) is the
port's twin (utils/cv_ops.resize_cubic), within 8e-5 of cv2's IPP path,
so a hard page may differ from the JAX tool's on a few values by a few
levels (ROADMAP §3.3).
"""
import argparse
import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "build", "test_images")
SEED = 20260817

# (name, (H, W), n_lines, style, line_height_range)
PAGES = [
    ("doc_a", (528, 896), 10, "doc", (18, 34)),
    ("doc_b", (750, 1000), 14, "doc", (20, 38)),
    ("receipt", (900, 420), 16, "doc", (16, 26)),
    ("small", (350, 350), 4, "doc", (18, 30)),
    ("card", (270, 360), 3, "doc", (20, 32)),
    ("poster_hard", (692, 1024), 6, "hard", (28, 52)),
    ("photo_hard", (720, 1150), 8, "hard", (22, 44)),
    ("big_doc", (1280, 960), 18, "doc", (22, 40)),
    ("ticket", (267, 430), 4, "doc", (16, 26)),
    ("sparse", (574, 528), 3, "doc", (24, 40)),
    ("banner", (215, 1200), 2, "doc", (40, 70)),
    ("dense", (640, 640), 12, "doc", (14, 24)),
]


def compose(renderer, rng, shape, n_lines, style, hrange):
    """One page and its ground truth, the JAX tool's draws in its order."""
    from ..utils import cv_ops
    H, W = shape
    if style == "hard":
        base = rng.uniform(60, 220, size=(4, 4, 3)).astype(np.float32)
        page = cv_ops.resize_cubic(base, (W, H))
        page += rng.normal(0, 5, page.shape)
        page = np.clip(page, 0, 255).astype(np.float32)
    else:
        bg = int(rng.integers(200, 252))
        page = np.full((H, W, 3), bg, np.float32)
        page += rng.normal(0, 3, page.shape)
        page = np.clip(page, 0, 255)
    occupied = np.zeros((H, W), bool)
    gt = []
    for _ in range(n_lines):
        text, fkey = renderer.sample_line(14)
        h = int(rng.integers(*hrange))
        line, alpha = renderer.render_line(text, h, W - 16, font_key=fkey,
                                           return_alpha=True)
        lh, lw = line.shape[:2]
        for _try in range(12):
            x0 = int(rng.integers(4, max(5, W - lw - 4)))
            y0 = int(rng.integers(4, max(5, H - lh - 4)))
            if occupied[y0:y0 + lh, x0:x0 + lw].any():
                continue
            region = page[y0:y0 + lh, x0:x0 + lw]
            if style == "hard":
                # alpha-composite a solid ink colour over the background
                ink = rng.integers(0, 90, 3).astype(np.float32)
                a = alpha[..., None]
                page[y0:y0 + lh, x0:x0 + lw] = region * (1 - a) + ink * a
            else:
                page[y0:y0 + lh, x0:x0 + lw] = line.astype(np.float32)
            occupied[max(0, y0 - 6):y0 + lh + 6,
                     max(0, x0 - 6):x0 + lw + 6] = True
            gt.append({
                "text": text,
                "box": [[x0, y0], [x0 + lw, y0], [x0 + lw, y0 + lh],
                        [x0, y0 + lh]],
            })
            break
    return np.clip(page, 0, 255).astype(np.uint8), gt


def main(argv=None):
    from .. import config as cfg
    from ..train import synth
    from ..utils import imcodec

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    c2i = synth.charset_from_dict(cfg.find_asset("ppocrv5/ppocrv5_dict.txt"))
    renderer = synth.TextRenderer(char_to_idx=c2i, seed=SEED)
    rng = np.random.default_rng(SEED)

    manifest = {}
    for name, shape, n_lines, style, hrange in PAGES:
        page, gt = compose(renderer, rng, shape, n_lines, style, hrange)
        fn = name + ".jpg"
        with open(os.path.join(args.out, fn), "wb") as f:
            f.write(imcodec.imencode_jpeg(page, 92))
        manifest[fn] = gt
        print(f"{fn}: {page.shape[1]}x{page.shape[0]} {len(gt)} lines")
    with open(os.path.join(args.out, "gt.json"), "w") as f:
        json.dump(manifest, f, ensure_ascii=False, indent=1)
    print("wrote", args.out)
    return manifest


if __name__ == "__main__":
    main()

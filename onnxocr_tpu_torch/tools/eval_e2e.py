"""Evaluate the port's full pipeline on synthetic pages with known ground
truth: char accuracy, detection recall, and the box-height ratio (for
tuning the det shrink target and unclip ratio). Counterpart of the JAX
package's tools/eval_e2e.py: the same pages (`render_page`, on the port's
renderer), model settings, metrics and printed lines.

Usage:
  python -m onnxocr_tpu_torch.tools.eval_e2e [--pages 5] [--drop-score 0.3]
  (add --device cpu to run on the CPU)

Differences from the JAX tool: `--device` (default cuda; without CUDA the
tool exits unless --device cpu is given); `render_page` also takes the
dictionary and the font faces to render with, for the goldens
(make_goldens), which pin both.
"""
import argparse
import warnings

import numpy as np

from .eval_heldout import check_device


def render_page(seed, size=640, dict_path=None, fonts=None):
    """A size² page of up to six random lines of the dictionary's
    renderable characters and their boxes, the JAX tool's draws."""
    from .. import config as cfg_mod
    from ..train import synth
    if dict_path is None:
        dict_path = cfg_mod.find_asset("ppocrv5/ppocrv5_dict.txt")
    c2i = synth.charset_from_dict(dict_path)
    r = synth.TextRenderer(char_to_idx=c2i, seed=seed, fonts=fonts)
    rng = np.random.default_rng(seed)
    page = np.full((size, size, 3), 235, np.uint8)
    truths = []
    y = 40
    for _ in range(6):
        text = r.random_text(10)
        line = r.render_line(text, int(rng.integers(28, 44)), size - 80)
        lh, lw = line.shape[:2]
        x = int(rng.integers(10, size - lw - 10))
        if y + lh > size - 10:
            break
        page[y:y + lh, x:x + lw] = line
        truths.append((text, (x, y, x + lw, y + lh)))
        y += lh + int(rng.integers(20, 40))
    return page, truths


def char_acc(pred, truth):
    import difflib
    return difflib.SequenceMatcher(None, pred, truth).ratio()


def main(argv=None):
    warnings.filterwarnings("ignore")
    ap = argparse.ArgumentParser()
    ap.add_argument("--pages", type=int, default=5)
    ap.add_argument("--drop-score", type=float, default=0.3)
    ap.add_argument("--unclip", type=float, default=1.5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    check_device("eval_e2e", args.device)

    from ..pipeline.api import ONNXPaddleOcr
    model = ONNXPaddleOcr(use_angle_cls=True, use_gpu=False,
                          device=args.device, drop_score=args.drop_score,
                          det_db_unclip_ratio=args.unclip,
                          det_limit_side_len=640, tpu_det_bucket=320)

    tot, acc_sum, det_hits, det_total = 0, 0.0, 0, 0
    hratios = []
    for seed in range(args.pages):
        page, truths = render_page(seed + 100)
        boxes = model.text_detector(page)
        res = model.ocr(page)
        preds = [line[1][0] for line in res[0]]
        for text, (x0, y0, x1, y1) in truths:
            det_total += 1
            best_iouish = 0.0
            for b in np.asarray(boxes).reshape(-1, 4, 2) if len(boxes) else []:
                bx0, by0 = b.min(axis=0)
                bx1, by1 = b.max(axis=0)
                ix = max(0, min(x1, bx1) - max(x0, bx0))
                iy = max(0, min(y1, by1) - max(y0, by0))
                inter = ix * iy
                union = (x1 - x0) * (y1 - y0)
                if union > 0 and inter / union > best_iouish:
                    best_iouish = inter / union
                    hratios.append((by1 - by0) / max(y1 - y0, 1))
            if best_iouish > 0.5:
                det_hits += 1
            best = max((char_acc(p, text) for p in preds), default=0.0)
            acc_sum += best
            tot += 1
        print(f"page {seed}: {len(truths)} lines, {len(boxes)} boxes, "
              f"preds={preds}")
    print(f"\ndet recall: {det_hits}/{det_total}")
    print(f"char accuracy: {acc_sum / max(tot, 1):.3f}")
    if hratios:
        print(f"box-height / text-height ratio: "
              f"median {np.median(hratios):.2f}")
    return {"det_hits": det_hits, "det_total": det_total,
            "char_accuracy": acc_sum / max(tot, 1),
            "hratio_median": float(np.median(hratios)) if hratios else None}


if __name__ == "__main__":
    main()

"""Machine-checked accuracy eval of the port's pipeline on the committed
self-owned corpus: every page under onnxocr_tpu/test_images carries exact
ground truth (gt.json, written by make_test_corpus: rendered text and quad
per line), so the eval needs no hand labels. Counterpart of the JAX
package's tools/eval_corpus.py: the same metrics, JSON keys and printed
lines — line recall @ similarity 0.5, mean char similarity of the best
match per GT line, exact matches, and det IoU recall (a GT quad counts as
detected when some predicted box overlaps it with IoU >= 0.3 on
axis-aligned bounds).

Usage:
  python -m onnxocr_tpu_torch.tools.eval_corpus [--model PP-OCRv5] [--json]
  (add --device cpu to run on the CPU)

Differences from the JAX tool: `--device` (default cuda; without CUDA the
tool exits unless --device cpu is given); pages are read through the
port's codec.
"""
import argparse
import json
import os

from .eval_heldout import REPO, check_device, imread, similarity

CORPUS = os.path.join(REPO, "onnxocr_tpu", "test_images")


def aabb_iou(box_a, box_b) -> float:
    import numpy as np
    a = np.asarray(box_a, float).reshape(-1, 2)
    b = np.asarray(box_b, float).reshape(-1, 2)
    ax0, ay0 = a.min(0)
    ax1, ay1 = a.max(0)
    bx0, by0 = b.min(0)
    bx1, by1 = b.max(0)
    iw = min(ax1, bx1) - max(ax0, bx0)
    ih = min(ay1, by1) - max(ay0, by0)
    if iw <= 0 or ih <= 0:
        return 0.0
    inter = iw * ih
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / max(union, 1e-9)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="PP-OCRv5")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    check_device("eval_corpus", args.device)

    with open(os.path.join(CORPUS, "gt.json")) as f:
        manifest = json.load(f)

    from ..service import engine as engine_mod
    em = engine_mod.EngineManager(concurrency=1, device=args.device)
    model = em.get_model(args.model)

    sims, exact, found, det_hits, total = [], 0, 0, 0, 0
    per_image = {}
    for fname, gt_lines in sorted(manifest.items()):
        img = imread(os.path.join(CORPUS, fname))
        if img is None:
            continue
        result = model.ocr(img)
        entries = result[0] or []
        preds = [e[1][0] for e in entries]
        pred_boxes = [e[0] for e in entries]
        rows = []
        for line in gt_lines:
            gt = line["text"]
            best, best_sim = "", 0.0
            for p in preds:
                s = similarity(gt, p)
                if s > best_sim:
                    best, best_sim = p, s
            det_hit = any(aabb_iou(line["box"], pb) >= 0.3
                          for pb in pred_boxes)
            sims.append(best_sim)
            exact += int(best_sim == 1.0)
            found += int(best_sim >= 0.5)
            det_hits += int(det_hit)
            total += 1
            rows.append({"gt": gt, "pred": best, "sim": round(best_sim, 3),
                         "det": det_hit})
        per_image[fname] = rows
        if args.verbose:
            for r in rows:
                print(f"  {fname}: det={int(r['det'])} gt={r['gt']!r} "
                      f"pred={r['pred']!r} sim={r['sim']}")

    summary = {
        "model": args.model,
        "gt_lines": total,
        "det_recall@iou0.3": round(det_hits / max(total, 1), 3),
        "line_recall@0.5": round(found / max(total, 1), 3),
        "char_accuracy": round(sum(sims) / max(len(sims), 1), 3),
        "exact_match": exact,
    }
    if args.json:
        print(json.dumps({"summary": summary, "per_image": per_image},
                         ensure_ascii=False))
    else:
        print(json.dumps(summary, ensure_ascii=False))
    return summary


if __name__ == "__main__":
    main()

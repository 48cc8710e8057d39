"""Held-out accuracy eval of the port's pipeline: the reference's own
test images against hand-transcribed lines (the "real" set), and the
committed held-out synthetic pages (onnxocr_tpu/test_images_heldout/ with
its gt.json, rendered in faces the trainer never uses; the "synth" set).
Counterpart of the JAX package's tools/eval_heldout.py: the same flags,
ground truth, metrics, JSON keys and printed lines. It reports

  * line recall  — GT lines matched by some prediction (similarity ≥ 0.5),
    a detector-quality proxy;
  * char accuracy — mean normalized edit similarity of the best match per
    GT line;
  * exact matches;

in all and by set. The real set's images are read from the reference's
test images copied into this checkout's build/reference/onnxocr/
test_images (REF_IMAGES); where they are absent their pages are skipped
and the set counts 0 lines, as in the JAX tool.

Usage:
  python -m onnxocr_tpu_torch.tools.eval_heldout [--model PP-OCRv5] [--json]
  (add --device cpu to run on the CPU)

Differences from the JAX tool: `--device` (default cuda; without CUDA the
tool exits unless --device cpu is given). Images are read as cv2.imread
reads them, through the port's codec (utils/imcodec.py).
"""
import argparse
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF_IMAGES = os.path.join(REPO, "build", "reference", "onnxocr",
                          "test_images")
SYNTH_DIR = os.path.join(REPO, "onnxocr_tpu", "test_images_heldout")


# Hand-transcribed prominent text lines (labels typed from viewing the
# images; NOT derived from any model output).
GROUND_TRUTH = {
    "ger_1.jpg": [
        "EPPING",
        "Twinned with",
        "Eppingen, Germany",
    ],
    "ger_2.jpg": [
        "Halten Sie,",
        "was Sie versprechen.",
        "Und geben Sie noch was dazu.",
    ],
    "french_0.jpg": [
        "Mairie du I",
        "Palais du LOUVRE",
        "LES ARTS DÉCORATIFS",
        "Musée du LOUVRE",
        "Théâtre",
        "du PALAIS-ROYAL",
    ],
    "00056221.jpg": [
        "Z57A001950",
        "G7512",
        "3623301993****0941",
        "9004-1300-5707-08A0-0195-0",
        "Hang Zhou Dong",
        "Shang Hai Hong Qiao",
    ],
    # boarding pass (printed, latin + digits)
    "00006737.jpg": [
        "BOARDING PASS",
        "MU 2379",
        "03DEC",
        "035",
        "FUZHOU",
        "TAIYUAN",
        "ZHANGQIWEI",
        "G11",
        "ETKT 7813699238489/1",
        "GATES CLOSE 10 MINUTES BEFORE DEPARTURE TIME",
    ],
    # clothing care label
    "00009282.jpg": [
        "Meters/bonwe",
    ],
    # shareholder table (digit cells)
    "00015504.jpg": [
        "75,103",
        "Hong Leong Bank",
        "Berhad",
        "652,418,000",
        "18.0613%",
        "650,000,000",
        "17.9943%",
        "240,000,000",
        "6.6441%",
        "180,600,242",
        "4.9997%",
        "160,000,000",
        "4.4294%",
        "124,194,000",
        "3.4381%",
        "120,000,000",
        "3.3220%",
        "80,000,000",
        "2.2147%",
        "71,243,800",
        "1.9723%",
        "71,154,900",
        "1.9698%",
        "50,000,000",
    ],
    # lab-report table (clean scan: codes, values, ranges, units)
    "00018069.jpg": [
        "ALT", "TBIL", "DBIL", "IBIL", "ALB", "GLO", "A/G", "ALP",
        "GGT", "AST", "LDH", "ADA",
        "25.6", "11.2", "3.3", "7.9", "35.1", "23.8", "93",
        "14.3", "16.3", "167", "12.6",
        "0--40", "0--7", "60--80", "33--55", "20--30", "15--112",
        "8--40", "114--240", "4--24",
        "U/L", "umol/L", "g/L", "IU/L",
    ],
    # photographed lab report (tilted scene photo: the det-generalization
    # probe alongside french_0)
    "00057937.jpg": [
        "FT3", "FT4", "STSH", "TGAB", "TRAb", "TPOAb",
        "3.12", "15.40", "1.31", "0.15", "0.17",
        "E05535540",
        "10080603139",
        "10-08-06 11:23",
        "10-08-06 11:44",
        "10-08-07 11:28",
    ],
    # math worksheet (formula lines with x signs)
    "00059985.jpg": [
        "0.8×25=",
        "0×4.23=",
        "0.57+0.43=",
        "2.4×0.2=",
        "2.8×10=",
        "8.29×100=",
        "2.5×0.4=",
        "4.87-1.7=",
        "2.97×3.8=",
        "7.05×0.84=",
    ],
    # photographed bank slip
    "00111002.jpg": [
        "120214020408",
        "60128018",
        "001",
        "2012-10-23",
        "12:43:15",
        "000016",
        "(CARDHOLDER SIGNATURE):",
    ],
}


def imread(path: str):
    """cv2.imread(path): the file's bytes through the port's codec, None
    for a file that is missing or not an image cv2 reads."""
    from ..utils import imcodec
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return imcodec.imdecode(data) if data else None


def check_device(tool: str, device: str) -> None:
    """Exit with a message when `device` cannot run (CUDA asked for but
    absent), before a model is built."""
    from ..pipeline.system import resolve_device
    try:
        resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(f"{tool}: {e} (--device cpu)")


def edit_distance(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def similarity(a: str, b: str) -> float:
    if not a and not b:
        return 1.0
    return 1.0 - edit_distance(a, b) / max(len(a), len(b), 1)


def build_model(args):
    """The JAX tool's two ways: ONNXPaddleOcr with the overrides given, or
    the service engine's model of --model."""
    if args.det_dir or args.rec_dir or args.tpu_dtype or args.pipeline or \
            args.set:
        from ..pipeline.api import ONNXPaddleOcr
        kw = {}
        if args.det_dir:
            kw["det_model_dir"] = args.det_dir
        if args.rec_dir:
            kw["rec_model_dir"] = args.rec_dir
        if args.tpu_dtype:
            kw["tpu_dtype"] = args.tpu_dtype
        if args.pipeline:
            kw["tpu_pipeline"] = args.pipeline
        for item in args.set:
            k, _, v = item.partition("=")
            for cast in (int, float):
                try:
                    v = cast(v)
                    break
                except ValueError:
                    continue
            kw[k] = v
        return ONNXPaddleOcr(use_angle_cls=True, use_gpu=False,
                             device=args.device, **kw)
    from ..service import engine as engine_mod
    em = engine_mod.EngineManager(concurrency=1, device=args.device)
    return em.get_model(args.model)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="PP-OCRv5")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--det-dir", default="",
                    help="override det_model_dir (evaluate a candidate "
                         "det checkpoint: pass <dir>/det.onnx with "
                         "native_params.npz beside it)")
    ap.add_argument("--rec-dir", default="",
                    help="override rec_model_dir (candidate rec "
                         "checkpoint, same <dir>/rec.onnx convention)")
    ap.add_argument("--tpu-dtype", default="",
                    help="native-model compute dtype override "
                         "(e.g. bfloat16)")
    ap.add_argument("--pipeline", default="",
                    help="tpu_pipeline override (staged / onecall)")
    ap.add_argument("--real-only", action="store_true",
                    help="evaluate only the hand-transcribed real images "
                         "(round-over-round comparable 122-line set)")
    ap.add_argument("--set", action="append", default=[],
                    help="extra ONNXPaddleOcr kwarg override key=value "
                         "(value auto-coerced int/float/str); repeatable")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    check_device("eval_heldout", args.device)
    model = build_model(args)

    sets = [("real", REF_IMAGES, GROUND_TRUTH)]
    gt_path = os.path.join(SYNTH_DIR, "gt.json")
    if os.path.exists(gt_path) and not args.real_only:
        with open(gt_path) as f:
            sets.append(("synth", SYNTH_DIR, json.load(f)))

    per_image = {}
    subtotals = {}
    sims, exact, found, total = [], 0, 0, 0
    for set_name, img_dir, gt_map in sets:
        s_sims, s_exact, s_found, s_total = [], 0, 0, 0
        for fname, gt_lines in gt_map.items():
            img = imread(os.path.join(img_dir, fname))
            if img is None:
                continue
            result = model.ocr(img)
            preds = [entry[1][0] for entry in (result[0] or [])]
            rows = []
            for gt in gt_lines:
                best, best_sim = "", 0.0
                for p in preds:
                    s = similarity(gt, p)
                    if s > best_sim:
                        best, best_sim = p, s
                s_sims.append(best_sim)
                s_exact += int(best_sim == 1.0)
                s_found += int(best_sim >= 0.5)
                s_total += 1
                rows.append({"gt": gt, "pred": best,
                             "sim": round(best_sim, 3)})
            per_image[fname] = rows
            if args.verbose:
                for r in rows:
                    print(f"  {fname}: gt={r['gt']!r} pred={r['pred']!r} "
                          f"sim={r['sim']}")
        sims += s_sims
        exact += s_exact
        found += s_found
        total += s_total
        subtotals[set_name] = {
            "gt_lines": s_total,
            "line_recall@0.5": round(s_found / max(s_total, 1), 3),
            "char_accuracy": round(sum(s_sims) / max(len(s_sims), 1), 3),
            "exact_match": s_exact,
        }

    summary = {
        "model": args.model,
        "gt_lines": total,
        "line_recall@0.5": round(found / max(total, 1), 3),
        "char_accuracy": round(sum(sims) / max(len(sims), 1), 3),
        "exact_match": exact,
        "subtotals": subtotals,
    }
    if args.json:
        print(json.dumps({"summary": summary, "per_image": per_image},
                         ensure_ascii=False))
    else:
        print(json.dumps(summary, ensure_ascii=False))
    return summary


if __name__ == "__main__":
    main()

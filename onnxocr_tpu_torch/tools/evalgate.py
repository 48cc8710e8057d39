"""The eval-gate ledger of the port: every checkpoint adoption or
rejection appends ONE JSON line to evalgates_torch.jsonl at the root of
the checkout (checkpoint sha256, the eval summary of eval_heldout —
combined and by set —, the decision, and enough context to re-run the
gate). Counterpart of the JAX package's tools/evalgate.py, whose ledger,
evalgates.jsonl, holds the JAX package's gates and is never written here.

Two modes:

  run  — run `python -m onnxocr_tpu_torch.tools.eval_heldout --json` with
         the given overrides on --device, parse its summary, append the
         line:
           python -m onnxocr_tpu_torch.tools.evalgate run --name r5_photo \\
               --rec-dir build/gate/rec.onnx --decision pending
  log  — ingest an eval JSON that was already produced:
           python -m onnxocr_tpu_torch.tools.evalgate log --name r5_photo \\
               --from-json build/gate/eval.json \\
               --rec-dir build/gate/rec.onnx --decision adopt

The ledger is append-only; a later line with the same name supersedes the
earlier decision (e.g. pending → adopt). Differences from the JAX tool:
`--device` (default cuda, passed to eval_heldout) and `--ledger` (default
evalgates_torch.jsonl).
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LEDGER = os.path.join(REPO, "evalgates_torch.jsonl")


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def ckpt_hashes(args) -> dict:
    out = {}
    for kind, model_dir in (("det", args.det_dir), ("rec", args.rec_dir)):
        if not model_dir:
            continue
        npz = os.path.join(os.path.dirname(model_dir), "native_params.npz")
        if os.path.exists(npz):
            out[kind] = {"path": os.path.relpath(npz, REPO),
                         "sha256": sha256_file(npz)[:16]}
    return out


def git_head() -> str:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
            text=True, stderr=subprocess.DEVNULL).strip()
    except Exception:
        return "unknown"


def append(entry: dict, ledger: str = None):
    with open(ledger or LEDGER, "a") as f:
        f.write(json.dumps(entry, ensure_ascii=False) + "\n")
    print(json.dumps(entry, ensure_ascii=False))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["run", "log"])
    ap.add_argument("--name", required=True,
                    help="gate label, e.g. r5_photo_rec")
    ap.add_argument("--det-dir", default="")
    ap.add_argument("--rec-dir", default="")
    ap.add_argument("--model", default="PP-OCRv5")
    ap.add_argument("--set", action="append", default=[],
                    help="extra kwarg override passed to eval_heldout")
    ap.add_argument("--from-json", default="",
                    help="log mode: eval_heldout --json output file")
    ap.add_argument("--decision", default="pending",
                    choices=["pending", "adopt", "reject"])
    ap.add_argument("--notes", default="")
    ap.add_argument("--device", default="cuda",
                    help="run mode: eval_heldout's --device")
    ap.add_argument("--ledger", default=LEDGER)
    args = ap.parse_args(argv)

    if args.mode == "run":
        cmd = [sys.executable, "-m", "onnxocr_tpu_torch.tools.eval_heldout",
               "--json", "--model", args.model, "--device", args.device]
        if args.det_dir:
            cmd += ["--det-dir", args.det_dir]
        if args.rec_dir:
            cmd += ["--rec-dir", args.rec_dir]
        for s in args.set:
            cmd += ["--set", s]
        out = subprocess.check_output(cmd, cwd=REPO, text=True)
        payload = json.loads(out.strip().splitlines()[-1])
    else:
        with open(args.from_json) as f:
            payload = json.loads(f.read().strip().splitlines()[-1])

    summary = payload.get("summary", payload)
    entry = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "name": args.name,
        "git_head": git_head(),
        "model": args.model,
        "overrides": {k: v for k, v in
                      (("det_dir", args.det_dir),
                       ("rec_dir", args.rec_dir),
                       ("set", args.set)) if v},
        "checkpoints": ckpt_hashes(args),
        "summary": {k: summary.get(k) for k in
                    ("gt_lines", "line_recall@0.5", "char_accuracy",
                     "exact_match", "subtotals")},
        "decision": args.decision,
        "notes": args.notes,
    }
    append(entry, args.ledger)
    return entry


if __name__ == "__main__":
    main()

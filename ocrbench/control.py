"""The readings the limits of `correct` are set from, on the card:

    python3 -m ocrbench.control --workload <name> --seeds <n> [<n> ...] \
        [--control-seeds <n> ...] [--seconds 3]

For each seed, one run of the cell as the benchmark makes it (its traffic,
its depth, a short window opened at once: the readings time nothing) and
the reference's numbers; then the control:
the same with the program's own bfloat16 path switched on
(`tpu_dtype='bfloat16'`, the nearest precision below the float32 the
configurations state), which has to come out not correct. One process
serves every seed of a side, so the set-up is paid once a side. Each
reading is one JSON line on standard output: the numbers, `verdict` (the
numbers against the cell's limits file as it stands, check.verdict: what
decides `correct` in a run of the benchmark), and apart from it
`answered` (pages, or lines, answered inside the short window) and the
run's `correct`, which also needs work answered inside the window."""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

from . import check, run, spec

CONTROL = {"tpu_dtype": "bfloat16"}


def readings(cell, seeds, seconds: float, extra=None, device="cuda"):
    session = run.Session(cell, extra, device=device)
    out = []
    try:
        for seed in seeds:
            res, nums, e2e = run.run_once(cell, seed, seconds, False,
                                          session=session, device=device,
                                          warm=False)
            ok, _ = check.verdict(nums, cell.limits)
            rate = next(v["value"] for k, v in e2e.items()
                        if k != "setup_s")
            out.append({"seed": seed, "verdict": bool(ok),
                        "answered": round(rate * seconds),
                        "correct": res["correct"],
                        "failed": res["failed"], "numbers": nums})
            run.note(f"reading {json.dumps(out[-1])}")
    finally:
        session.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    run.prepare_process()
    for side, seeds, extra in (("program", args.seeds, None),
                               ("control", args.control_seeds, CONTROL)):
        if not seeds:
            continue
        with open(os.devnull, "w") as sink, \
                contextlib.redirect_stdout(sink):
            rows = readings(cell, seeds, args.seconds, extra)
        for r in rows:
            print(json.dumps(dict(r, side=side, workload=args.workload)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

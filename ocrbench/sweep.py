"""One traced run of a cell at another depth, for the sweep that set the
traffic's `in_flight`:

    python3 -m ocrbench.sweep --workload <name> --depth <n> --seed <n> \
        --seconds <s>

prints one JSON line: the depth, the rate of pages (or lines) answered in
the window, and the traced run's per-layer metrics and device entry."""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

from . import run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--depth", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    cell.traffic["load"]["in_flight"] = args.depth
    run.prepare_process()
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        res, _, e2e = run.run_once(cell, args.seed, args.seconds, True)
    print(json.dumps({"workload": args.workload, "depth": args.depth,
                      "rate": e2e, "correct": res["correct"],
                      "metrics": res["metrics"], "device": res["device"],
                      "breakdown": res.get("breakdown"),
                      "checked": res["checked"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

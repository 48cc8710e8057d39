"""Time the image codec's decode on the host, for one checkout or several
side by side in one session (before and after a codec change, on the same
host and the same files).

    python -m onnxocr_tpu_torch.tools.time_imdecode FILE...
        [--roots DIR...] [--rounds 21] [--device cuda|cpu]

For each root in the order given (default: this checkout; list a root
twice to interleave, e.g. `--roots old . . old`) a child process imports
that root's onnxocr_tpu_torch (its codec built into the root's own
build/host/ at first use), decodes each file once untimed, then times
--rounds calls of `imcodec.imdecode`. Prints one JSON line: {"runs":
[{"root", "files": {path: {"shape", "ms_median", "ms_min"}}}, ...]}
(shape null where that codec gives None).

The work is host-side; --device is checked as at every entry point of the
port: without CUDA and without --device cpu it exits.
"""
import argparse
import json
import os
import subprocess
import sys

from .. import bench

_CHILD = r"""
import json, sys, time
from onnxocr_tpu_torch.utils import imcodec
rounds, out = int(sys.argv[1]), {}
for path in sys.argv[2:]:
    blob = open(path, "rb").read()
    img = imcodec.imdecode(blob)
    ms = []
    for _ in range(rounds):
        t = time.perf_counter()
        imcodec.imdecode(blob)
        ms.append((time.perf_counter() - t) * 1e3)
    ms.sort()
    out[path] = {"shape": None if img is None else list(img.shape),
                 "ms_median": ms[len(ms) // 2], "ms_min": ms[0]}
print(json.dumps(out))
"""


def time_root(root: str, files, rounds: int) -> dict:
    """{path: {"shape", "ms_median", "ms_min"}} for the codec of `root`."""
    root = os.path.abspath(root)
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(rounds)] +
        [os.path.abspath(f) for f in files],
        cwd=root, env=env, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"time_imdecode: {root}: rc {proc.returncode}\n"
                         f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="+")
    ap.add_argument("--roots", nargs="+", default=[str(bench.REPO)])
    ap.add_argument("--rounds", type=int, default=21)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from .eval_heldout import check_device
    check_device("time_imdecode", args.device)
    runs = [{"root": root, "files": time_root(root, args.files, args.rounds)}
            for root in args.roots]
    print(json.dumps({"runs": runs}))


if __name__ == "__main__":
    main()

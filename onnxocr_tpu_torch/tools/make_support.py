"""Write `<dict>.trained_support.json` sidecars: the dictionary indices the
synthetic renderer can draw with the bundled fonts (and the blank), as the
JAX package's tools/make_support.py writes them. The native recognisers
are trained on exactly this label space (train/synth.TextRenderer's
coverage), so decoding masks everything else (pipeline/backends.
trained_support, config tpu_decode_support).

    python -m onnxocr_tpu_torch.tools.make_support [--out-dir DIR]
        [--device cuda|cpu]

For each of the two dictionaries (DICTS, found as the package finds its
assets: ONNXOCR_TPU_ASSETS, then onnxocr_tpu/assets) it writes
DIR/<dict>.trained_support.json, {"dict", "n", "indices", "chars"}, or
prints "skip (missing): <dict>". DIR defaults to build/support/ (the JAX
tool overwrites the committed sidecars under onnxocr_tpu/assets/). The
work is host-side (the renderer's font coverage); --device is checked as
at every entry point of the port: without CUDA and without --device cpu it
exits.
"""
import argparse
import json
import os

from .. import bench

DICTS = ("ppocrv5/ppocrv5_dict.txt",
         "ch_ppocr_server_v2.0/ppocr_keys_v1.txt")
OUT_DIR = bench.REPO / "build" / "support"


def support(dict_path: str, rel: str) -> dict:
    """The sidecar of the dictionary at `dict_path` (named `rel`)."""
    from ..train import synth
    c2i = synth.charset_from_dict(dict_path, charset=None)
    r = synth.TextRenderer(char_to_idx=c2i)
    indices = sorted({0} | {c2i[c] for c in r.charset})
    chars = "".join(sorted(r.charset))
    return {"dict": rel, "n": len(indices), "indices": indices,
            "chars": chars}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from .eval_heldout import check_device
    check_device("make_support", args.device)

    from .. import config as cfg
    for rel in DICTS:
        path = cfg.find_asset(rel)
        if not os.path.exists(path):
            print(f"skip (missing): {rel}")
            continue
        side = support(path, rel)
        out = os.path.join(args.out_dir, rel + ".trained_support.json")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(side, f, ensure_ascii=False)
        print(f"{out}: {side['n']} supported indices "
              f"({len(side['chars'])} renderable chars)")


if __name__ == "__main__":
    main()

"""The shear-staged crop warp with its gather leg done two ways, timed in
turns on one NVIDIA GPU on the crop matrices that held-out pages give the
warps of path B (one-call: 48 rec crops of 48 × 640) and of path A (staged
device-det: cls crops of 48 × 192, rec crops per width bucket).

    python3 ab_warp.py [--pages N] [--out FILE]

  where      what onnxocr_tpu_torch.ops.warp.warp_crops does: every crop is
             gathered too and torch.where keeps the shear form's crop where
             it may (no host sync, so a CUDA graph can hold the call);
  compacted  only the live crops the shear form cannot take are gathered,
             as one exact-size batch found by torch.nonzero (one host sync
             a call);
  off        the gather form alone, for scale.

The two shear variants are first held to each other bit for bit. Each is
timed by CUDA events around 20 eager calls (`ms`: the host's launches and
the sync included, what a page pays) in the order where, compacted,
compacted, where; `where` and `off` also in a CUDA graph (`graph_ms`: the
card's own time). Prints the card's name and power limit, a line per warp
call, the means per path and crop kind, and one JSON object; --out also
writes it to a file.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

import chip_smoke


def compacted(image, mats, vw, out_h: int, out_w: int):
    """The shear form with an exact-size gather of the crops it cannot take
    (the same crops as warp_crops(..., "bilinear", "shear"))."""
    import torch
    from onnxocr_tpu_torch.ops import warp
    *coeffs, elig = warp._shear_affine(mats, vw, out_h)
    vals = warp._staged_shear(image, coeffs, vw, out_h, out_w)
    idx = torch.nonzero(~elig & (vw > 0))[:, 0]  # the host sync
    if len(idx):
        vals = vals.index_copy(0, idx, warp._gather(
            image, mats[idx], vw[idx], out_h, out_w, "bilinear"))
    return warp.to_crops(vals, vw, out_w)


def time_call(image, mats, vw, out_h: int, out_w: int) -> dict:
    import torch
    from onnxocr_tpu_torch.ops import warp
    args = (image, mats, vw, out_h, out_w)
    forms = {"where": lambda: warp.warp_crops(*args, "bilinear", "shear"),
             "compacted": lambda: compacted(*args),
             "off": lambda: warp.warp_crops(*args, "bilinear", False)}
    assert torch.equal(forms["where"](), forms["compacted"]()), \
        "the two shear variants differ"
    live = vw > 0
    ms = {"where": [], "compacted": []}
    for name in ("where", "compacted", "compacted", "where"):
        ms[name].append(chip_smoke.timed(forms[name]))
    return dict(shape=[int(mats.shape[0]), out_h, out_w],
                crops=int(live.sum()),
                eligible=int((warp._shear_mask(mats, vw, out_h) & live).sum()),
                where_ms=ms["where"], compacted_ms=ms["compacted"],
                off_ms=chip_smoke.timed(forms["off"]),
                where_graph_ms=chip_smoke.graph_timed(forms["where"]),
                off_graph_ms=chip_smoke.graph_timed(forms["off"]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pages", type=int, default=len(chip_smoke.PAGES))
    ap.add_argument("--out")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_warp: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    from onnxocr_tpu_torch import ONNXPaddleOcr, config
    from onnxocr_tpu_torch.ops.kernels import build
    from onnxocr_tpu_torch.utils.png import read_bgr
    build.build_all()
    heldout = config.ASSETS.parent / "test_images_heldout"
    names = chip_smoke.PAGES[:opts.pages]
    entries = []
    with tempfile.TemporaryDirectory() as tmp:
        dict_path = os.path.join(tmp, "ppocrv5_dict.txt")
        with open(dict_path, "w") as f:
            f.write("".join(f"<{i}>\n" for i in range(18383)))
        paths = (("B", dict(tpu_pipeline="onecall", use_angle_cls=False),
                  False),
                 ("A", dict(tpu_pipeline="staged",
                            tpu_det_postprocess="device",
                            tpu_db_reduce="pallas", use_angle_cls=True,
                            tpu_allow_untrained=True), True))
        for label, kw, cls in paths:
            ocr = ONNXPaddleOcr(device="cuda", rec_char_dict_path=dict_path,
                                **kw)
            for name in names:
                page = read_bgr(str(heldout / f"{name}.png"))
                for call in chip_smoke.warp_calls(ocr, page, cls):
                    e = dict(path=label, page=name, **time_call(*call))
                    e["kind"] = "cls" if e["shape"][2] == 192 else "rec"
                    entries.append(e)
                    print(f"path {label} {name} {e['kind']} {e['shape']}: "
                          f"{e['eligible']} of {e['crops']} eligible; ms "
                          f"where {e['where_ms']}, compacted "
                          f"{e['compacted_ms']}, off {e['off_ms']:.4f}; "
                          f"graph where {e['where_graph_ms']:.4f}, off "
                          f"{e['off_graph_ms']:.4f}")
    summary = {}
    for key in sorted({(e["path"], e["kind"]) for e in entries}):
        sel = [e for e in entries if (e["path"], e["kind"]) == key]
        mean = {k: float(np.mean([np.mean(e[k]) for e in sel]))
                for k in ("where_ms", "compacted_ms", "off_ms",
                          "where_graph_ms", "off_graph_ms")}
        summary[" ".join(key)] = dict(
            calls=len(sel), crops=sum(e["crops"] for e in sel),
            eligible=sum(e["eligible"] for e in sel), **mean)
        print(f"path {key[0]} {key[1]}, mean of {len(sel)} calls: " +
              ", ".join(f"{k} {v:.4f}" for k, v in mean.items()))
    result = {"card": card, "summary": summary, "entries": entries}
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

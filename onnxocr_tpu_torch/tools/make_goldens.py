"""Capture the port's golden pipeline outputs for regression testing:
boxes, texts and scores of the full pipeline on deterministic synthetic
pages (eval_e2e.render_page), stored in tests/goldens_torch.json and
replayed by tests/test_torch_goldens.py and the chip smoke. Counterpart of
the JAX package's tools/make_goldens.py, with its rule that goldens are
captured on the platform the test replays on: capture() runs the port at
device='cpu'.

Usage:
  python -m onnxocr_tpu_torch.tools.make_goldens [--out <file>]

Differences from the JAX tool: it writes tests/goldens_torch.json, never
tests/goldens.json (the JAX test's). PP-OCRv5's dictionary is not in the
repository, so the goldens are captured on a stand-in written to
build/goldens/ppocrv5/ppocrv5_dict.txt (the renderer's characters, one a
line, then placeholders to PP-OCRv5's 18383 lines; named so that the
committed trained-support sidecar applies), with the seeded untrained
angle classifier and the six DejaVu faces every machine of the port has
(the renderer's other faces depend on the machine); the file records all
three. Capture it again once ppocrv5_dict.txt is committed.
"""
import argparse
import hashlib
import json
import os
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN_PATH = os.path.join(REPO, "tests", "goldens_torch.json")
STANDIN_PATH = os.path.join(REPO, "build", "goldens", "ppocrv5",
                            "ppocrv5_dict.txt")
SEEDS = (100, 101, 102)
DICT_LINES = 18383
MODEL_KWARGS = dict(use_angle_cls=True, use_gpu=False, drop_score=0.3,
                    det_limit_side_len=640, tpu_det_bucket=320,
                    tpu_allow_untrained=True)


def golden_fonts():
    """The six DejaVu faces of the renderer (utils/font.dejavu_path: the
    system's file, else the committed copy of the same bytes)."""
    from ..utils import font
    return [font.dejavu_path(name) for name in (
        "DejaVuSans.ttf", "DejaVuSans-Bold.ttf", "DejaVuSerif.ttf",
        "DejaVuSerif-Bold.ttf", "DejaVuSansMono.ttf",
        "DejaVuSansMono-Bold.ttf")]


def standin_dict(path: str = STANDIN_PATH) -> str:
    """Write the stand-in dictionary: the renderer's DEFAULT_CHARSET, one
    character a line, then "<i>" placeholders to DICT_LINES lines."""
    from ..train import synth
    chars = list(dict.fromkeys(synth.DEFAULT_CHARSET))
    lines = chars + [f"<{i}>" for i in range(DICT_LINES - len(chars))]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write("".join(line + "\n" for line in lines))
    os.replace(tmp, path)
    return path


def build_model(dict_path: str, device: str = "cpu"):
    from ..pipeline.api import ONNXPaddleOcr
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ONNXPaddleOcr(device=device, rec_char_dict_path=dict_path,
                             **MODEL_KWARGS)


def page_results(model, seed: int, dict_path: str) -> dict:
    """One seed's page through the model: its truths and the results in
    the JAX tool's layout (box, text, score to 4 places)."""
    from .eval_e2e import render_page
    page, truths = render_page(seed, dict_path=dict_path,
                               fonts=golden_fonts())
    res = model.ocr(page)
    return {
        "truths": [t for t, _ in truths],
        "results": [
            {"box": np.asarray(line[0], dtype=np.float64).tolist(),
             "text": line[1][0], "score": round(float(line[1][1]), 4)}
            for line in (res[0] or [])
        ],
    }


def capture(out: str = GOLDEN_PATH, seeds=SEEDS, dict_path: str = None
            ) -> dict:
    """Capture the goldens of `seeds` at device='cpu' into `out`."""
    dict_path = dict_path or standin_dict()
    model = build_model(dict_path, "cpu")
    with open(dict_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    goldens = {
        "captured_on": {
            "device": "cpu",
            "dictionary": "stand-in: make_goldens.standin_dict (the "
                          "renderer's DEFAULT_CHARSET, then placeholders "
                          "to 18383 lines); capture again once "
                          "ppocrv5_dict.txt is committed",
            "dictionary_sha256": digest,
            "classifier": "seeded untrained (tpu_allow_untrained)",
            "fonts": [os.path.basename(p) for p in golden_fonts()],
            "model_kwargs": MODEL_KWARGS,
        },
        "pages": {str(seed): page_results(model, seed, dict_path)
                  for seed in seeds},
    }
    with open(out, "w", encoding="utf-8") as f:
        json.dump(goldens, f, ensure_ascii=False, indent=1)
    print("wrote", out)
    for seed, g in goldens["pages"].items():
        print(seed, [r["text"] for r in g["results"]])
    return goldens


def replay(goldens: dict, seed: str, model=None, device: str = "cpu"
           ) -> list:
    """Re-run one seed of `goldens` on `device` (the CPU, where they were
    captured) and hold it to them: texts equal, boxes within 1 px, scores
    within 1e-3. → the mismatches, empty when the seed reproduces."""
    dict_path = standin_dict()
    with open(dict_path, "rb") as f:
        if hashlib.sha256(f.read()).hexdigest() != \
                goldens["captured_on"]["dictionary_sha256"]:
            raise ValueError("the stand-in dictionary differs from the one "
                             "the goldens were captured on")
    model = model or build_model(dict_path, device)
    got = page_results(model, int(seed), dict_path)["results"]
    want = goldens["pages"][seed]["results"]
    bad = []
    if [r["text"] for r in got] != [r["text"] for r in want]:
        bad.append(f"seed {seed}: texts {[r['text'] for r in got]} != "
                   f"{[r['text'] for r in want]}")
        return bad
    for g, w in zip(got, want):
        off = float(np.abs(np.asarray(g["box"]) - np.asarray(w["box"])).max())
        if off > 1.0:
            bad.append(f"seed {seed} {w['text']!r}: box off by {off} px")
        if abs(g["score"] - w["score"]) > 1e-3:
            bad.append(f"seed {seed} {w['text']!r}: score {g['score']} != "
                       f"{w['score']}")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=GOLDEN_PATH)
    args = ap.parse_args(argv)
    capture(args.out)


if __name__ == "__main__":
    main()

"""Generate the held-out synthetic eval set: the port of the JAX package's
tools/make_heldout_synth.py, which draws its pages with matplotlib and
degrades them with PIL. The same seed gives the same pages and gt.json.

    python -m onnxocr_tpu_torch.tools.make_heldout_synth
        [--outdir build/test_images_heldout] [--seed 20260819]
        [--device cuda|cpu]

24 pages (7 doc, 5 table, 4 scan, 4 photo, 2 lowcontrast, 2 dense) of
900 x 680 with lines of words, amounts, codes, dates and labelled fields
in STIXGeneral (regular, bold, italic, bold italic) and Computer Modern
cmr10, written as synth_<nn>_<style>.png with their lines in gt.json. The
figure is utils/mpl_page.py (matplotlib's Agg text and rules, FreeType
2.6.1's auto-hinter through utils/ft2font.py) and the degradations are
utils/pil_ops.py and the codec's JPEG (PIL's rotate, GaussianBlur and
JPEG round trip); numpy's default_rng draws in the JAX tool's order.

--outdir defaults to build/test_images_heldout/ (the JAX tool writes the
committed onnxocr_tpu/test_images_heldout/). The work is host-side;
--device is checked as at every entry point of the port: without CUDA and
without --device cpu it exits.
"""
import argparse
import json
import os
import string

import numpy as np

from .. import bench
from ..utils import ft2font, imcodec, mpl_page, pil_ops

OUT_DIR = bench.REPO / "build" / "test_images_heldout"

HELD_OUT_FONTS = [
    ft2font.STIX_REGULAR,
    ft2font.STIX_BOLD,
    ft2font.STIX_ITALIC,
    ft2font.STIX_BOLD_ITALIC,
    ft2font.CMR10,
]

WORDS = ("report total amount invoice date name address payment due tax "
         "order number item quantity price unit description balance page "
         "account summary client vendor terms net gross shipping contact "
         "reference signature approved department project status active "
         "results value range units test sample method analysis final").split()

PLAN = (["doc"] * 7 + ["table"] * 5 + ["scan"] * 4 + ["photo"] * 4 +
        ["lowcontrast"] * 2 + ["dense"] * 2)


def _rand_line(rng):
    kind = rng.integers(0, 5)
    if kind == 0:     # sentence-ish
        n = int(rng.integers(2, 6))
        ws = [WORDS[int(rng.integers(0, len(WORDS)))] for _ in range(n)]
        if rng.random() < 0.4:
            ws[0] = ws[0].capitalize()
        return " ".join(ws)
    if kind == 1:     # number / amount
        v = rng.random() * 10 ** int(rng.integers(1, 7))
        return f"{v:,.2f}" if rng.random() < 0.6 else f"{int(v):,}"
    if kind == 2:     # code
        n = int(rng.integers(5, 11))
        alpha = string.ascii_uppercase + string.digits
        s = "".join(alpha[int(rng.integers(0, len(alpha)))]
                    for _ in range(n))
        if rng.random() < 0.4:
            s = s[:3] + "-" + s[3:]
        return s
    if kind == 3:     # date / time / percent
        r = rng.random()
        if r < 0.33:
            return "%04d-%02d-%02d" % (rng.integers(1990, 2030),
                                       rng.integers(1, 13),
                                       rng.integers(1, 29))
        if r < 0.66:
            return "%02d:%02d:%02d" % (rng.integers(0, 24),
                                       rng.integers(0, 60),
                                       rng.integers(0, 60))
        return "%.2f%%" % (rng.random() * 100)
    # labelled field
    w = WORDS[int(rng.integers(0, len(WORDS)))].upper()
    return f"{w}: {int(rng.integers(1, 99999))}"


def _render_page(rng, style, size=(900, 680)):
    """One page: (RGB uint8, lines), drawing from `rng` as the JAX tool."""
    W, H = size
    dpi = mpl_page.DPI
    bg = 1.0 if style != "lowcontrast" else 0.72
    page = mpl_page.Page(W, H, bg)
    fonts = HELD_OUT_FONTS
    lines = []
    ink = 0.05 if style != "lowcontrast" else 0.38

    if style == "table":
        rows = int(rng.integers(8, 12))
        cols = 3
        x_edges = np.linspace(60, W - 60, cols + 1)
        y0, row_h = 70, (H - 140) / rows
        for r in range(rows + 1):
            page.rule([60, W - 60], [y0 + r * row_h] * 2, ink, 0.8)
        for xe in x_edges:
            page.rule([xe, xe], [y0, y0 + rows * row_h], ink, 0.8)
        for r in range(rows):
            for c in range(cols):
                if rng.random() < 0.15:
                    continue
                t = _rand_line(rng)
                fp = fonts[int(rng.integers(0, len(fonts)))]
                px = int(rng.integers(13, 20))
                page.text(x_edges[c] + 8, y0 + (r + 0.62) * row_h, t, fp,
                          px * 72 / dpi, ink, "baseline")
                lines.append(t)
    else:
        n = int(rng.integers(10, 16)) if style != "dense" else \
            int(rng.integers(18, 24))
        y = 50.0
        while len(lines) < n and y < H - 40:
            t = _rand_line(rng)
            fp = fonts[int(rng.integers(0, len(fonts)))]
            px = int(rng.integers(14, 34)) if style != "dense" else \
                int(rng.integers(11, 16))
            x = float(rng.integers(40, max(41, W // 3)))
            page.text(x, y, t, fp, px * 72 / dpi, ink, "top")
            lines.append(t)
            y += px * 1.8 + float(rng.integers(2, 14))
        # headline
        if style == "doc" and rng.random() < 0.7:
            t = _rand_line(rng).upper()
            page.text(W * 0.32, 14, t, fonts[1], 22 * 72 / dpi, ink, "top")
            lines.append(t)

    return page.draw(), lines


def _degrade(img, rng, style):
    """The post-render degradations, drawing from `rng` as the JAX tool."""
    out = img.astype(np.float32)
    if style in ("scan", "dense"):
        out += rng.normal(0, 6, out.shape)         # sensor noise
    if style == "scan":
        # slight rotation + JPEG roundtrip, like a desk scanner
        pil = np.clip(out, 0, 255).astype(np.uint8)
        pil = pil_ops.rotate(pil, float(rng.uniform(-1.2, 1.2)),
                             fillcolor=(255, 255, 255))
        quality = int(rng.integers(55, 80))
        jpeg = imcodec.imencode_jpeg(np.ascontiguousarray(pil[:, :, ::-1]),
                                     quality)
        out = imcodec.jpeg_pil_rgb(jpeg).astype(np.float32)
    if style == "photo":
        # brightness gradient + vignette-ish shading + blur
        h, w = out.shape[:2]
        gx = np.linspace(-1, 1, w)[None, :, None]
        gy = np.linspace(-1, 1, h)[:, None, None]
        shade = 1.0 - 0.18 * (gx * float(rng.uniform(-1, 1)) +
                              gy * float(rng.uniform(-1, 1)))
        out = out * shade
        pil = np.clip(out, 0, 255).astype(np.uint8)
        pil = pil_ops.gaussian_blur(pil, float(rng.uniform(0.4, 1.0)))
        out = pil.astype(np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)


def generate(outdir, seed: int = 20260819, log=print) -> dict:
    """Write the pages and gt.json into `outdir`; → gt."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    gt = {}
    total = 0
    for i, style in enumerate(PLAN):
        img, lines = _render_page(rng, style)
        img = _degrade(img, rng, style)
        name = "synth_%02d_%s.png" % (i, style)
        with open(os.path.join(outdir, name), "wb") as f:
            f.write(imcodec.imencode_png(np.ascontiguousarray(
                img[:, :, ::-1])))
        gt[name] = lines
        total += len(lines)
        log(name, len(lines), "lines")
    with open(os.path.join(outdir, "gt.json"), "w") as f:
        json.dump(gt, f, ensure_ascii=False, indent=1)
    log("pages=%d lines=%d -> %s" % (len(PLAN), total, outdir))
    return gt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--outdir", default=str(OUT_DIR))
    ap.add_argument("--seed", type=int, default=20260819)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from .eval_heldout import check_device
    check_device("make_heldout_synth", args.device)
    generate(args.outdir, args.seed)


if __name__ == "__main__":
    main()

"""The one traffic generator. A traffic mix is a JSON file of parameters
under ocrbench/traffic/; its `kind` says what a request holds:

* "pages": scanned pages as PNG bytes, rendered from the DejaVu faces —
  text lines in one or two columns under a heading, skewed, on a noisy
  paper tone. Every seed gets the same pages in another order, so that
  the work of a run does not hang on its seed;
* "lines": requests of `per_request` line images (grey text on paper,
  BGR), heights and lengths drawn from ranges.

`make(traffic, seed)` → Traffic with the requests (`payloads`), the
images the reference reads (`images`, the pixels before encoding) and
the glyph-rendering share of the set-up."""
from __future__ import annotations

import concurrent.futures
import math
import os
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np

from . import png
from .ttf import Face

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FONT_DIR = os.path.join(REPO, "onnxocr_tpu_torch", "assets", "fonts",
                        "dejavu")
LOWER = "abcdefghijklmnopqrstuvwxyz"
UPPER = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
DIGITS = "0123456789"
PUNCT = ".,;:-()%"


@dataclass
class Traffic:
    kind: str
    payloads: List[object]       # what a request sends: bytes or lines
    images: List[object]         # the pixels the reference reads
    make_s: float = 0.0
    notes: dict = field(default_factory=dict)


def _word(shape: np.random.Generator, letters: np.random.Generator) -> str:
    """A word whose length and kind (digits, lower case, a capital, a
    trailing mark) come from `shape` and whose characters from
    `letters`."""
    n = int(min(12, 1 + shape.geometric(0.22)))
    kind = shape.random()
    mark = shape.random() < 0.12
    if kind < 0.08:
        return "".join(letters.choice(list(DIGITS), n))
    w = "".join(letters.choice(list(LOWER), n))
    if kind < 0.25:
        w = letters.choice(list(UPPER)) + w[1:]
    if mark:
        w += letters.choice(list(PUNCT))
    return w


def _faces(names):
    return [Face(os.path.join(FONT_DIR, n)) for n in names]


def _paste(canvas: np.ndarray, bitmap: np.ndarray, x: int, y: int,
           ink: float):
    """Darken canvas (float32 coverage of ink) with a glyph at (x, y) top
    left, clipped to the canvas."""
    h, w = bitmap.shape
    H, W = canvas.shape
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, W), min(y + h, H)
    if x1 <= x0 or y1 <= y0:
        return
    sub = bitmap[y0 - y:y1 - y, x0 - x:x1 - x] * ink
    np.maximum(canvas[y0:y1, x0:x1], sub, out=canvas[y0:y1, x0:x1])


def _text_width(face: Face, text: str, px: float) -> float:
    return sum(face.glyph(c, px)[3] for c in text)


def _draw_text(cov, face, text, px, x, y_base, rot, ink):
    """Glyph by glyph from (x, baseline y); rot = (cos, sin, cx, cy) turns
    each glyph's origin about the page centre (small skews: the glyph
    bitmaps themselves stay upright)."""
    c, s, cx, cy = rot
    for ch in text:
        bmp, left, top, adv = face.glyph(ch, px)
        if bmp.size:
            gx, gy = x + left, y_base - top
            rx = cx + c * (gx - cx) - s * (gy - cy)
            ry = cy + s * (gx - cx) + c * (gy - cy)
            _paste(cov, bmp, int(round(rx)), int(round(ry)), ink)
        x += adv


def _finish(cov: np.ndarray, rng, paper, noise: int) -> np.ndarray:
    """Coverage → grey uint8 page: paper tone, dark ink, uniform noise."""
    tone = float(rng.integers(paper[0], paper[1] + 1))
    ink = float(rng.integers(10, 40))
    grey = tone - cov * (tone - ink)
    grey += rng.integers(-noise, noise + 1, grey.shape, dtype=np.int16)
    return np.clip(grey, 0, 255).astype(np.uint8)


def _pages(p: dict, seed: int) -> Traffic:
    """The pool's pages, each fixed by the traffic's `layout_seed` and its
    number (type size, columns, line count, words, skew, face, paper,
    noise); the seed deals them in its own order. The det model finds
    200–1000 word fragments a scan, so letters and noise would move the
    work a page costs: every seed carries the same pages, in another
    order."""
    rng = np.random.default_rng(seed)
    pool = int(p["pool"])
    W, H = p["page"]["width"], p["page"]["height"]
    dpi = p["page"]["dpi"]
    t0 = time.perf_counter()
    body = _faces(p["faces"])
    heads = _faces(p["heading_faces"])
    lo, hi = p["lines"]
    counts = np.round(np.linspace(lo, hi, pool)).astype(int)
    payloads, images, finishing = [], [], []
    margin = int(p["margin_in"] * dpi)
    for i in rng.permutation(pool):
        shape = np.random.default_rng([int(p["layout_seed"]), int(i)])
        letters = np.random.default_rng([int(p["layout_seed"]), int(i), 1])
        cov = np.zeros((H, W), np.float32)
        skew = math.radians(shape.uniform(-p["skew_deg"], p["skew_deg"]))
        rot = (math.cos(skew), math.sin(skew), W / 2.0, H / 2.0)
        face = body[i % len(body)]
        size = p["body_pt"][i % len(p["body_pt"])]
        n_cols = p["columns"][(i // len(p["body_pt"])) % len(p["columns"])]
        px = size * dpi / 72.0
        hpx = p["heading_pt"] * dpi / 72.0
        heading = " ".join(_word(shape, letters)
                           for _ in range(shape.integers(2, 6)))
        y = margin + hpx
        _draw_text(cov, heads[i % len(heads)], heading.title(), hpx, margin,
                   int(y), rot, 1.0)
        y += hpx * 1.2
        n_lines = int(counts[i]) - 1
        per_col = -(-n_lines // n_cols)
        gutter = int(0.3 * dpi)
        col_w = (W - 2 * margin - (n_cols - 1) * gutter) / n_cols
        lead = min(px * p["leading"], (H - margin - y) / per_col)
        # words a line by their lengths at an average advance, so that
        # the letters do not move the line breaks
        em = px * p["advance_em"]
        drawn = 0
        for col in range(n_cols):
            x0 = margin + col * (col_w + gutter)
            for r in range(per_col):
                if drawn == n_lines:
                    break
                target = col_w * shape.uniform(*p["fill"])
                words, width = [], 0.0
                while True:
                    w = _word(shape, letters)
                    add = (len(w) + (1 if words else 0)) * em
                    if words and width + add > target:
                        break
                    words.append(w)
                    width += add
                _draw_text(cov, face, " ".join(words), px, x0,
                           int(y + px + r * lead), rot, 1.0)
                drawn += 1
        finishing.append((cov, letters))

    def finish(job):
        grey = _finish(job[0], job[1], p["paper"], int(p["noise"]))
        return grey, png.encode(grey, int(p.get("png_level", 1)))

    # the noise and zlib release the GIL: a thread a page
    with concurrent.futures.ThreadPoolExecutor(
            min(8, os.cpu_count() or 1)) as ex:
        for grey, data in ex.map(finish, finishing):
            images.append(grey)
            payloads.append(data)
    return Traffic("pages", payloads, images, time.perf_counter() - t0,
                   {"lines_drawn": sorted(int(c) for c in counts)})


def _lines(p: dict, seed: int) -> Traffic:
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    faces = _faces(p["faces"])
    n = int(p["pool"]) * int(p["per_request"])
    # heavy-tailed lengths: a log-uniform draw over the range, dealt from
    # one fixed set so every seed carries the same characters
    lo, hi = p["chars"]
    lengths = np.round(np.exp(np.linspace(math.log(lo), math.log(hi), n)))
    lengths = lengths.astype(int)[rng.permutation(n)]
    heights = np.linspace(p["height"][0], p["height"][1], n).astype(int)[
        rng.permutation(n)]
    lines = []
    for i in range(n):
        lrng = np.random.default_rng([seed, i])
        face = faces[lrng.integers(len(faces))]
        h = int(heights[i])
        px = h * p["em_of_height"]
        text = ""
        while len(text) < lengths[i]:
            text = (text + " " + _word(lrng, lrng)).strip()
        text = text[:lengths[i]]
        w = int(math.ceil(_text_width(face, text, px))) + 2 * int(0.2 * h)
        cov = np.zeros((h, w), np.float32)
        base = int(round(h * 0.5 + px * 0.35))
        _draw_text(cov, face, text, px, int(0.2 * h), base,
                   (1.0, 0.0, 0.0, 0.0), 1.0)
        grey = _finish(cov, lrng, p["paper"], int(p["noise"]))
        lines.append(np.repeat(grey[:, :, None], 3, axis=2))
    per = int(p["per_request"])
    reqs = [lines[i:i + per] for i in range(0, n, per)]
    return Traffic("lines", reqs, reqs, time.perf_counter() - t0,
                   {"widths": [int(x.shape[1]) for x in lines]})


def make(traffic: dict, seed: int) -> Traffic:
    kind = traffic["kind"]
    if kind == "pages":
        return _pages(traffic, seed)
    if kind == "lines":
        return _lines(traffic, seed)
    raise ValueError(f"unknown traffic kind {kind!r}")

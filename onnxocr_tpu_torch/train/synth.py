"""Synthetic OCR training data: rendered text lines and composed pages.
Counterpart of onnxocr_tpu/train/synth.py.

The same renderer on a machine without PIL, cv2 or fontTools: text drawn
by utils/font.py (FreeType's hinting and coverage, PIL's layout and
blending), every cv2 call through its twin in utils/cv_ops.py and
utils/imcodec.py, font coverage from utils/font.codepoints. The random
draws are the JAX package's numpy `default_rng(seed)` draws in the same
order, so one seed gives the same lines, pages and labels as the JAX
package's renderer on the same fonts and lexicon (tests/test_torch_synth.py;
the one twin that is not exact is the 4 × 4 → page cubic upscale of
`det_page_hard`'s background, which cv2 hands to IPP: ROADMAP §3).

Fonts: the six DejaVu faces resolve to the system's files where they exist,
else to the port's committed copies (utils/font.dejavu_path); the ten
matplotlib faces are read at the path the JAX package names and skipped
where that file is missing, as the JAX package skips it. The lexicon is
harvested from the installed packages' metadata, as the JAX package
harvests it, so both differ from machine to machine.
"""
from __future__ import annotations

import string
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import cv_ops, imcodec
from ..utils import font as ft

_MPL_TTF = ("/opt/venv/lib/python3.12/site-packages/matplotlib/"
            "mpl-data/fonts/ttf")
FONTS = [
    ft.dejavu_path("DejaVuSans.ttf"),
    ft.dejavu_path("DejaVuSans-Bold.ttf"),
    ft.dejavu_path("DejaVuSerif.ttf"),
    ft.dejavu_path("DejaVuSerif-Bold.ttf"),
    ft.dejavu_path("DejaVuSansMono.ttf"),
    ft.dejavu_path("DejaVuSansMono-Bold.ttf"),
    # matplotlib-bundled faces (style diversity beyond the 6 system
    # DejaVus): oblique/italic variants + Computer Modern. STIXGeneral*
    # and cmr10 are deliberately EXCLUDED — they are reserved for the
    # independent held-out page generator (the JAX package's
    # tools/make_heldout_synth.py),
    # so eval pages use fonts training never saw. Missing files are
    # skipped by the coverage scan below.
    _MPL_TTF + "/DejaVuSans-Oblique.ttf",
    _MPL_TTF + "/DejaVuSans-BoldOblique.ttf",
    _MPL_TTF + "/DejaVuSerif-Italic.ttf",
    _MPL_TTF + "/DejaVuSerif-BoldItalic.ttf",
    _MPL_TTF + "/DejaVuSansMono-Oblique.ttf",
    _MPL_TTF + "/DejaVuSansDisplay.ttf",
    _MPL_TTF + "/DejaVuSerifDisplay.ttf",
    _MPL_TTF + "/cmb10.ttf",
    _MPL_TTF + "/cmss10.ttf",
    _MPL_TTF + "/cmtt10.ttf",
]

DEFAULT_CHARSET = string.ascii_letters + string.digits + \
    " .,:;!?%()+-*/='\"&@#$"

# Fallback lexicon when no package metadata is readable on the host.
_FALLBACK_WORDS = (
    "the of and to in is for with on that this from by are was total "
    "amount date time name address account number invoice receipt item "
    "price tax cash card change due paid balance order code gate flight "
    "seat class serial test result range unit value table page report "
    "bank close open service terminal customer signature please thank "
    "you welcome store street city phone email note free sample data "
    "model type status check department hospital clinic normal high low "
    "reference method blood pressure weight size width height length "
    "quality quantity description product company limited group public "
    "national international airport station north south east west "
    "avenue road building floor room office center market square theatre "
    "museum palace royal arts grand hotel restaurant menu coffee tea "
    "january february march april may june july august september "
    "october november december monday tuesday wednesday thursday friday "
    "saturday sunday").split()


def _harvest_lexicon(max_words: int = 4000) -> List[str]:
    """English word list harvested from package metadata / license prose
    on the host (no egress, no dict files in this image). Deterministic
    given the filesystem; falls back to a built-in list."""
    import collections
    import glob
    import os
    import re
    import sysconfig
    counts: collections.Counter = collections.Counter()
    budget = 2_500_000
    roots: List[str] = []
    for base in {sysconfig.get_paths().get("purelib", ""),
                 sysconfig.get_paths().get("platlib", "")}:
        if base and os.path.isdir(base):
            roots.extend(sorted(glob.glob(
                os.path.join(base, "*.dist-info", "METADATA")))[:300])
            roots.extend(sorted(glob.glob(
                os.path.join(base, "*.dist-info", "LICENSE*")))[:100])
    for path in roots:
        if budget <= 0:
            break
        try:
            with open(path, "r", errors="ignore") as f:
                txt = f.read(min(budget, 200_000))
        except OSError:
            continue
        budget -= len(txt)
        counts.update(w.lower() for w in re.findall(r"[A-Za-z]{2,12}", txt))
    words = [w for w, c in counts.most_common(max_words * 2) if c >= 3]
    words = [w for w in words if len(w) >= 2][:max_words]
    return words if len(words) >= 200 else list(_FALLBACK_WORDS)


_LEXICON_CACHE: Optional[List[str]] = None


def _lexicon() -> List[str]:
    global _LEXICON_CACHE
    if _LEXICON_CACHE is None:
        _LEXICON_CACHE = _harvest_lexicon()
    return _LEXICON_CACHE


def _font_coverage(path) -> set:
    """Set of unicode codepoints a font file can actually draw, read from
    its cmap (fontTools' best subtable).  Falls back to an empty set when
    unreadable."""
    try:
        return ft.codepoints(path)
    except OSError:
        return set()


def _drawable(c: str) -> bool:
    """Filter out chars that would poison training data: combining marks,
    controls/format chars, non-space separators, and RTL scripts (PIL
    without raqm renders RTL text in logical order — visually wrong)."""
    import unicodedata
    if c == " ":
        return True
    cat = unicodedata.category(c)
    if cat[0] in ("M", "C") or cat.startswith("Z"):
        return False
    if unicodedata.bidirectional(c) in ("R", "AL", "AN"):
        return False
    return True


class TextRenderer:
    """Renders labelled text lines for det/rec training.

    ``charset`` may include any unicode chars; each font only draws the
    subset its cmap covers, so sampling is done per font: pick a font,
    then draw chars from that font's renderable subset.  With the full
    PP-OCRv5 dict this reaches ~1.3k chars (latin incl. extended, Greek,
    Cyrillic, arrows/symbols) — the trainable-charset ceiling of the
    DejaVu fonts in this image.  ``ascii_bias`` is the probability a line
    samples only from the latin/digit/punct core, mirroring real-corpus
    frequency so the common glyphs stay sharply trained.
    """

    def __init__(self, charset: Optional[str] = None,
                 char_to_idx: Optional[Dict[str, int]] = None,
                 seed: int = 0, ascii_bias: float = 0.5,
                 structured_frac: float = 0.0, lowres_frac: float = 0.0,
                 photo_frac: float = 0.0, dotmatrix_frac: float = 0.0,
                 fonts: Optional[Sequence[str]] = None):
        if charset is None:
            charset = ("".join(char_to_idx) if char_to_idx is not None
                       else DEFAULT_CHARSET)
        pool = [c for c in dict.fromkeys(charset)
                if (char_to_idx is None or c in char_to_idx) and _drawable(c)]
        self.char_to_idx = char_to_idx
        self.ascii_bias = ascii_bias
        self.structured_frac = structured_frac
        self.lowres_frac = lowres_frac
        self.photo_frac = photo_frac
        self.dotmatrix_frac = dotmatrix_frac
        self.rng = np.random.default_rng(seed)
        self._fonts = {}
        self._font_chars: Dict[Tuple[str, int], list] = {}
        self._font_sets: Dict[Tuple[str, int], set] = {}
        self._font_core: Dict[Tuple[str, int], list] = {}
        core = set(DEFAULT_CHARSET)
        covered = set()
        for path in (FONTS if fonts is None else fonts):
            cps = _font_coverage(path)
            chars = [c for c in pool if ord(c) in cps or c == " "]
            if not chars:
                continue
            for size in (20, 26, 32, 38, 44):
                try:
                    font = ft.FreeTypeFont(path, size)
                except OSError:
                    continue
                key = (path, size)
                self._fonts[key] = font
                self._font_chars[key] = chars
                self._font_sets[key] = set(chars)
                self._font_core[key] = [c for c in chars if c in core]
            covered.update(chars)
        assert self._fonts, "no usable fonts"
        # chars renderable by at least one font, in pool order
        self.charset = [c for c in pool if c in covered]
        cset = set(self.charset)
        # words usable for structured lines: every char renderable+mapped
        self._lexicon = [w for w in _lexicon()
                         if all(c in cset for c in w)] or ["no"]
        self._charset_set = cset

    def _pick_font(self) -> Tuple[str, int]:
        keys = list(self._fonts)
        return keys[int(self.rng.integers(len(keys)))]

    def random_text(self, max_len: int = 18,
                    font_key: Optional[Tuple[str, int]] = None) -> str:
        if font_key is None:
            pool = self.charset
        else:
            pool = self._font_chars[font_key]
            corepool = self._font_core[font_key]
            if corepool and self.rng.random() < self.ascii_bias:
                pool = corepool
        n = int(self.rng.integers(1, max_len + 1))
        chars = self.rng.choice(pool, size=n)
        return "".join(chars).strip() or pool[0]

    # ------------------------------------------- structured text sampling
    # Real pages (receipts, lab tables, boarding passes, shareholder
    # registers) are dominated by English-ish words, grouped integers,
    # decimals/percentages, dates, times, and alphanumeric codes — not
    # uniform glyph soup. Uniform sampling gives the CTC head a flat prior,
    # so at inference it freely substitutes visually-similar rare glyphs
    # (0→ð, 1→↿, ×→⚔) on exactly the text users photograph most. These
    # generators mirror the real token mix; the soup path stays (at
    # 1-structured_frac) so tail glyphs keep nonzero coverage.

    def _digit_run(self, n: int) -> str:
        return "".join(self.rng.choice(list("0123456789"), size=n))

    def _number_token(self) -> str:
        rng = self.rng
        r = rng.random()
        if r < 0.16:  # comma-grouped integer: 75,103 / 652,418,000
            s = str(int(rng.integers(1, 1000)))
            for _ in range(int(rng.integers(1, 4))):
                s += "," + self._digit_run(3)
            return s
        if r < 0.34:  # decimal, optionally a percentage: 15.40 / 3.3220%
            s = f"{int(rng.integers(0, 100))}.{self._digit_run(int(rng.integers(1, 5)))}"
            return s + "%" if rng.random() < 0.45 else s
        if r < 0.46:  # date: 2012-10-23 / 10-08-06 / 03DEC
            if rng.random() < 0.3:
                mon = ["JAN", "FEB", "MAR", "APR", "MAY", "JUN", "JUL",
                       "AUG", "SEP", "OCT", "NOV", "DEC"]
                return f"{int(rng.integers(1, 29)):02d}" + \
                    mon[int(rng.integers(0, 12))]
            y = rng.choice(["19" + self._digit_run(2),
                            "20" + self._digit_run(2), self._digit_run(2)])
            return f"{y}-{int(rng.integers(1, 13)):02d}-" \
                f"{int(rng.integers(1, 29)):02d}"
        if r < 0.56:  # time: 12:43:15 / 11:23
            s = f"{int(rng.integers(0, 24)):02d}:{int(rng.integers(0, 60)):02d}"
            return s + f":{int(rng.integers(0, 60)):02d}" \
                if rng.random() < 0.5 else s
        if r < 0.72:  # alphanumeric code: Z57A001950 / G7512 / ETKT78136
            n = int(rng.integers(3, 12))
            pool = list(string.ascii_uppercase + string.digits * 2)
            return "".join(rng.choice(pool, size=n))
        if r < 0.82:  # range: 0--40 / 114--240 (lab reference columns)
            a, b = sorted([int(rng.integers(0, 250)),
                           int(rng.integers(0, 250))])
            return f"{a}{rng.choice(['-', '--'])}{b}"
        if r < 0.9:  # plain integer run (IDs, counters)
            return self._digit_run(int(rng.integers(2, 12)))
        # arithmetic worksheet line: 2.4×0.2=
        cs = self._charset_set
        ops = [o for o in ("×", "÷", "+", "-", "*", "/") if o in cs] or ["+"]
        def num():
            if rng.random() < 0.6:
                return f"{int(rng.integers(0, 10))}.{self._digit_run(int(rng.integers(1, 3)))}"
            return str(int(rng.integers(0, 101)))
        return f"{num()}{rng.choice(ops)}{num()}="

    def _word_token(self) -> str:
        rng = self.rng
        w = self._lexicon[int(rng.integers(len(self._lexicon)))]
        r = rng.random()
        if r < 0.55:
            return w
        if r < 0.8:
            return w.capitalize()
        return w.upper()

    def random_structured(self, max_len: int,
                          font_key: Tuple[str, int]) -> str:
        """A words/numbers line ≤ max_len chars every char of which the
        chosen font draws (falls back to '' when nothing fits)."""
        rng = self.rng
        fset = self._font_sets[font_key]
        numeric = rng.random() < 0.45  # table/receipt column flavor
        parts: List[str] = []
        for _ in range(12):
            cur = len(" ".join(parts))
            if cur >= max_len - 1:
                break
            if numeric:
                tok = self._number_token() if rng.random() < 0.8 \
                    else self._word_token()
            else:
                tok = self._word_token() if rng.random() < 0.8 \
                    else self._number_token()
            if rng.random() < 0.12:  # trailing punctuation
                tok += str(rng.choice([",", ".", ":", ";", ")"]))
            if not all(c in fset for c in tok):
                continue
            if cur + bool(parts) + len(tok) > max_len:
                if parts:
                    break
                tok = tok[:max_len]
                if not all(c in fset for c in tok):
                    continue
            parts.append(tok)
            if rng.random() < 0.35 and parts:
                break
        return " ".join(parts).strip()

    def sample_line(self, max_len: int = 18) -> Tuple[str, Tuple[str, int]]:
        """Pick a font, then text the font can fully draw."""
        key = self._pick_font()
        if self.rng.random() < self.structured_frac:
            text = self.random_structured(max_len, key)
            if text:
                return text, key
        return self.random_text(max_len, font_key=key), key

    def render_line(self, text: str, height: int = 48,
                    max_width: int = 320,
                    font_key: Optional[Tuple[str, int]] = None,
                    return_alpha: bool = False) -> np.ndarray:
        """Render one text line into a (height, w<=max_width, 3) BGR uint8
        image with random colors/contrast/noise.

        return_alpha=True additionally returns the clean glyph coverage
        (height, w) float in [0, 1] for compositing text onto arbitrary
        backgrounds (det_page_hard)."""
        rng = self.rng
        if font_key is None:
            # pick among fonts that cover every char of the text
            cands = [k for k, chars in self._font_sets.items()
                     if all(c in chars for c in text)]
            keys = cands or list(self._fonts)
            font_key = keys[int(rng.integers(len(keys)))]
        font = self._fonts[font_key]
        # measure
        bbox = font.getbbox(text)
        tw = max(bbox[2] - bbox[0], 4)
        th = max(bbox[3] - bbox[1], 4)
        pad = int(rng.integers(2, 10))
        W, H = tw + 2 * pad, th + 2 * pad
        bg = int(rng.integers(120, 256))
        fg = int(rng.integers(0, max(1, bg - 70)))
        if rng.random() < 0.15:  # inverted text
            bg, fg = fg, bg
        img = np.full((H, W), bg, np.uint8)
        xy = (pad - bbox[0], pad - bbox[1])
        ft.draw_text(img, xy, text, fg, font)
        arr = img.astype(np.float32)
        alpha = None
        if return_alpha:
            am = np.zeros((H, W), np.uint8)
            ft.draw_text(am, xy, text, 255, font)
            alpha = am.astype(np.float32) / 255.0
        # noise + slight blur-ish jitter
        arr = arr + rng.normal(0, rng.uniform(1, 8), arr.shape)
        arr = np.clip(arr, 0, 255).astype(np.uint8)
        scale = height / H
        w = max(8, min(max_width, int(W * scale)))
        arr = cv_ops.resize_linear(arr, (w, height))
        if rng.random() < 0.3:
            k = int(rng.integers(1, 3)) * 2 + 1
            arr = cv_ops.gaussian_blur(arr, k)
        bgr = np.stack([arr] * 3, axis=-1)
        # random mild color cast
        cast = rng.uniform(0.85, 1.15, size=3)
        bgr = np.clip(bgr * cast, 0, 255).astype(np.uint8)
        if alpha is None and rng.random() < self.lowres_frac:
            # low-res degradation: real pages carry 8-20 px text that the
            # crop warp upscales to height 48 (held-out misses: tiny table
            # numbers, receipts) — simulate by a downscale→(optional JPEG
            # roundtrip)→upscale so the model trains on that blur.
            h2 = int(rng.integers(8, 22))
            w2 = max(4, int(round(w * h2 / height)))
            small = cv_ops.resize_area(bgr, (w2, h2))
            if rng.random() < 0.5:
                q = int(rng.integers(30, 85))
                small = imcodec.imdecode(imcodec.imencode_jpeg(small, q))
            up = cv_ops.resize_linear if rng.random() < 0.7 else \
                cv_ops.resize_nearest
            bgr = up(small, (w, height))
        if return_alpha:
            alpha = cv_ops.resize_linear(alpha, (w, height))
            return bgr, np.clip(alpha, 0.0, 1.0)
        return bgr

    def encode(self, text: str) -> List[int]:
        assert self.char_to_idx is not None
        return [self.char_to_idx[c] for c in text if c in self.char_to_idx]

    def add_margins(self, line: np.ndarray, height: int, max_width: int
                    ) -> np.ndarray:
        """Embed a tight text line into a looser crop, mimicking the
        geometry of DB-detected boxes after the 1.5 unclip (the pipeline's
        crops carry ~10-40% margins around the glyphs — and on dense pages
        those margins contain fragments of NEIGHBORING lines, so with some
        probability strips of other rendered text bleed into the top/bottom
        margins here too)."""
        rng = self.rng
        lh, lw = line.shape[:2]
        top = int(rng.uniform(0.0, 0.45) * lh)
        bot = int(rng.uniform(0.0, 0.45) * lh)
        left = int(rng.uniform(0.0, 0.3) * lh)
        right = int(rng.uniform(0.0, 0.3) * lh)
        bg = int(np.median(line[0]))
        framed = cv_ops.copy_make_border(line, top, bot, left, right,
                                         (bg, bg, bg))
        # neighbor-line clutter in the vertical margins
        if rng.random() < 0.5 and (top > 2 or bot > 2):
            ctext, cfont = self.sample_line(12)
            clutter = self.render_line(ctext,
                                       max(8, int(lh * rng.uniform(0.7,
                                                                   1.2))),
                                       framed.shape[1], font_key=cfont)
            ch_, cw_ = clutter.shape[:2]
            fw_ = framed.shape[1]
            x0 = int(rng.integers(0, max(1, fw_ - min(cw_, fw_) + 1)))
            if top > 2 and rng.random() < 0.8:
                k = min(top, ch_)
                framed[:k, x0:x0 + min(cw_, fw_ - x0)] = \
                    clutter[ch_ - k:, : min(cw_, fw_ - x0)]
            if bot > 2 and rng.random() < 0.8:
                k = min(bot, ch_)
                framed[-k:, x0:x0 + min(cw_, fw_ - x0)] = \
                    clutter[:k, : min(cw_, fw_ - x0)]
        fh, fw = framed.shape[:2]
        scale = height / fh
        w = max(8, min(max_width, int(fw * scale)))
        return cv_ops.resize_linear(framed, (w, height))

    # ----------------------------------------------------------- rec batches
    def render_line_photo(self, text: str, height: int = 48,
                          max_width: int = 320,
                          font_key=None) -> np.ndarray:
        """Scene-photo line: glyph alpha composited onto a low-frequency
        textured background with contrast-aware ink (the det_page_hard
        recipe) + photometric jitter. The flat renderer teaches
        'paper-colored box with dark marks'; real photo text (french_0,
        posters) sits on gradients and textures."""
        rng = self.rng
        bgr, alpha = self.render_line(text, height, max_width,
                                      font_key=font_key, return_alpha=True)
        h, w = alpha.shape
        base = rng.uniform(40, 230, size=(2, 3, 3)).astype(np.float32)
        bg = cv_ops.resize_cubic(base, (w, h))
        bg += rng.normal(0, rng.uniform(2, 10), bg.shape)
        ink = rng.uniform(0, 90, 3) if bg.mean() > 128 else \
            rng.uniform(165, 255, 3)
        a = alpha[..., None]
        out = bg * (1 - a) + ink * a
        gain = rng.uniform(0.6, 1.15)
        bias = rng.uniform(-25, 35)
        out = np.clip(out * gain + bias, 0, 255).astype(np.uint8)
        if rng.random() < 0.4:
            k = int(rng.integers(1, 3)) * 2 + 1
            out = cv_ops.gaussian_blur(out, k)
        if rng.random() < 0.3:  # photo text can be small too
            h2 = int(rng.integers(12, 28))
            w2 = max(4, int(round(w * h2 / height)))
            out = cv_ops.resize_linear(cv_ops.resize_area(out, (w2, h2)),
                                       (w, height))
        return out

    def render_line_dotmatrix(self, text: str, height: int = 48,
                              max_width: int = 320,
                              font_key=None) -> np.ndarray:
        """Dot-matrix print: glyph ink survives only on a regular dot
        grid (boarding passes, receipt printers — a standing held-out
        miss class)."""
        rng = self.rng
        _, alpha = self.render_line(text, height, max_width,
                                    font_key=font_key, return_alpha=True)
        h, w = alpha.shape
        bgv = float(rng.uniform(150, 245))
        inkv = float(rng.uniform(0, 90))
        pitch = int(rng.integers(3, 6))
        yy, xx = np.mgrid[0:h, 0:w]
        r = pitch * rng.uniform(0.5, 0.9) / 2.0
        dots = (((yy % pitch) - pitch / 2.0) ** 2 +
                ((xx % pitch) - pitch / 2.0) ** 2) <= r * r
        keep = (alpha > rng.uniform(0.3, 0.6)) & dots
        out = np.full((h, w, 3), bgv, np.float32)
        out += rng.normal(0, rng.uniform(1, 6), out.shape)
        out[keep] = inkv
        if rng.random() < 0.5:
            out = cv_ops.gaussian_blur(out, 3)
        return np.clip(out, 0, 255).astype(np.uint8)

    def rec_batch(self, batch: int, width: int = 320, max_len: int = 16,
                  margins: bool = True, return_widths: bool = False
                  ) -> Tuple[np.ndarray, ...]:
        """→ (images (B,48,width,3) float in [-1,1], labels (B,L) int32,
        label_paddings (B,L) float32[, valid widths (B,) int32])."""
        imgs = np.zeros((batch, 48, width, 3), np.float32)
        widths = np.zeros(batch, np.int32)
        texts = []
        for i in range(batch):
            t, fkey = self.sample_line(max_len)
            style = self.rng.random()
            if style < self.photo_frac:
                line = self.render_line_photo(t, 48, width, font_key=fkey)
            elif style < self.photo_frac + self.dotmatrix_frac:
                line = self.render_line_dotmatrix(t, 48, width,
                                                  font_key=fkey)
            else:
                line = self.render_line(t, 48, width, font_key=fkey)
            if margins and self.rng.random() < 0.8:
                line = self.add_margins(line, 48, width)
            w = line.shape[1]
            imgs[i, :, :w] = (line.astype(np.float32) / 255.0 - 0.5) / 0.5
            widths[i] = w
            texts.append(t)
        L = max(max(len(self.encode(t)) for t in texts), 1)
        labels = np.zeros((batch, L), np.int32)
        pads = np.ones((batch, L), np.float32)
        for i, t in enumerate(texts):
            enc = self.encode(t)
            labels[i, :len(enc)] = enc
            pads[i, :len(enc)] = 0.0
        if return_widths:
            return imgs, labels, pads, widths
        return imgs, labels, pads

    # ----------------------------------------------------------- det pages
    def det_page(self, size: int = 320, max_lines: int = 8, shrink: float = 0.7
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        # shrink 0.7 → target distance ≈ 0.49·A/P ≈ 0.25·line-height, so the
        # DB unclip (1.5) re-expands detected boxes to ~1.25× text height —
        # matching the margin augmentation the recognizer trains with.
        """Compose a page of text lines. → (image (S,S,3) uint8 BGR,
        shrink_map (S,S) float, mask (S,S) float)."""
        rng = self.rng
        bg = int(rng.integers(150, 256))
        page = np.full((size, size, 3), bg, np.uint8)
        page = np.clip(page.astype(np.float32) +
                       rng.normal(0, 4, page.shape), 0, 255).astype(np.uint8)
        shrink_map = np.zeros((size, size), np.float32)
        n_lines = int(rng.integers(2, max_lines + 1))
        for _ in range(n_lines):
            text, fkey = self.sample_line(12)
            h = int(rng.integers(14, 40))
            line = self.render_line(text, h, size - 8, font_key=fkey)
            lh, lw = line.shape[:2]
            for _try in range(10):
                x0 = int(rng.integers(0, size - lw)) if size > lw else 0
                y0 = int(rng.integers(0, size - lh)) if size > lh else 0
                region = shrink_map[y0:y0 + lh, x0:x0 + lw]
                if region.sum() == 0:
                    page[y0:y0 + lh, x0:x0 + lw] = line
                    # shrunk box (DB-style: offset inward by area*r/perimeter)
                    d = (lw * lh) * shrink ** 2 / (2 * (lw + lh))
                    di = max(1, int(d))
                    sx0, sy0 = x0 + di, y0 + di
                    sx1, sy1 = x0 + lw - di, y0 + lh - di
                    if sx1 > sx0 and sy1 > sy0:
                        shrink_map[sy0:sy1, sx0:sx1] = 1.0
                    break
        mask = np.ones((size, size), np.float32)
        return page, shrink_map, mask

    # -------------------------------------------------- hard det pages
    def det_page_hard(self, size: int = 320, max_lines: int = 8,
                      shrink: float = 0.7
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Photo-ish det page: textured/gradient background, non-text
        clutter shapes, ALPHA-composited text (no pasted rectangle — the
        clean det_page teaches 'white box with marks = text', which does
        not survive scene photos), then global contrast/blur/JPEG jitter.
        Same shrink-map geometry as det_page."""
        rng = self.rng
        # low-frequency colored background field
        base = rng.uniform(40, 230, size=(4, 4, 3)).astype(np.float32)
        page = cv_ops.resize_cubic(base, (size, size))
        page += rng.normal(0, rng.uniform(2, 10), page.shape)
        page = np.clip(page, 0, 255)
        # clutter: edges and blobs that must NOT be detected as text
        for _ in range(int(rng.integers(0, 7))):
            col = tuple(int(c) for c in rng.integers(0, 256, 3))
            kind = rng.random()
            p1 = (int(rng.integers(0, size)), int(rng.integers(0, size)))
            p2 = (int(rng.integers(0, size)), int(rng.integers(0, size)))
            pu8 = page.astype(np.uint8)
            if kind < 0.4:
                cv_ops.line(pu8, p1, p2, col, int(rng.integers(1, 5)))
            elif kind < 0.7:
                cv_ops.rectangle(pu8, p1, p2, col,
                                 int(rng.integers(1, 4)) if rng.random() < .7
                                 else -1)
            else:
                cv_ops.circle(pu8, p1, int(rng.integers(4, size // 4)), col,
                              int(rng.integers(1, 4)))
            page = pu8.astype(np.float32)
        shrink_map = np.zeros((size, size), np.float32)
        n_lines = int(rng.integers(2, max_lines + 1))
        for _ in range(n_lines):
            text, fkey = self.sample_line(12)
            h = int(rng.integers(14, 40))
            line, alpha = self.render_line(text, h, size - 8,
                                           font_key=fkey,
                                           return_alpha=True)
            lh, lw = line.shape[:2]
            for _try in range(10):
                x0 = int(rng.integers(0, size - lw)) if size > lw else 0
                y0 = int(rng.integers(0, size - lh)) if size > lh else 0
                region = shrink_map[y0:y0 + lh, x0:x0 + lw]
                if region.sum() == 0:
                    # composite glyphs only; keep enough contrast vs bg
                    bg_mean = page[y0:y0 + lh, x0:x0 + lw].mean()
                    ink = rng.uniform(0, 90, 3) if bg_mean > 128 else \
                        rng.uniform(165, 255, 3)
                    a = alpha[..., None]
                    page[y0:y0 + lh, x0:x0 + lw] = \
                        page[y0:y0 + lh, x0:x0 + lw] * (1 - a) + ink * a
                    d = (lw * lh) * shrink ** 2 / (2 * (lw + lh))
                    di = max(1, int(d))
                    sx0, sy0 = x0 + di, y0 + di
                    sx1, sy1 = x0 + lw - di, y0 + lh - di
                    if sx1 > sx0 and sy1 > sy0:
                        shrink_map[sy0:sy1, sx0:sx1] = 1.0
                    break
        page = np.clip(page, 0, 255).astype(np.uint8)
        # global photometric jitter
        gain = rng.uniform(0.55, 1.15)
        bias = rng.uniform(-25, 40)
        page = np.clip(page.astype(np.float32) * gain + bias,
                       0, 255).astype(np.uint8)
        if rng.random() < 0.4:
            k = int(rng.integers(1, 3)) * 2 + 1
            page = cv_ops.gaussian_blur(page, k)
        if rng.random() < 0.5:  # JPEG artifacts
            q = int(rng.integers(35, 90))
            page = imcodec.imdecode(imcodec.imencode_jpeg(page, q))
        mask = np.ones((size, size), np.float32)
        return page, shrink_map, mask

    # -------------------------------------------------- table det pages
    def det_page_table(self, size: int = 320, shrink: float = 0.7
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Ruled-table page: grid/rule lines with short aligned cell texts
        (numeric-heavy). Documents like lab reports and shareholder
        registers are tables of small tokens separated by rules — the
        random-placement renderers never teach that text sits INSIDE line
        art, so the detector learned to suppress exactly those regions."""
        rng = self.rng
        bg = int(rng.integers(170, 256))
        page = np.full((size, size, 3), bg, np.uint8)
        page = np.clip(page.astype(np.float32) +
                       rng.normal(0, 3, page.shape), 0, 255).astype(np.uint8)
        rows = int(rng.integers(3, 8))
        cols = int(rng.integers(2, 6))
        x_edges = np.linspace(int(rng.integers(0, 16)),
                              size - int(rng.integers(1, 16)),
                              cols + 1).astype(int)
        y_edges = np.linspace(int(rng.integers(0, 16)),
                              size - int(rng.integers(1, 16)),
                              rows + 1).astype(int)
        rule_col = int(rng.integers(0, 120))
        style = rng.random()  # full grid / horizontal rules / no rules
        thick = int(rng.integers(1, 3))
        if style < 0.45:
            for x in x_edges:
                cv_ops.line(page, (x, y_edges[0]), (x, y_edges[-1]),
                            (rule_col,) * 3, thick)
        if style < 0.8:
            for y in y_edges:
                cv_ops.line(page, (x_edges[0], y), (x_edges[-1], y),
                            (rule_col,) * 3, thick)
        shrink_map = np.zeros((size, size), np.float32)
        n_cells = rows * cols
        fill = rng.uniform(0.4, 0.9)
        cells = [(r, c) for r in range(rows) for c in range(cols)]
        rng.shuffle(cells)
        budget = 16  # render_line calls are the 1-core host's step cost
        for r, c in cells[:min(n_cells, budget)]:
            if rng.random() > fill:
                continue
            cx0, cx1 = x_edges[c] + thick + 1, x_edges[c + 1] - thick - 1
            cy0, cy1 = y_edges[r] + thick + 1, y_edges[r + 1] - thick - 1
            ch_, cw_ = cy1 - cy0, cx1 - cx0
            if ch_ < 11 or cw_ < 14:
                continue
            key = self._pick_font()
            if rng.random() < 0.75:
                text = self._number_token()
            else:
                text = self.random_structured(10, key) or \
                    self._digit_run(4)
            fset = self._font_sets[key]
            if not all(ch in fset for ch in text):
                text = self._digit_run(int(rng.integers(2, 7)))
            h = int(min(ch_, rng.integers(11, 26)))
            line = self.render_line(text, h, max(10, cw_), font_key=key)
            lh, lw = line.shape[:2]
            if lh > ch_ or lw > cw_:
                continue
            # align left/center/right inside the cell, like real columns
            a = rng.random()
            x0 = cx0 if a < 0.4 else \
                cx0 + (cw_ - lw) // 2 if a < 0.75 else cx1 - lw
            y0 = cy0 + (ch_ - lh) // 2
            region = shrink_map[y0:y0 + lh, x0:x0 + lw]
            if region.sum() != 0:
                continue
            page[y0:y0 + lh, x0:x0 + lw] = line
            d = (lw * lh) * shrink ** 2 / (2 * (lw + lh))
            di = max(1, int(d))
            sx0, sy0 = x0 + di, y0 + di
            sx1, sy1 = x0 + lw - di, y0 + lh - di
            if sx1 > sx0 and sy1 > sy0:
                shrink_map[sy0:sy1, sx0:sx1] = 1.0
        # mild photometric jitter (scans vary in exposure)
        gain = rng.uniform(0.8, 1.1)
        page = np.clip(page.astype(np.float32) * gain +
                       rng.uniform(-15, 15), 0, 255).astype(np.uint8)
        if rng.random() < 0.25:
            page = cv_ops.gaussian_blur(page, 3)
        mask = np.ones((size, size), np.float32)
        return page, shrink_map, mask

    def det_batch(self, batch: int, size: int = 320,
                  hard_frac: float = 0.0, table_frac: float = 0.0):
        from ..ops import det_pre
        imgs = np.zeros((batch, size, size, 3), np.float32)
        maps = np.zeros((batch, size, size), np.float32)
        masks = np.zeros((batch, size, size), np.float32)
        for i in range(batch):
            u = self.rng.random()
            if u < hard_frac:
                page, smap, mask = self.det_page_hard(size)
            elif u < hard_frac + table_frac:
                page, smap, mask = self.det_page_table(size)
            else:
                page, smap, mask = self.det_page(size)
            imgs[i] = (page.astype(np.float32) / 255.0 -
                       det_pre.IMAGENET_MEAN) / det_pre.IMAGENET_STD
            maps[i] = smap
            masks[i] = mask
        return imgs, maps, masks


def charset_from_dict(dict_path: str,
                      charset: Optional[str] = DEFAULT_CHARSET
                      ) -> Dict[str, int]:
    """Map renderable chars → dict indices (blank-first scheme, matching
    ops/ctc.CTCLabelDecode).  charset=None → every single-char entry of
    the dictionary (TextRenderer then intersects with font coverage)."""
    from ..ops.ctc import CTCLabelDecode
    dec = CTCLabelDecode(dict_path, use_space_char=True)
    lookup = {c: i for i, c in enumerate(dec.character)}
    if charset is None:
        return {c: i for c, i in lookup.items() if len(c) == 1}
    return {c: lookup[c] for c in charset if c in lookup}

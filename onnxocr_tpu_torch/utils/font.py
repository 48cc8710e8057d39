"""TrueType text for a machine without PIL: the counterpart of
`PIL.ImageFont.truetype(path, size)` and `ImageDraw.text` as the JAX
package's text panel (utils/draw.py) and PDF rasteriser (batch/pdf_raster.py)
use them — Pillow 12 with FreeType and the RAQM (HarfBuzz) layout.

`FreeTypeFont(path, size)` gives `getmetrics()`, `getlength(text)`,
`getbbox(text)` and `render(text, start)` (the mask and offset of
`getmask2`); `draw_text(img, xy, text, fill, font)` is `ImageDraw.text` on an
(H, W, 3) or (H, W) uint8 array. The C++ side (`csrc/host/ttf.cc`, g++ at
first use into build/host/ like the other host libraries) reads the font,
shapes one run and rasterises glyphs.

What equals PIL's:

* Layout: glyph selection (cmap, GSUB ligatures), advances and GPOS kerning
  in 26.6 are HarfBuzz's, so `getlength` equals PIL's; text is split into
  runs by script as libraqm splits it (Common and Inherited characters
  join their neighbour's run); right-to-left text is laid out left to
  right, and combining marks are not positioned (GPOS mark, mkmk).
* Glyphs: outlines are hinted by FreeType's TrueType bytecode interpreter
  as its default (v40) runs it, and rasterised with FreeType's exact-area
  coverage, so `getmetrics`, `getbbox`, the masks and the drawn pixels
  equal PIL's on the DejaVu faces (tests/test_torch_font.py), and masks
  and boxes on the sixteen faces of train/synth.py's FONTS (the DejaVu
  obliques, italics and Display faces, Computer Modern cmb10, cmss10 and
  cmtt10: tests/test_torch_synth.py).
* `codepoints(path)`: the code points of the cmap subtable fontTools'
  `getBestCmap` reads.
"""
from __future__ import annotations

import ctypes
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "ttf.cc"
FONT_DIR = Path(__file__).resolve().parents[1] / "assets" / "fonts" / "dejavu"
SYSTEM_FONT_DIR = Path("/usr/share/fonts/truetype/dejavu")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)
_UP = ctypes.POINTER(ctypes.c_uint)
_LLP = ctypes.POINTER(ctypes.c_longlong)
_LL = ctypes.c_longlong
_SIGNATURES = {
    "ttf_open": (ctypes.c_void_p, [_U8P, _LL]),
    "ttf_close": (None, [ctypes.c_void_p]),
    "ttf_size_metrics": (None, [ctypes.c_void_p, ctypes.c_int, _LLP]),
    "ttf_shape": (ctypes.c_int, [
        ctypes.c_void_p, _UP, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
        _IP, _IP, _LLP, _LLP, _LLP, ctypes.c_int]),
    "ttf_glyph_cbox": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _LL, _LL, _LLP]),
    "ttf_codepoints": (ctypes.c_int, [ctypes.c_void_p, _UP, ctypes.c_int]),
    "ttf_render_glyph": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _LL, _LL,
        ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int, ctypes.c_int]),
}


def lib() -> ctypes.CDLL:
    """The loaded font library, built first if needed."""
    return native.load(SOURCE, "libocrttf", _SIGNATURES)


def dejavu_path(name: str) -> str:
    """The DejaVu face `name` (e.g. 'DejaVuSans.ttf'): the system's file
    where it exists (the path the JAX package names), else the package's
    committed copy of the same bytes."""
    system = SYSTEM_FONT_DIR / name
    return str(system if system.exists() else FONT_DIR / name)


def codepoints(path) -> set:
    """The code points a font's cmap maps to a glyph: `set(TTFont(path,
    lazy=True).getBestCmap())` of fontTools, from the same subtable (its
    preference: (3,10), (0,6), (0,4), (3,1), (0,3), (0,2), (0,1), (0,0))."""
    data = np.frombuffer(Path(path).read_bytes(), np.uint8)
    handle = lib().ttf_open(data.ctypes.data_as(_U8P), data.size)
    if not handle:
        raise OSError(f"{path}: not a TrueType font this reader takes")
    try:
        cap = 1 << 16
        while True:
            out = np.empty(cap, np.uint32)
            n = lib().ttf_codepoints(handle, out.ctypes.data_as(_UP), cap)
            if n >= 0:
                return set(out[:n].tolist())
            if n == -1:
                raise OSError(f"{path}: no cmap subtable this reader takes")
            cap = -n
    finally:
        lib().ttf_close(handle)


def _pixel(v: int) -> int:
    """PIL's PIXEL(): 26.6 → whole pixels, rounded half up."""
    return ((v + 32) & -64) >> 6


# ------------------------------------------------------------ scripts
# OpenType script tag of a character's script (by the first word of its
# Unicode name); characters of no listed script are Common.
_SCRIPT_WORDS = {
    "LATIN": "latn", "GREEK": "grek", "CYRILLIC": "cyrl", "ARMENIAN": "armn",
    "HEBREW": "hebr", "ARABIC": "arab", "THAI": "thai", "LAO": "lao ",
    "GEORGIAN": "geor", "HIRAGANA": "kana", "KATAKANA": "kana",
    "HANGUL": "hang", "BOPOMOFO": "bopo", "CJK": "hani", "IDEOGRAPHIC": None,
}
_INHERITED = "zinh"
_COMMON = ""


def _char_script(ch: str) -> str:
    cat = unicodedata.category(ch)
    if cat in ("Mn", "Me"):
        return _INHERITED
    if cat[0] != "L":
        return _COMMON
    name = unicodedata.name(ch, "")
    words = name.split()
    for w in words[:3]:
        if w in _SCRIPT_WORDS:
            tag = _SCRIPT_WORDS[w]
            if w == "CJK" and "IDEOGRAPH" not in name:
                return _COMMON
            return tag or _COMMON
    return _COMMON


def _runs(text: str) -> List[Tuple[int, int, str]]:
    """libraqm's script itemisation: (start, end, script tag) runs, with
    Common and Inherited characters taking the script before them (or,
    at the start, the first one after them)."""
    scripts = [_char_script(c) for c in text]
    last = None
    for i, s in enumerate(scripts):
        if s in (_COMMON, _INHERITED):
            if last is not None:
                scripts[i] = last
        else:
            last = s
    for i in range(len(scripts) - 2, -1, -1):
        if scripts[i] in (_COMMON, _INHERITED):
            scripts[i] = scripts[i + 1]
    runs = []
    start = 0
    for i in range(1, len(text) + 1):
        if i == len(text) or scripts[i] != scripts[start]:
            runs.append((start, i, scripts[start]))
            start = i
    return runs


def _tag(script: str) -> int:
    if not script or script == _INHERITED:
        return 0
    b = script.encode("ascii")
    return (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]


# ---------------------------------------------------------------- font
class FreeTypeFont:
    """A TrueType face at an integer pixel size (PIL's
    `ImageFont.truetype(path, size)` with the RAQM layout)."""

    def __init__(self, path, size: int):
        self.path = str(path)
        self.size = int(size)
        if self.size < 1:
            raise ValueError(f"font size must be at least 1, got {size}")
        data = np.frombuffer(Path(self.path).read_bytes(), np.uint8)
        self._lib = lib()
        handle = self._lib.ttf_open(data.ctypes.data_as(_U8P), data.size)
        if not handle:
            raise OSError(f"{self.path}: not a TrueType font this reader "
                          "takes (glyf outlines, cmap format 4 or 12)")
        self._h = ctypes.c_void_p(handle)
        m = np.zeros(2, np.int64)
        self._lib.ttf_size_metrics(self._h, self.size,
                                   m.ctypes.data_as(_LLP))
        self._ascender, self._descender = int(m[0]), int(m[1])
        self._cbox: Dict[int, Optional[Tuple[int, int, int, int]]] = {}

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.ttf_close(h)

    # -------------------------------------------------------- layout
    def _layout(self, text: str) -> List[Tuple[int, int, int, int]]:
        """(glyph, x_advance, x_offset, y_offset) in 26.6 over the runs."""
        out: List[Tuple[int, int, int, int]] = []
        for start, end, script in _runs(text):
            cps = np.array([ord(c) for c in text[start:end]], np.uint32)
            n = len(cps)
            cap = n
            while True:
                gids = np.empty(cap, np.int32)
                clusters = np.empty(cap, np.int32)
                adv = np.empty(cap, np.int64)
                xo = np.empty(cap, np.int64)
                yo = np.empty(cap, np.int64)
                m = self._lib.ttf_shape(
                    self._h, cps.ctypes.data_as(_UP), n, _tag(script),
                    self.size, gids.ctypes.data_as(_IP),
                    clusters.ctypes.data_as(_IP), adv.ctypes.data_as(_LLP),
                    xo.ctypes.data_as(_LLP), yo.ctypes.data_as(_LLP), cap)
                if m >= 0:
                    break
                cap = -m
            out += list(zip(gids[:m].tolist(), adv[:m].tolist(),
                            xo[:m].tolist(), yo[:m].tolist()))
        return out

    def _glyph_cbox(self, gid: int) -> Optional[Tuple[int, int, int, int]]:
        """The glyph's 26.6 control box, None when it has no outline."""
        if gid not in self._cbox:
            box = np.zeros(4, np.int64)
            rc = self._lib.ttf_glyph_cbox(self._h, gid, self.size, 0, 0,
                                          box.ctypes.data_as(_LLP))
            self._cbox[gid] = tuple(box.tolist()) if rc == 1 else None
        return self._cbox[gid]

    def getmetrics(self) -> Tuple[int, int]:
        """(ascent, descent) in pixels."""
        return _pixel(self._ascender), -_pixel(self._descender)

    def getlength(self, text: str) -> float:
        """The advance of the text in pixels (26.6, unrounded)."""
        return sum(g[1] for g in self._layout(text)) / 64.0

    def _bbox(self, glyphs) -> Tuple[int, int, int, int]:
        """PIL's bounding_box_and_anchors for anchor 'la':
        (x_min, x_max, y_min, y_max) in pixels, y up, the pen line from 0
        to the advance included."""
        pos = x_min = x_max = y_min = y_max = 0
        for gid, adv, xo, yo in glyphs:
            px, py = _pixel(pos + xo), _pixel(yo)
            pos += adv
            x_max = max(x_max, _pixel(pos))
            box = self._glyph_cbox(gid)
            if box is None:
                bx0 = by0 = bx1 = by1 = 0
            else:
                bx0, by0 = box[0] >> 6, box[1] >> 6
                bx1, by1 = (box[2] + 63) >> 6, (box[3] + 63) >> 6
            x_max = max(x_max, bx1 + px)
            x_min = min(x_min, bx0 + px)
            y_max = max(y_max, by1 + py)
            y_min = min(y_min, by0 + py)
        return x_min, x_max, y_min, y_max

    def getbbox(self, text: str) -> Tuple[int, int, int, int]:
        """(left, top, right, bottom) of the text drawn at (0, 0), anchor
        'la' (left, ascender)."""
        x_min, x_max, y_min, y_max = self._bbox(self._layout(text))
        top = _pixel(self._ascender) - y_max
        return x_min, top, x_max, top + (y_max - y_min)

    def render(self, text: str, start: Tuple[float, float] = (0.0, 0.0)
               ) -> Tuple[np.ndarray, Tuple[int, int]]:
        """The (h, w) uint8 coverage mask of one line and its offset from
        the text origin (PIL's `getmask2(text, 'L', start=start)`); the
        fractional start moves glyphs by the rounding of their origins and
        widens the mask by its ceiling."""
        glyphs = self._layout(text)
        x_min, x_max, y_min, y_max = self._bbox(glyphs)
        sx, sy = float(start[0]), float(start[1])
        width = x_max - x_min + int(np.ceil(sx))
        height = y_max - y_min + int(np.ceil(sy))
        offset = (x_min, _pixel(self._ascender) - y_max)
        mask = np.zeros((max(height, 0), max(width, 0)), np.uint8)
        if not glyphs or width <= 0 or height <= 0:
            return mask, offset
        ptr = mask.ctypes.data_as(_U8P)
        # each glyph's origin (pen + fractional start, y up) is rounded to
        # whole pixels, as PIL's PIXEL() rounds it
        dx0, dy0 = int(sx * 64 + 0.5), -int(sy * 64 + 0.5)
        pos = 0
        for gid, adv, xo, yo in glyphs:
            if self._glyph_cbox(gid) is not None:
                self._lib.ttf_render_glyph(
                    self._h, gid, self.size, _pixel(dx0 + pos + xo) * 64,
                    _pixel(dy0 + yo) * 64, x_min, y_max, ptr, width, height)
            pos += adv
        return mask, offset


# ---------------------------------------------------------------- drawing
def blend_mask(img: np.ndarray, x: int, y: int, mask: np.ndarray,
               fill) -> None:
    """PIL's fill-with-mask of an RGB or 'L' image (ImageDraw.draw_bitmap):
    each channel becomes (in * (255 - m) + ink * m) / 255, rounded as PIL's
    DIV255 rounds; the mask is clipped to the image."""
    h, w = mask.shape
    H, W = img.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, W), min(y + h, H)
    if x1 <= x0 or y1 <= y0:
        return
    m = mask[y0 - y:y1 - y, x0 - x:x1 - x].astype(np.int32)
    region = img[y0:y1, x0:x1].astype(np.int32)
    ink = np.asarray(fill, np.int32)
    if img.ndim == 3:
        m = m[:, :, None]
        ink = ink.reshape(1, 1, -1)
    t = region * (255 - m) + ink * m + 128
    img[y0:y1, x0:x1] = (((t >> 8) + t) >> 8).astype(np.uint8)


def draw_text(img: np.ndarray, xy, text: str, fill, font: FreeTypeFont,
              spacing: float = 4) -> None:
    """`ImageDraw.Draw(img).text(xy, text, fill, font)` on an (H, W, 3)
    RGB or (H, W) 'L' uint8 array, in place: the integer part of xy places
    the mask, the fractional part moves the glyphs (`render`); lines split
    at '\\n' are drawn getbbox('A')[3] + spacing apart."""
    lines = text.split("\n")
    line_spacing = font.getbbox("A")[3] + spacing if len(lines) > 1 else 0
    x, top = float(xy[0]), float(xy[1])
    for line in lines:
        frac_x, frac_y = x - int(x), top - int(top)
        mask, (ox, oy) = font.render(line, (frac_x, frac_y))
        if mask.size:
            blend_mask(img, int(x) + ox, int(top) + oy, mask, fill)
        top += line_spacing


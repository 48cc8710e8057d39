"""matplotlib's FT2Font for a machine without matplotlib: the calls that
`backend_agg.RendererAgg.draw_text` and `get_text_width_height_descent`
make on it (matplotlib 3.10 over its bundled FreeType 2.6.1), at the
defaults `text.hinting = force_autohint`, `text.hinting_factor = 8`,
`text.kerning_factor = 0`.

`FT2Font(path)` then `set_size(pt, dpi)` — FT_Set_Char_Size(face, pt * 64,
0, dpi * 8, dpi) and FT_Set_Transform's 1/8 x-scale — then `set_text(s)`
lays the glyphs out unrotated on a 26.6 pen, every glyph loaded with
FT_LOAD_FORCE_AUTOHINT (FreeType 2.6.1's auto-hinter, Latin writing
system); `get_width_height()`, `get_descent()`, `get_bitmap_offset()` and
`draw_glyphs_to_bitmap()` / `get_image()` follow. `load_char(c)` with
`outline()` gives one glyph's hinted outline (26.6 points, on-curve tags,
contour ends) as `get_path()` gives it.

The faces this serves (the held-out page generator's STIXGeneral family and
Computer Modern cmr10) carry no 'kern' table, so the pen takes no kerning,
as FT2Font takes none from them. A character the face lacks renders its
glyph 0. The pixel work is C++ (`csrc/host/autohint.cc`, g++ at first use
into build/host/): the auto-hinter, and FreeType 2.6.1's smooth rasteriser.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..ops import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "autohint.cc"
FONT_DIR = Path(__file__).resolve().parents[1] / "assets" / "fonts"

# the held-out page generator's faces, as the package's copies of
# matplotlib's mpl-data/fonts/ttf files
STIX_REGULAR = FONT_DIR / "stix" / "STIXGeneral.ttf"
STIX_BOLD = FONT_DIR / "stix" / "STIXGeneralBol.ttf"
STIX_ITALIC = FONT_DIR / "stix" / "STIXGeneralItalic.ttf"
STIX_BOLD_ITALIC = FONT_DIR / "stix" / "STIXGeneralBolIta.ttf"
CMR10 = FONT_DIR / "cm" / "cmr10.ttf"

# rcParams["text.hinting_factor"]: x is hinted at 8 times the resolution
# and scaled back by the transform (the auto-hinter's rules here were read
# off FT2Font at this factor only)
HINTING_FACTOR = 8

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_LL = ctypes.c_longlong
_VP = ctypes.c_void_p
_SIGNATURES = {
    "ah_open": (_VP, [_VP, _LL]),
    "ah_close": (None, [_VP]),
    "ah_glyph_index": (ctypes.c_int, [_VP, ctypes.c_uint]),
    "ah_load_glyph": (ctypes.c_int, [
        _VP, _LL, ctypes.c_int, ctypes.c_int, _LL, ctypes.c_int,
        _VP, _VP, _VP, ctypes.c_int, _VP]),
    "ah_set_text": (ctypes.c_int, [
        _VP, _LL, ctypes.c_int, ctypes.c_int, _LL, _VP, ctypes.c_int, _VP]),
    "ah_draw_text": (ctypes.c_int, [
        _VP, _LL, ctypes.c_int, ctypes.c_int, _LL, _VP, ctypes.c_int,
        _VP, _VP, ctypes.c_int, ctypes.c_int]),
}


def lib() -> ctypes.CDLL:
    """The loaded auto-hinter library, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            loaded = ctypes.CDLL(str(native.build(SOURCE, "libocrautohint")))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = loaded
    return _LIB


class FT2Font:
    """One face, as `matplotlib.ft2font.FT2Font(path, hinting_factor=8)`."""

    def __init__(self, path):
        self.fname = str(path)
        self._data = np.frombuffer(Path(path).read_bytes(), np.uint8)
        self._handle = lib().ah_open(self._data.ctypes.data, self._data.size)
        if not self._handle:
            raise OSError(f"{path}: not a TrueType font this reader takes")
        self._size = None
        self._gids: List[int] = []
        self._bbox = (0, 0, 0, 0)
        self._advance = 0
        self._image = np.zeros((0, 0), np.uint8)
        self._glyph = None

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle and _LIB is not None:
            _LIB.ah_close(handle)
            self._handle = None

    def set_size(self, ptsize: float, dpi: float) -> None:
        """FT_Set_Char_Size(face, (FT_F26Dot6)(ptsize * 64), 0,
        (FT_UInt)(dpi * HINTING_FACTOR), (FT_UInt)dpi), transform
        (65536 / HINTING_FACTOR, 0, 0, 65536)."""
        self._size = (int(ptsize * 64), int(dpi * HINTING_FACTOR), int(dpi),
                      65536 // HINTING_FACTOR)

    def _args(self):
        if self._size is None:
            raise RuntimeError("set_size first")
        return self._size

    def get_char_index(self, codepoint: int) -> int:
        return lib().ah_glyph_index(self._handle, int(codepoint))

    def set_text(self, s: str) -> None:
        """Lay `s` out unrotated, as FT2Font.set_text(s, 0, flags)."""
        cw, hres, vres, xx = self._args()
        self._gids = [self.get_char_index(ord(c)) for c in s]
        gids = np.asarray(self._gids, np.int32)
        out = np.zeros(5, np.int64)
        if lib().ah_set_text(self._handle, cw, hres, vres, xx,
                             gids.ctypes.data, len(s), out.ctypes.data) != 0:
            raise RuntimeError(f"could not lay out {s!r}")
        self._bbox = tuple(int(v) for v in out[:4])
        self._advance = int(out[4])

    def get_width_height(self) -> Tuple[int, int]:
        """(advance, yMax - yMin) in 26.6."""
        return self._advance, self._bbox[3] - self._bbox[1]

    def get_descent(self) -> int:
        return -self._bbox[1]

    def get_bitmap_offset(self) -> Tuple[int, int]:
        return self._bbox[0], 0

    def draw_glyphs_to_bitmap(self) -> None:
        """The anti-aliased string image: (yMax - yMin) / 64 + 2 rows,
        (xMax - xMin) / 64 + 2 columns, each glyph's smooth-rendered bitmap
        OR-ed in."""
        cw, hres, vres, xx = self._args()
        x0, y0, x1, y1 = self._bbox
        rows = int((y1 - y0) / 64) + 2
        cols = int((x1 - x0) / 64) + 2
        image = np.zeros((rows, cols), np.uint8)
        gids = np.asarray(self._gids, np.int32)
        bbox = np.asarray(self._bbox, np.int64)
        if lib().ah_draw_text(self._handle, cw, hres, vres, xx,
                              gids.ctypes.data, len(self._gids),
                              bbox.ctypes.data, image.ctypes.data, rows,
                              cols) != 0:
            raise RuntimeError("could not draw the text")
        self._image = image

    def get_image(self) -> np.ndarray:
        return self._image

    def load_char(self, codepoint: int) -> None:
        """Load one glyph, hinted, for `outline()`."""
        cw, hres, vres, xx = self._args()
        cap = 4096
        xy = np.zeros(2 * cap, np.int64)
        tags = np.zeros(cap, np.uint8)
        ends = np.zeros(cap, np.int32)
        meta = np.zeros(2, np.int64)
        n = lib().ah_load_glyph(self._handle, cw, hres, vres, xx,
                                self.get_char_index(codepoint),
                                xy.ctypes.data, tags.ctypes.data,
                                ends.ctypes.data, cap, meta.ctypes.data)
        if n < 0:
            raise RuntimeError(f"could not load U+{codepoint:04X}")
        self._glyph = (xy[:2 * n].reshape(n, 2), tags[:n].astype(bool),
                       ends[:int(meta[0])].copy(), int(meta[1]))

    def outline(self):
        """(points (n, 2) 26.6, on-curve flags, contour ends, advance.x)
        of the last `load_char`."""
        return self._glyph

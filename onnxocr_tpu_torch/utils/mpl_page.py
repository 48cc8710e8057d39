"""The figure of the held-out page generator (tools/make_heldout_synth.py,
`_render_page`) for a machine without matplotlib: what matplotlib 3.10's
Agg backend draws for a figure of `width` x `height` pixels at 100 dpi, one
axes over the whole figure with its axis off, `xlim(0, width)`,
`ylim(height, 0)`, two-point `ax.plot` rules and `ax.text` lines
(`ha="left"`, `va="baseline"` or `"top"`, unrotated, no clipping).

`Page(width, height, background)` fills the figure patch (the
canvas starts transparent white, as RendererAgg clears it); `rule(xs, ys,
grey, lw)` and `text(x, y, s, font_path, size_pt, grey, va)` queue
artists; `draw()` renders them in matplotlib's order — the patch, then
lines (z-order 2) before texts (z-order 3), each in insertion order — and
returns the RGB of `buffer_rgba()`.

* Transforms: for this axes matplotlib's transData is exactly (x, y) ->
  (x, height - y) (`[[1, 0, 0], [0, -1, height]]`), and Agg's y flip
  cancels it, so a rule's pixel coordinates are its data coordinates.
* Rules: PathSnapper (both segments axis-aligned) moves each vertex to
  floor(v + 0.5) + 0.5 for an odd rounded width, the stroke is
  `points_to_pixels(lw)` wide with projecting caps, and Agg renders it
  (`csrc/host/agg.cc`); the page's rules lie inside the axes clip box,
  which therefore cuts nothing and is not applied.
* Texts: `Text._get_layout` with the line height and descent of "lp",
  then `RendererAgg.draw_text`: the FT2Font string image
  (`utils/ft2font.py`) at x = round(x + xmin / 64), y = round(height - y
  + descent / 64) + 1 (Python's round), blended in grey ink.
"""
from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import native
from . import ft2font

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "agg.cc"
DPI = 100  # the figure's, as the held-out page generator sets it

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_VP = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "agg_fill": (None, [_VP, _I, _I, _VP, _I, _VP]),
    "agg_stroke_segment": (None, [_VP, _I, _I, _VP, _D, _VP]),
    "agg_text_image": (None, [_VP, _I, _I, _VP, _I, _I, _I, _I, _VP]),
}


def lib() -> ctypes.CDLL:
    """The loaded Agg library, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            loaded = ctypes.CDLL(str(native.build(SOURCE, "libocragg")))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = loaded
    return _LIB


_FONTS: Dict[str, ft2font.FT2Font] = {}


def get_font(path) -> ft2font.FT2Font:
    """One FT2Font a face, as matplotlib's font cache keeps them."""
    key = str(path)
    if key not in _FONTS:
        _FONTS[key] = ft2font.FT2Font(key)
    return _FONTS[key]


def text_metrics(path, size_pt: float, s: str) -> Tuple[float, float, float]:
    """RendererAgg.get_text_width_height_descent: (w, h, d) in pixels."""
    font = get_font(path)
    font.set_size(size_pt, DPI)
    font.set_text(s)
    w, h = font.get_width_height()
    return w / 64.0, h / 64.0, font.get_descent() / 64.0


def _grey(level: float) -> np.ndarray:
    """A grey colour string's RGBA, as matplotlib converts str(level)."""
    v = float(level)
    return np.array([v, v, v, 1.0], np.float64)


class Page:
    """One figure of `width` x `height` pixels."""

    def __init__(self, width: int, height: int, background: float = 1.0):
        self.width, self.height = int(width), int(height)
        self.background = background
        self._lines: List[tuple] = []
        self._texts: List[tuple] = []

    def rule(self, xs, ys, grey: float, lw: float) -> None:
        """`ax.plot(xs, ys, color=str(grey), lw=lw)` for two points."""
        self._lines.append(([float(v) for v in xs], [float(v) for v in ys],
                            grey, lw))

    def text(self, x, y, s: str, font_path, size_pt: float, grey: float,
             va: str = "baseline") -> None:
        """`ax.text(x, y, s, fontproperties=FontProperties(fname=...),
        fontsize=size_pt, color=str(grey), va=va)`."""
        if va not in ("baseline", "top"):
            raise ValueError(f"va={va!r} is not drawn here")
        self._texts.append((x, y, s, str(font_path), size_pt, grey, va))

    def _draw_rule(self, buf, xs, ys, grey, lw) -> None:
        width = lw * DPI / 72  # points_to_pixels
        # PathSnapper: whole pixels, +0.5 for an odd rounded width
        snap = 0.5 if math.floor(width + 0.5) % 2 else 0.0
        seg = np.array([math.floor(xs[0] + 0.5) + snap,
                        math.floor(ys[0] + 0.5) + snap,
                        math.floor(xs[1] + 0.5) + snap,
                        math.floor(ys[1] + 0.5) + snap], np.float64)
        lib().agg_stroke_segment(buf.ctypes.data, self.width, self.height,
                                 seg.ctypes.data, width,
                                 _grey(grey).ctypes.data)

    def _draw_text(self, buf, x, y, s, path, size_pt, grey, va) -> None:
        if s == "":
            return
        _, lp_h, lp_d = text_metrics(path, size_pt, "lp")
        w, h, d = text_metrics(path, size_pt, s)
        h = max(h, lp_h)
        d = max(d, lp_d)
        thisy = -(h - d)
        ymin = thisy - d
        offsety = 0.0 if va == "top" else ymin + d
        y_line = thisy - offsety
        px = float(x)
        posy = -float(y) + self.height        # transData
        py = self.height - (y_line + posy)    # the renderer's flip
        font = get_font(path)
        font.set_size(size_pt, DPI)
        font.set_text(s)
        font.draw_glyphs_to_bitmap()
        descent = font.get_descent() / 64.0
        xo = font.get_bitmap_offset()[0] / 64.0
        ix = round(px + xo)
        iy = round(py + descent)
        image = np.ascontiguousarray(font.get_image())
        lib().agg_text_image(buf.ctypes.data, self.width, self.height,
                             image.ctypes.data, image.shape[0],
                             image.shape[1], ix, iy + 1,
                             _grey(grey).ctypes.data)

    def draw(self) -> np.ndarray:
        """The figure's RGB (height, width, 3) uint8."""
        buf = np.empty((self.height, self.width, 4), np.uint8)
        buf[...] = (255, 255, 255, 0)
        patch = np.array([0, 0, self.width, 0, self.width, self.height,
                          0, self.height], np.float64)
        bg = self.background
        lib().agg_fill(buf.ctypes.data, self.width, self.height,
                       patch.ctypes.data, 4,
                       np.array([bg, bg, bg, 1.0]).ctypes.data)
        for line in self._lines:
            self._draw_rule(buf, *line)
        for t in self._texts:
            self._draw_text(buf, *t)
        return np.ascontiguousarray(buf[:, :, :3])


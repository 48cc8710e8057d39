"""Result drawing: counterpart of onnxocr_tpu/utils/draw.py — red quad
outlines on the image and, when texts are given, the white side panel of
"N: text  score" rows at 20 px, wrapped to the panel width and paginated
into panels stacked horizontally (the layout constants are the JAX
package's).

The outlines are cv2's pixels (`cv_ops.polylines2`, the twin of
`cv2.polylines(img, [pts], True, (255, 0, 0), 2)`), the page is resized by
the cv2-exact `utils/image.resize_img`, and the rows are drawn by the
TrueType renderer of `utils/font.py` in place of PIL's `ImageDraw.text`
(layout equal to PIL's; glyph coverage unhinted, see that module).
"""
from __future__ import annotations

import math
import string
from typing import List, Optional

import numpy as np

from .. import config as cfg_mod
from . import font as font_mod
from . import pil_ops
from .cv_ops import polylines2
from .image import resize_img

_FONT_SIZE = 20
_ROW_PITCH = _FONT_SIZE + 5
_INK = (0, 0, 0)


def _load_font(font_path: Optional[str], size: int) -> font_mod.FreeTypeFont:
    """The JAX package's font order: `font_path`, the assets'
    fonts/simfang.ttf, then DejaVu Sans (the system file, else the
    package's copy of it)."""
    candidates = [font_path] if font_path else []
    candidates += [cfg_mod.find_asset("fonts/simfang.ttf"),
                   font_mod.dejavu_path("DejaVuSans.ttf")]
    for cand in candidates:
        if not cand:
            continue
        try:
            return font_mod.FreeTypeFont(cand, size)
        except OSError:
            continue
    raise OSError(f"no usable TrueType font among {candidates}")


def str_count(s) -> int:
    """Display-width heuristic (reference utils.py:91-113 semantics):
    fullwidth glyphs weigh 1, halfwidth latin/digits/whitespace weigh 1/2
    (rounded up as a group)."""
    text = str(s)
    halfwidth = sum(1 for c in text
                    if c in string.ascii_letters or c.isdigit()
                    or c.isspace())
    return len(text) - math.ceil(halfwidth / 2)


def _wrap_rows(texts: List[str], scores, threshold: float, budget: int
               ) -> List[str]:
    """Flatten (text, score) pairs into display rows: the first row of an
    entry is numbered, continuation rows are indented, and the last row
    carries the score."""
    rows: List[str] = []
    shown = 0
    for txt, score in zip(texts, scores):
        if score < threshold or math.isnan(score):
            continue
        shown += 1
        head = True
        remaining = str(txt)
        while str_count(remaining) >= budget:
            piece, remaining = remaining[:budget], remaining[budget:]
            rows.append((f"{shown}: " if head else "    ") + piece)
            head = False
        if head:
            rows.append(f"{shown}: {remaining}   {score:.3f}")
        else:
            rows.append(f"  {remaining}  {score:.3f}")
    return rows


def text_visual(texts: List[str], scores, img_h: int = 400, img_w: int = 600,
                threshold: float = 0.0, font_path: Optional[str] = None
                ) -> np.ndarray:
    """Render recognized texts into one or more (img_h, img_w) RGB panels,
    concatenated horizontally when the rows overflow one panel."""
    if scores is not None:
        assert len(texts) == len(scores), \
            "The number of txts and corresponding scores must match"

    font = _load_font(font_path, _FONT_SIZE)
    budget = img_w // _FONT_SIZE - 4
    rows = _wrap_rows(texts, scores, threshold, budget)
    rows_per_panel = max(1, img_h // _ROW_PITCH - 1)

    def paint(panel_rows: List[str]) -> np.ndarray:
        # white panel with a 1px black right border separating panels
        canvas = pil_ops.new((img_w, img_h), (255, 255, 255))
        pil_ops.rectangle(canvas, (img_w - 1, 0, img_w - 1, img_h - 1), _INK)
        for r, row in enumerate(panel_rows, start=1):
            font_mod.draw_text(canvas, (0, _ROW_PITCH * r), row, _INK, font)
        return canvas

    panels = [paint(rows[i:i + rows_per_panel])
              for i in range(0, len(rows), rows_per_panel)] or [paint([])]
    if len(panels) == 1:
        return panels[0]
    return np.concatenate(panels, axis=1)


def draw_ocr(image, boxes, txts=None, scores=None, drop_score: float = 0.5,
             font_path: Optional[str] = None) -> np.ndarray:
    """A copy of `image` with each box whose score is at least drop_score
    (and not NaN) outlined in (255, 0, 0), two pixels wide (boxes truncated
    to whole pixels as the JAX package's int64 cast does); when txts are
    given, the image resized to 600 px on its longer side with the text
    panel appended on the right."""
    image = np.array(image)
    if scores is None:
        scores = [1] * len(boxes)
    for quad, score in zip(boxes, scores):
        if score < drop_score or math.isnan(score):
            continue
        polylines2(image, np.asarray(quad, dtype=np.int64).reshape(-1, 2),
                   (255, 0, 0))
    if txts is None:
        return image
    img = np.array(resize_img(image, input_size=600))
    panel = text_visual(txts, scores, img_h=img.shape[0], img_w=600,
                        threshold=drop_score, font_path=font_path)
    return np.concatenate([img, panel], axis=1)

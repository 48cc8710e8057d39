"""The port's TrueType text (onnxocr_tpu_torch/utils/font.py + the C++
csrc/host/ttf.cc) against PIL 12's ImageFont.truetype / ImageDraw.text
(FreeType + the RAQM layout) on the six DejaVu faces.

Everything is held exact: `getmetrics` at every size 4-400 (the PDF
rasteriser's clamp); `getlength` and `getbbox` over every printable-ASCII
pair at the panel's 20 px (a sample of the pairs at other sizes), Latin-1
alone and before ASCII, CJK (drawn as .notdef) and the panel's row strings;
the mask of `getmask2` and the pixels `ImageDraw.text` draws (hinted
outlines, FreeType's coverage, PIL's composition and blending) on the
panel rows and on seeded strings at 9-57 px and fractional origins.
"""
import hashlib
import unicodedata
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFont

from onnxocr_tpu_torch.utils import font as F

SYSTEM = Path("/usr/share/fonts/truetype/dejavu")
FACES = ["DejaVuSans.ttf", "DejaVuSans-Bold.ttf", "DejaVuSerif.ttf",
         "DejaVuSerif-Bold.ttf", "DejaVuSansMono.ttf",
         "DejaVuSansMono-Bold.ttf"]
ASCII = [chr(c) for c in range(32, 127)]
PAIRS = [a + b for a in ASCII for b in ASCII]
LATIN1 = [chr(c) for c in range(0xA0, 0x100)]
PANEL_ROWS = ["1: SCAN 12345   0.987", "12: <17><4203>   0.501",
              "    office ffi fl AV To", "  7.  ", "3: 中文 Hello   0.999",
              "  (remaining)  0.612", "中文", "¿Qué? «Ça» façade — 10°"]


def _path(face):
    return str(SYSTEM / face) if (SYSTEM / face).exists() else F.dejavu_path(
        face)


@pytest.fixture(scope="module")
def fonts():
    cache = {}

    def get(face, size):
        key = (face, size)
        if key not in cache:
            cache[key] = (ImageFont.truetype(_path(face), size),
                          F.FreeTypeFont(_path(face), size))
        return cache[key]
    return get


def _check_layout(pil, mine, strings):
    for s in strings:
        assert mine.getlength(s) == pil.getlength(s), repr(s)
        assert mine.getbbox(s) == pil.getbbox(s), repr(s)


@pytest.mark.parametrize("face", FACES)
def test_metrics_every_size(face):
    for size in range(4, 401):
        pil = ImageFont.truetype(_path(face), size)
        assert F.FreeTypeFont(_path(face), size).getmetrics() == \
            pil.getmetrics(), size


@pytest.mark.parametrize("face", FACES)
def test_layout_ascii_pairs_20px(face, fonts):
    _check_layout(*fonts(face, 20), PAIRS)


@pytest.mark.parametrize("size", [4, 9, 13, 33, 57, 150, 400])
@pytest.mark.parametrize("face", FACES)
def test_layout_ascii_pairs_sampled(face, size, fonts):
    _check_layout(*fonts(face, size), PAIRS[size % 31::31])


@pytest.mark.parametrize("size", [20, 13, 57])
@pytest.mark.parametrize("face", FACES)
def test_layout_latin1_cjk_rows(face, size, fonts):
    strings = LATIN1 + [c + a for c in LATIN1 for a in "AVTfo1."] + \
        PANEL_ROWS + ["\xad", "A\xadV", "中", "fi", "ffl", "ﬁ"]
    _check_layout(*fonts(face, size), strings)


def test_kerning_and_ligatures_move_the_pen(fonts):
    pil, mine = fonts("DejaVuSans.ttf", 20)
    # the RAQM figures: kerned pairs and spaces unrounded in 26.6
    assert mine.getlength("AV") == 26.09375 == pil.getlength("AV")
    assert mine.getlength("To") == 21.0625
    assert mine.getlength("  7.  ") == 44.515625
    assert mine.getlength("SCAN 12345") == 125.28125
    assert mine.getlength("中文") == 24.0       # two .notdef glyphs
    # 'fi' is one ligature glyph: narrower than f + i apart
    assert mine.getlength("fi") < mine.getlength("f") + mine.getlength("i")
    assert mine.getlength("\xad") == 0.0      # default ignorable


def test_script_runs_follow_raqm():
    assert F._runs("1: 中文abc  0.5") == [(0, 5, "hani"), (5, 13, "latn")]
    assert F._runs("  7.  ") == [(0, 6, "")]
    assert F._runs("Ab́c") == [(0, 4, "latn")]
    assert unicodedata.category("́") == "Mn"


def _draw_pair(face, size, xy, text, fill, fonts, shape):
    pil, mine = fonts(face, size)
    ref = Image.new("RGB", shape, (255, 255, 255))
    ImageDraw.Draw(ref).text(xy, text, fill, font=pil)
    got = np.full((shape[1], shape[0], 3), 255, np.uint8)
    F.draw_text(got, xy, text, fill, mine)
    return np.asarray(ref), got


@pytest.mark.parametrize("face", FACES)
def test_drawn_text_equals_pil(face, fonts):
    rng = np.random.default_rng(FACES.index(face))
    cases = [(20, (0, 25 * (r + 1)), row) for r, row in
             enumerate(PANEL_ROWS)]
    for size in (9, 13, 20, 31, 57):
        for _ in range(4):
            text = "".join(rng.choice(ASCII[1:], 12))
            xy = (float(rng.uniform(0, 20)), float(rng.uniform(0, 20)))
            cases.append((size, xy, text))
    for size, xy, text in cases:
        w = int(fonts(face, size)[1].getlength(text)) + 60
        ref, got = _draw_pair(face, size, xy, text, (10, 20, 30), fonts,
                              (w, int(xy[1]) + 2 * size + 20))
        np.testing.assert_array_equal(got, ref, err_msg=f"{size} {text!r}")


@pytest.mark.parametrize("text", ["llll", "Hg", "fi AV"])
def test_fractional_origins_equal_pil(text, fonts):
    """A glyph origin (pen + fractional start) is rounded to whole pixels
    in both directions, the mask widened by the start's ceiling."""
    for xy in ((0.0, 0.0), (0.3, 0.2), (0.5, 0.5), (0.7, 0.55), (3.25, 10.7)):
        ref, got = _draw_pair("DejaVuSans.ttf", 40, xy, text, (0, 0, 0),
                              fonts, (140, 70))
        np.testing.assert_array_equal(got, ref, err_msg=str(xy))


def test_multiline_and_fill(fonts):
    ref, got = _draw_pair("DejaVuSerif.ttf", 20, (3, 4), "ab\ncd\nef",
                          (200, 30, 90), fonts, (60, 90))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("face", FACES)
def test_masks_equal_getmask2(face, fonts):
    for size in (11, 20, 48):
        pil, mine = fonts(face, size)
        for text, start in (("Hg", (0.0, 0.0)), ("Wave 7.", (0.4, 0.6)),
                            ("中文 ¿Qué?", (0.9, 0.1))):
            mask, offset = pil.getmask2(text, "L", start=start)
            got, got_off = mine.render(text, start)
            assert got_off == offset
            np.testing.assert_array_equal(
                got, np.array(mask, np.uint8).reshape(mask.size[1],
                                                      mask.size[0]))


@pytest.mark.parametrize("face", FACES)
def test_committed_faces_are_the_system_files(face):
    committed = F.FONT_DIR / face
    assert committed.exists()
    if (SYSTEM / face).exists():
        assert hashlib.sha256(committed.read_bytes()).hexdigest() == \
            hashlib.sha256((SYSTEM / face).read_bytes()).hexdigest()
    assert F.dejavu_path(face) == str(
        SYSTEM / face if (SYSTEM / face).exists() else committed)
    assert (F.FONT_DIR / "copyright").read_text().count("Bitstream") >= 2


def test_bad_font_raises(tmp_path):
    bad = tmp_path / "x.ttf"
    bad.write_bytes(b"not a font" * 10)
    with pytest.raises(OSError):
        F.FreeTypeFont(str(bad), 20)
    with pytest.raises(ValueError):
        F.FreeTypeFont(_path("DejaVuSans.ttf"), 0)

"""The port's held-out page generator (onnxocr_tpu_torch/tools/
make_heldout_synth.py) and the text path under it, stage by stage, against
the matplotlib 3.10 (FreeType 2.6.1) and Pillow 12 of the JAX package's
tools/make_heldout_synth.py, on the CPU:

* the auto-hinted outlines (utils/ft2font.py, csrc/host/autohint.cc) equal
  `FT2Font.load_char(c, FORCE_AUTOHINT)` + `get_path()` point for point on
  every character `_rand_line` can emit, in the five faces, at every pixel
  size the tool draws (11 to 33, the headline's 22 among them);
* `set_text`'s width, height, descent and bitmap offset and
  `draw_glyphs_to_bitmap`'s image equal FT2Font's on seeded lines;
* one-text and one-rule figures (utils/mpl_page.py, csrc/host/agg.cc)
  equal `fig.canvas.buffer_rgba()` on both backgrounds;
* `pil_ops.rotate`, `pil_ops.gaussian_blur` and the JPEG round trip equal
  PIL's on seeded arrays, and `imencode_png`'s pixels cv2's file's;
* `_rand_line`, the plan and gt.json equal the JAX tool's (imported by
  path), and all 24 pages the port writes decode to the committed
  onnxocr_tpu/test_images_heldout/ pages value for value;
* `--device` is checked: without CUDA and without --device cpu it exits.
"""
import importlib.util
import io
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib import font_manager  # noqa: E402
from matplotlib.ft2font import FT2Font, LoadFlags  # noqa: E402
from PIL import Image, ImageFilter  # noqa: E402

from onnxocr_tpu_torch.tools import make_heldout_synth as port  # noqa: E402
from onnxocr_tpu_torch.utils import (ft2font, imcodec, mpl_page,  # noqa: E402
                                     pil_ops)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
COMMITTED = REPO / "onnxocr_tpu" / "test_images_heldout"
MPL_TTF = Path(matplotlib.get_data_path()) / "fonts" / "ttf"
FACES = ["STIXGeneral.ttf", "STIXGeneralBol.ttf", "STIXGeneralItalic.ttf",
         "STIXGeneralBolIta.ttf", "cmr10.ttf"]
PORT_FACES = [Path(p) for p in port.HELD_OUT_FONTS]
# every character _rand_line can emit, and "lp"
CHARS = sorted(set(
    "".join(port.WORDS) + "".join(port.WORDS).upper() +
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789,.-:% lp"))
SIZES_PX = range(11, 34)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_make_heldout_synth", REPO / "tools" / "make_heldout_synth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _decompose(pts, on, ends):
    """FT_Outline_Decompose of a quadratic outline as FT2Font.get_path
    emits it: (x, y) in 26.6 per vertex, None per CLOSEPOLY."""
    out = []
    first = 0
    for last in ends:
        last = int(last)
        vs = tuple(int(v) for v in pts[first])
        limit, i = last, first
        if not on[first]:
            if on[last]:
                vs = tuple(int(v) for v in pts[last])
                limit -= 1
            else:
                vs = (int((pts[first][0] + pts[last][0]) / 2),
                      int((pts[first][1] + pts[last][1]) / 2))
            i = first - 1
        out.append(vs)
        closed = False
        while i < limit and not closed:
            i += 1
            if on[i]:
                out.append(tuple(int(v) for v in pts[i]))
                continue
            c = pts[i]
            while True:
                if i < limit:
                    i += 1
                    q = pts[i]
                    if on[i]:
                        out += [tuple(int(v) for v in c),
                                tuple(int(v) for v in q)]
                        break
                    out += [tuple(int(v) for v in c),
                            (int((c[0] + q[0]) / 2), int((c[1] + q[1]) / 2))]
                    c = q
                    continue
                out += [tuple(int(v) for v in c), vs]
                closed = True
                break
        if not closed:
            out.append(vs)
        out.append(None)
        first = last + 1
    return out


def _mpl_path(font, ch):
    font.load_char(ord(ch), LoadFlags.FORCE_AUTOHINT)
    verts, codes = font.get_path()
    return [None if c == 79 else (int(round(v[0] * 64)), int(round(v[1] * 64)))
            for v, c in zip(verts, codes)]


@pytest.mark.parametrize("face", range(5))
def test_hinted_outlines_equal_ft2font(face):
    """Every character the tool draws, at 11-33 px, point for point."""
    theirs = FT2Font(str(MPL_TTF / FACES[face]), hinting_factor=8)
    mine = ft2font.FT2Font(PORT_FACES[face])
    checked = 0
    for px in SIZES_PX:
        theirs.set_size(px * 72 / 100, 100)
        mine.set_size(px * 72 / 100, 100)
        for ch in CHARS:
            if ch == " ":
                continue
            mine.load_char(ord(ch))
            pts, on, ends, _ = mine.outline()
            assert _decompose(pts, on, ends) == _mpl_path(theirs, ch), \
                (FACES[face], px, ch)
            checked += 1
    assert checked == len(SIZES_PX) * (len(CHARS) - 1)


@pytest.mark.parametrize("face", range(5))
def test_set_text_and_bitmap_equal_ft2font(face):
    """Seeded lines of the tool's kinds: width, height, descent, bitmap
    offset and the string image."""
    rng = np.random.default_rng(face)
    theirs = FT2Font(str(MPL_TTF / FACES[face]), hinting_factor=8)
    mine = ft2font.FT2Font(PORT_FACES[face])
    for _ in range(30):
        s = port._rand_line(rng)
        px = int(rng.integers(11, 34))
        theirs.set_size(px * 72 / 100, 100)
        mine.set_size(px * 72 / 100, 100)
        theirs.set_text(s, 0, flags=LoadFlags.FORCE_AUTOHINT)
        mine.set_text(s)
        assert mine.get_width_height() == theirs.get_width_height(), (s, px)
        assert mine.get_descent() == theirs.get_descent(), (s, px)
        assert mine.get_bitmap_offset() == theirs.get_bitmap_offset()
        theirs.draw_glyphs_to_bitmap(antialiased=True)
        mine.draw_glyphs_to_bitmap()
        np.testing.assert_array_equal(mine.get_image(),
                                      np.asarray(theirs.get_image()))


def _mpl_figure(items, bg):
    fig = plt.figure(figsize=(9.0, 6.8), dpi=100)
    fig.patch.set_facecolor((bg, bg, bg))
    ax = fig.add_axes([0, 0, 1, 1])
    ax.set_axis_off()
    ax.set_xlim(0, 900)
    ax.set_ylim(680, 0)
    for it in items:
        if it[0] == "rule":
            ax.plot(it[1], it[2], color=str(it[3]), lw=0.8)
        else:
            _, x, y, s, face, px, ink, va = it
            ax.text(x, y, s, fontproperties=font_manager.FontProperties(
                fname=str(MPL_TTF / FACES[face])), fontsize=px * 72 / 100,
                color=str(ink), va=va)
    fig.canvas.draw()
    rgb = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
    plt.close(fig)
    return rgb


def _port_figure(items, bg):
    page = mpl_page.Page(900, 680, bg)
    for it in items:
        if it[0] == "rule":
            page.rule(it[1], it[2], it[3], 0.8)
        else:
            _, x, y, s, face, px, ink, va = it
            page.text(x, y, s, PORT_FACES[face], px * 72 / 100, ink, va)
    return page.draw()


FIGURES = [
    [("rule", [60, 840], [70.0] * 2, 0.05)],
    [("rule", [60, 840], [70 + 3 * 540 / 11] * 2, 0.38),
     ("rule", [np.linspace(60, 840, 4)[1]] * 2, [70, 610], 0.38)],
    [("rule", [60, 840], [70 + 67.5] * 2, 0.05)],
    [("text", 100.0, 50.0, "report total 12,345.67", 0, 20, 0.05, "top")],
    [("text", 300.0, 150.5, "INVOICE: 123", 3, 17, 0.38, "baseline")],
    [("text", 288.0, 14, "SHIPPING STATUS", 1, 22, 0.05, "top")],
    [("text", 700.0, 300.0, "runs past the right margin", 2, 33, 0.05,
      "top")],
    [("text", 60.0 + 8, 70 + 0.62 * 60.0, "2019-07-21", 4, 13, 0.38,
      "baseline")],
]


@pytest.mark.parametrize("case", range(len(FIGURES)))
@pytest.mark.parametrize("bg", [1.0, 0.72])
def test_figure_equals_matplotlib(case, bg):
    """A rule or a text line on the page's figure: buffer_rgba's RGB."""
    np.testing.assert_array_equal(_port_figure(FIGURES[case], bg),
                                  _mpl_figure(FIGURES[case], bg))


def test_pil_degradations_equal_pil():
    """rotate (NEAREST, white fill), GaussianBlur and the JPEG round trip
    at the tool's parameter ranges on seeded arrays."""
    rng = np.random.default_rng(7)
    for _ in range(6):
        h, w = (int(v) for v in rng.integers(8, 160, 2))
        img = np.clip(rng.normal(128, 60, (h, w, 3)), 0, 255).astype(
            np.uint8)
        angle = float(rng.uniform(-1.2, 1.2))
        want = np.asarray(Image.fromarray(img).rotate(
            angle, expand=False, fillcolor=(255, 255, 255)))
        np.testing.assert_array_equal(pil_ops.rotate(img, angle), want)
        radius = float(rng.uniform(0.4, 1.0))
        want = np.asarray(Image.fromarray(img).filter(
            ImageFilter.GaussianBlur(radius=radius)))
        np.testing.assert_array_equal(pil_ops.gaussian_blur(img, radius),
                                      want)
        q = int(rng.integers(55, 80))
        b = io.BytesIO()
        Image.fromarray(img).save(b, "JPEG", quality=q)
        mine = imcodec.imencode_jpeg(np.ascontiguousarray(img[:, :, ::-1]), q)
        np.testing.assert_array_equal(imcodec.jpeg_pil_rgb(mine),
                                      np.asarray(Image.open(b)))


def test_png_writer_pixels_equal_cv2(tmp_path):
    """imencode_png's file decodes (cv2 and the port) to the pixels
    cv2.imwrite's does."""
    rng = np.random.default_rng(3)
    for shape in ((1, 1, 3), (37, 53, 3), (68, 90, 3), (5, 300, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(tmp_path / "cv2.png")
        cv2.imwrite(path, img)
        blob = imcodec.imencode_png(img)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        got = cv2.imdecode(np.frombuffer(blob, np.uint8),
                           cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(imcodec.imdecode(blob),
                                      cv2.imread(path))


def test_rand_line_and_plan_equal_jax_tool():
    jt = _jax_tool()
    assert port.WORDS == jt.WORDS
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(300):
        assert port._rand_line(r1) == jt._rand_line(r2)
    assert [Path(p).name for p in port.HELD_OUT_FONTS] == \
        [Path(p).name for p in jt.HELD_OUT_FONTS]
    for ours, theirs in zip(port.HELD_OUT_FONTS, jt.HELD_OUT_FONTS):
        assert Path(ours).read_bytes() == Path(theirs).read_bytes()


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    out = tmp_path_factory.mktemp("heldout")
    lines = []
    port.generate(str(out), 20260819, log=lambda *a: lines.append(a))
    return out, lines


def test_pages_equal_committed(generated):
    """All 24 pages decode to the committed pages value for value."""
    out, _ = generated
    names = sorted(p.name for p in COMMITTED.glob("synth_*.png"))
    assert names == sorted(p.name for p in out.glob("synth_*.png"))
    assert len(names) == 24
    for name in names:
        want = cv2.imread(str(COMMITTED / name))
        np.testing.assert_array_equal(cv2.imread(str(out / name)), want,
                                      err_msg=name)
        np.testing.assert_array_equal(
            imcodec.imdecode((out / name).read_bytes()), want, err_msg=name)


def test_gt_json_byte_equal_and_log(generated):
    out, lines = generated
    assert (out / "gt.json").read_bytes() == \
        (COMMITTED / "gt.json").read_bytes()
    gt = json.loads((COMMITTED / "gt.json").read_text())
    assert [a[0] for a in lines[:-1]] == list(gt)
    assert lines[-1][0] == "pages=24 lines=%d -> %s" % (
        sum(len(v) for v in gt.values()), out)


def test_device_check_and_outdir(monkeypatch, tmp_path):
    """Without CUDA and without --device cpu the tool exits before
    writing; its default output is under build/, not the JAX package's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        port.main(["--outdir", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()
    assert Path(port.OUT_DIR) == REPO / "build" / "test_images_heldout"

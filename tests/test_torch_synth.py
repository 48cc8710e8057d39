"""The port's synthetic-data renderer (onnxocr_tpu_torch/train/synth.py)
against the JAX package's (onnxocr_tpu/train/synth.py: PIL, cv2, fontTools)
on the CPU, and the twins it is built on.

* Renderer: the same stand-in dictionary (every code point of
  U+0020–U+2BFF a DejaVu face covers, padded with `<i>` to 18383 lines),
  the same pinned lexicon and seed on both sides. The charset, 50
  `sample_line` draws, `render_line` with and without alpha,
  `render_line_photo`, `render_line_dotmatrix`, `add_margins`,
  `rec_batch(8, 320, 14)` with every `*_frac` > 0 and `det_batch(4, 320,
  hard_frac=0.4, table_frac=0.3)` are equal at three seeds, and the
  generator's state is equal after every call (no branch diverged). The
  one stated bound: a `det_page_hard` page's background is a 4 × 4 → page
  cubic upscale that cv2 hands to IPP, whose sum order the twin does not
  reproduce (its values within 8e-5 of cv2's, ROADMAP §3); after the
  page's uint8 rounding and JPEG round trip a hard page may differ on at
  most 0.5 % of its values, by at most 8 levels
  (`test_hard_pages_within_the_bound` prints what 12 pages show). Every
  other page is equal.
* cv2 twins (utils/cv_ops.py) at synth.py's shapes and dtypes: INTER_LINEAR
  (uint8 and float32), INTER_AREA (reducing and enlarging), INTER_NEAREST,
  INTER_CUBIC from 2 × 3, GaussianBlur 3 and 5 (uint8, float32),
  copyMakeBorder, line (thickness 1–4), rectangle (1–3, filled) and circle
  (1–3): max abs 0 against cv2 5.0. INTER_CUBIC from 4 × 4: within 8e-5.
* Fonts (utils/font.py): on all sixteen `synth.FONTS` faces present here,
  masks and bboxes of seeded lines of each face's renderable characters
  (Latin, Greek, Cyrillic, arrows, symbols mixed) equal PIL's at sizes 20,
  26, 32, 38 and 44, drawn into 'L' images as `render_line` draws them;
  `font.codepoints` equals fontTools' `getBestCmap()` keys.
"""
import os
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from fontTools.ttLib import TTFont
from PIL import Image, ImageDraw, ImageFont

from onnxocr_tpu.train import synth as jsynth

from onnxocr_tpu_torch.train import synth
from onnxocr_tpu_torch.utils import cv_ops
from onnxocr_tpu_torch.utils import font as ft

SEEDS = (0, 1, 2)
HARD_MAX_FRAC = 0.005
HARD_MAX_LEVELS = 8


def standin_dict(path) -> str:
    """Write the stand-in dictionary: every code point of U+0020–U+2BFF
    that one of the DejaVu faces of synth.FONTS covers, then `<i>`
    placeholders up to 18383 lines."""
    covered = set()
    for face in synth.FONTS:
        if "DejaVu" in face and os.path.exists(face):
            covered |= ft.codepoints(face)
    chars = [chr(c) for c in range(0x20, 0x2C00) if c in covered]
    lines = chars + [f"<{i}>" for i in range(18383 - len(chars))]
    Path(path).write_text("".join(line + "\n" for line in lines),
                          encoding="utf-8")
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dict_path(tmp_path_factory):
    return standin_dict(tmp_path_factory.mktemp("dict") / "ppocrv5_dict.txt")


@pytest.fixture(scope="module")
def c2i(dict_path):
    lexicon = jsynth._lexicon()
    jsynth._LEXICON_CACHE = list(lexicon)
    synth._LEXICON_CACHE = list(lexicon)
    return jsynth.charset_from_dict(dict_path, charset=None)


def _pair(c2i, seed):
    kw = dict(char_to_idx=c2i, seed=seed, structured_frac=0.5,
              lowres_frac=0.3, photo_frac=0.3, dotmatrix_frac=0.2)
    return jsynth.TextRenderer(**kw), synth.TextRenderer(**kw)


def _equal(a, b, what):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(b, a, err_msg=what)
    else:
        assert a == b, what


def _same_state(rj, rp, what):
    assert rj.rng.bit_generator.state == rp.rng.bit_generator.state, \
        f"the generators diverged after {what}"


def test_charset_and_fonts_match(dict_path, c2i):
    assert synth.charset_from_dict(dict_path, charset=None) == c2i
    assert synth.charset_from_dict(dict_path) == jsynth.charset_from_dict(
        dict_path)
    assert synth.DEFAULT_CHARSET == jsynth.DEFAULT_CHARSET
    assert synth._harvest_lexicon() == jsynth._harvest_lexicon()
    rj, rp = _pair(c2i, 0)
    assert rp.charset == rj.charset and len(rp.charset) > 1200
    assert list(rp._fonts) == list(rj._fonts)
    assert rp._font_chars == rj._font_chars
    assert rp._lexicon == rj._lexicon


@pytest.mark.parametrize("seed", SEEDS)
def test_lines_match_jax(c2i, seed):
    rj, rp = _pair(c2i, seed)
    for i in range(50):
        _equal(rj.sample_line(14), rp.sample_line(14), f"sample_line {i}")
        _same_state(rj, rp, f"sample_line {i}")
    for i in range(12):
        text, key = rj.sample_line(14)
        rp.sample_line(14)
        for name, args, kw in (
                ("render_line", (text, 48, 320), {}),
                ("render_line", (text, 30, 200), {"return_alpha": True}),
                ("render_line_photo", (text, 48, 320), {}),
                ("render_line_dotmatrix", (text, 48, 320), {})):
            _equal(getattr(rj, name)(*args, font_key=key, **kw),
                   getattr(rp, name)(*args, font_key=key, **kw),
                   f"{name} {i}")
            _same_state(rj, rp, f"{name} {i}")
        line = rj.render_line(text, 48, 320, font_key=key)
        rp.render_line(text, 48, 320, font_key=key)
        _equal(rj.add_margins(line, 48, 320), rp.add_margins(line, 48, 320),
               f"add_margins {i}")
        _same_state(rj, rp, f"add_margins {i}")


@pytest.mark.parametrize("seed", SEEDS)
def test_rec_batch_matches_jax(c2i, seed):
    rj, rp = _pair(c2i, seed)
    for k in range(2):
        _equal(rj.rec_batch(8, 320, 14, return_widths=True),
               rp.rec_batch(8, 320, 14, return_widths=True), f"rec_batch {k}")
        _same_state(rj, rp, f"rec_batch {k}")


def _levels(a, b):
    """|a - b| of two normalized det images in uint8 levels."""
    from onnxocr_tpu_torch.ops import det_pre
    return np.rint(np.abs(a - b) * det_pre.IMAGENET_STD * 255.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_det_batch_matches_jax(c2i, seed):
    rj, rp = _pair(c2i, seed)
    kinds = []
    for kind in ("det_page", "det_page_hard", "det_page_table"):
        def tracked(size, _f=getattr(rp, kind), _k=kind):
            kinds.append(_k)
            return _f(size)
        setattr(rp, kind, tracked)
    for k in range(2):
        kinds.clear()
        (ij, mj, kj), (ip, mp, kp) = (
            rj.det_batch(4, 320, hard_frac=0.4, table_frac=0.3),
            rp.det_batch(4, 320, hard_frac=0.4, table_frac=0.3))
        _same_state(rj, rp, f"det_batch {k}")
        _equal((mj, kj), (mp, kp), f"det_batch {k} maps")
        assert len(kinds) == 4
        for i, kind in enumerate(kinds):
            if kind != "det_page_hard":
                _equal(ij[i], ip[i], f"det_batch {k} page {i} ({kind})")
                continue
            lv = _levels(ij[i], ip[i])
            assert (lv > 0).mean() <= HARD_MAX_FRAC, (k, i)
            assert lv.max() <= HARD_MAX_LEVELS, (k, i)


def test_hard_pages_within_the_bound(c2i):
    """12 hard pages at 320²: the maps equal, the pages within the bound;
    prints how many differ and by how much."""
    rj, rp = _pair(c2i, 5)
    differ, frac, levels = 0, 0.0, 0
    for i in range(12):
        pj, mj, kj = rj.det_page_hard(320)
        pp, mp, kp = rp.det_page_hard(320)
        _same_state(rj, rp, f"det_page_hard {i}")
        _equal((mj, kj), (mp, kp), f"det_page_hard {i} maps")
        d = np.abs(pj.astype(int) - pp.astype(int))
        differ += bool(d.max())
        frac, levels = max(frac, (d > 0).mean()), max(levels, int(d.max()))
        assert (d > 0).mean() <= HARD_MAX_FRAC and d.max() <= \
            HARD_MAX_LEVELS, i
    print(f"hard pages differing from the JAX package's: {differ} of 12, "
          f"at most {100 * frac:.4f} % of a page's values, {levels} levels")


# ------------------------------------------------------------ cv2 twins
def _rng(seed):
    return np.random.default_rng(seed)


def test_resize_twins_match_cv2():
    rng = _rng(0)
    for _ in range(60):
        H, W = int(rng.integers(8, 60)), int(rng.integers(8, 330))
        h, w = int(rng.integers(8, 60)), int(rng.integers(8, 330))
        u8 = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        alpha = (rng.random((H, W)) * (rng.random((H, W)) < 0.5)).astype(
            np.float32)
        for got, want in (
                (cv_ops.resize_linear(u8, (w, h)), cv2.resize(u8, (w, h))),
                (cv_ops.resize_linear(u8[:, :, 0], (w, h)),
                 cv2.resize(u8[:, :, 0], (w, h))),
                (cv_ops.resize_linear(alpha, (w, h)),
                 cv2.resize(alpha, (w, h))),
                (cv_ops.resize_area(u8, (w, h)),
                 cv2.resize(u8, (w, h), interpolation=cv2.INTER_AREA)),
                (cv_ops.resize_nearest(u8, (w, h)),
                 cv2.resize(u8, (w, h), interpolation=cv2.INTER_NEAREST))):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        base = rng.uniform(40, 230, size=(2, 3, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            cv_ops.resize_cubic(base, (w, h)),
            cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC))
    for S in (64, 320):
        base = rng.uniform(40, 230, size=(4, 4, 3)).astype(np.float32)
        got = cv_ops.resize_cubic(base, (S, S))
        want = cv2.resize(base, (S, S), interpolation=cv2.INTER_CUBIC)
        assert np.abs(got - want).max() <= 8e-5


def test_blur_and_border_twins_match_cv2():
    rng = _rng(1)
    for _ in range(40):
        H, W = int(rng.integers(8, 60)), int(rng.integers(8, 330))
        u8 = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        for k in (3, 5):
            np.testing.assert_array_equal(cv_ops.gaussian_blur(u8, k),
                                          cv2.GaussianBlur(u8, (k, k), 0))
            np.testing.assert_array_equal(
                cv_ops.gaussian_blur(u8[:, :, 0], k),
                cv2.GaussianBlur(u8[:, :, 0], (k, k), 0))
        f = (rng.uniform(150, 245, (H, W, 3)) +
             rng.normal(0, 4, (H, W, 3))).astype(np.float32)
        f[rng.random((H, W)) < 0.2] = np.float32(rng.uniform(0, 90))
        np.testing.assert_array_equal(cv_ops.gaussian_blur(f, 3),
                                      cv2.GaussianBlur(f, (3, 3), 0))
        t, b, l, r = (int(v) for v in rng.integers(0, 20, 4))
        v = int(rng.integers(0, 256))
        np.testing.assert_array_equal(
            cv_ops.copy_make_border(u8, t, b, l, r, (v, v, v)),
            cv2.copyMakeBorder(u8, t, b, l, r, cv2.BORDER_CONSTANT,
                               value=(v, v, v)))


@pytest.mark.parametrize("size", [64, 320])
def test_drawing_twins_match_cv2(size):
    rng = _rng(size)
    for _ in range(150):
        p1 = (int(rng.integers(0, size)), int(rng.integers(0, size)))
        p2 = (int(rng.integers(0, size)), int(rng.integers(0, size)))
        col = tuple(int(c) for c in rng.integers(0, 256, 3))
        base = rng.integers(0, 256, (size, size, 3)).astype(np.uint8)
        r = int(rng.integers(4, size // 4))
        for twin, ref, args in (
                (cv_ops.line, cv2.line,
                 (p1, p2, col, int(rng.integers(1, 5)))),
                (cv_ops.rectangle, cv2.rectangle,
                 (p1, p2, col, int(rng.integers(1, 4)))),
                (cv_ops.rectangle, cv2.rectangle, (p1, p2, col, -1)),
                (cv_ops.circle, cv2.circle,
                 (p1, r, col, int(rng.integers(1, 4))))):
            a, b = base.copy(), base.copy()
            ref(a, *args)
            twin(b, *args)
            np.testing.assert_array_equal(b, a, err_msg=f"{ref.__name__} "
                                                        f"{args}")


# ---------------------------------------------------------------- fonts
FACES = [f for f in synth.FONTS if os.path.exists(f)]


@pytest.mark.parametrize("face", FACES, ids=[Path(f).name for f in FACES])
def test_font_masks_and_bboxes_match_pil(face):
    cps = sorted(c for c in ft.codepoints(face)
                 if 0x20 <= c < 0x2C00 and jsynth._drawable(chr(c)))
    assert ft.codepoints(face) == set(TTFont(face, lazy=True).getBestCmap())
    rng = _rng(len(cps))
    for size in (20, 26, 32, 38, 44):
        pil, mine = ImageFont.truetype(face, size), ft.FreeTypeFont(face,
                                                                    size)
        for _ in range(12):
            n = int(rng.integers(1, 19))
            text = "".join(chr(c) for c in rng.choice(cps, n)).strip() or "a"
            bbox = ImageDraw.Draw(Image.new("L", (8, 8))).textbbox(
                (0, 0), text, font=pil)
            assert mine.getbbox(text) == bbox, (size, text)
            W, H = max(bbox[2] - bbox[0], 4) + 8, max(bbox[3] - bbox[1],
                                                      4) + 8
            xy = (4 - bbox[0], 4 - bbox[1])
            img = Image.new("L", (W, H), 200)
            ImageDraw.Draw(img).text(xy, text, fill=31, font=pil)
            got = np.full((H, W), 200, np.uint8)
            ft.draw_text(got, xy, text, 31, mine)
            np.testing.assert_array_equal(got, np.asarray(img),
                                          err_msg=f"{size} {text!r}")

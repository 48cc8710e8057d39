"""Damaged and planar-JPEG TIFFs in the port's reader
(onnxocr_tpu_torch/utils/imcodec.py over csrc/host/tiff.cc and
csrc/host/imcodec.cc) against cv2 5.0 (libtiff 4.7.1, zlib 1.2) on the CPU.

Every case is value-equal to `cv2.imdecode(buf, cv2.IMREAD_COLOR)` (0
values differ), or None where cv2 gives None:

* Planar YCbCr JPEG-in-TIFF: each plane's strips are one-component JPEGs
  (JPEGCOLORMODE_RGB takes chunky data only), converted by TIFFYCbCrToRGB's
  tables at 1 x 1; subsampled planar layouts, and a file without
  YCbCrSubsampling (2 x 2 by default), have no put routine and give None.
* Strips cut short, overwritten with noise and zeroed, under every codec
  (none, PackBits, LZW, Deflate), FillOrder 1 and 2, predictor 1 and 2,
  chunky and planar, 8-bit RGB and big-endian 16-bit grey: the codec keeps
  what it decoded before the fault, the rest of the strip stays 0, a strip
  that failed keeps its differences and its file byte order, and the next
  strip decodes on its own.
* Uncompressed tiles whose byte counts are short or long: the KiB-rounded
  raw buffer libtiff grows and checks against the tile size; planar tiled
  CMYK with one or two ExtraSamples among them.
* libtiff's directory repairs: StripByteCounts estimated where it is
  missing, bogus for a single strip or unequal for uncompressed strips;
  tags of a type, count or value its readers refuse (fatal for the tags
  TIFFReadDirectory needs, ignored for the others); unknown compression
  schemes (zeros); RowsPerStrip past cv2's 1 GiB strip buffer.
* 1,200 seeded header mutants (`test_torch_imcodec._mutant`) of eight
  scanned layouts, JPEGTables whose last segment runs past the tag
  among them (libtiff's fake EOI, read again at every read past the end).
* The committed samples of these layouts against codec_samples.json.
"""
import hashlib
import json
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from onnxocr_tpu_torch.utils import imcodec

from test_torch_imcodec import (_lzw, _mutant, _tiff_entry, _tiff_set,
                                write_tiff)
from test_torch_jpeg_lossless import lossless_jpeg
from test_torch_tiff import (PAGE, SAMPLES, _small_rgb, answers_as_cv2,
                             ifd_tags, pil_tiff, seeded_bits, strips_of,
                             tiff_file)


# ------------------------------------------------- planar YCbCr JPEG
def planar_jpeg(rgb, sub=(1, 1), rps=None, quality=75, tags=None,
                with_530=True):
    """An RGB image as planar YCbCr JPEG-in-TIFF: PIL's grey JPEG strips
    of each plane (Cb and Cr cut to `sub`), the tables of the last."""
    ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
    h, w = ycc.shape[:2]
    chunks = []
    for i in range(3):
        plane = ycc[:, :, i] if i == 0 else ycc[::sub[1], ::sub[0], i]
        strips, t = strips_of(pil_tiff(
            Image.fromarray(np.ascontiguousarray(plane)), compression="jpeg",
            quality=quality, tiffinfo={278: rps} if rps else {}))
        chunks += strips
    base = {258: (3, [8, 8, 8]), 259: (3, [7]), 262: (3, [6]),
            277: (3, [3]), 284: (3, [2]), 347: (7, t[347])}
    if with_530:
        base[530] = (3, list(sub))
    base.update(tags or {})
    return tiff_file(w, h, chunks, base, rps=t[278][0])


PLANAR = {
    "1x1": ({}, "decoded"),
    "1x1-strips-of-16": ({"rps": 16}, "decoded"),
    "1x1-q95": ({"quality": 95}, "decoded"),
    "1x1-jpeg-ranges": ({"tags": {532: (5, [(16, 1), (235, 1), (128, 1),
                                            (240, 1), (128, 1),
                                            (240, 1)])}}, "decoded"),
    "2x2": ({"sub": (2, 2)}, "none"),
    "2x1": ({"sub": (2, 1)}, "none"),
    "no-subsampling-tag": ({"with_530": False}, "none"),
}


@pytest.mark.parametrize("case", list(PLANAR))
def test_planar_ycbcr_jpeg_answers_as_cv2(case):
    """Planar YCbCr JPEG-in-TIFF at 1 x 1 (strips of the default size and
    of 16 rows, quality 95, the JPEG ranges' ReferenceBlackWhite) decodes;
    the subsampled layouts and the default 2 x 2 give None, as cv2."""
    kw, verdict = PLANAR[case]
    assert answers_as_cv2(planar_jpeg(_small_rgb(), **kw)) == verdict


# ------------------------------------------------------ damaged strips
_KEEP = (258, 259, 262, 277, 284, 317, 338)


def rebuilt(blob, chunks, fill2=False):
    """A one-IFD TIFF of `blob`'s layout tags over other strips, their
    bits reversed under FillOrder 2."""
    t = ifd_tags(blob)
    if fill2:
        chunks = [imcodec._BIT_REVERSE[np.frombuffer(c, np.uint8)].tobytes()
                  for c in chunks]
    keep = {k: (3, list(v)) for k, v in t.items() if k in _KEEP}
    if fill2:
        keep[266] = (3, [2])
    return tiff_file(t[256][0], t[257][0], chunks, keep, rps=t[278][0],
                     order="<" if blob[:2] == b"II" else ">")


def damaged(chunks, how, k, rng):
    """Strip k cut to a fraction of its bytes, its tail overwritten with
    noise or zeroed; or the last strip cut to half."""
    c = list(chunks)
    kind, frac = how.split("-")
    frac = float(frac)
    if kind == "last":
        c[-1] = c[-1][:max(1, len(c[-1]) // 2)]
        return c
    a = int(len(c[k]) * frac)
    if kind == "cut":
        c[k] = c[k][:max(1, a)]
    else:
        tail = rng.integers(0, 256, len(c[k]) - a, dtype=np.uint8).tobytes() \
            if kind == "noise" else bytes(len(c[k]) - a)
        c[k] = c[k][:a] + tail
    return c


DAMAGE = ("cut-.25", "cut-.5", "cut-.9", "noise-.33", "noise-.8", "zero-.5",
          "last-.5")


@pytest.mark.parametrize("comp", [1, 32773, 5, 8])
def test_damaged_strips_answer_as_cv2(comp):
    """Strip 2 of each layout cut at a quarter, a half and nine tenths of
    its bytes, its last two thirds or fifth overwritten from a seed, its
    second half zeroed, and the last strip cut to half: under FillOrder 1
    and 2, predictor 1 and 2 (LZW, Deflate), chunky and planar RGB, and
    big-endian 16-bit grey; both codec outcomes occur."""
    rng = np.random.default_rng(comp)
    rgb = cv2.imread(str(PAGE / "card.jpg"))[:37, :53, ::-1].copy()
    grey16 = rgb[:, :, 1:2].astype(np.uint16) * 257 + 3
    verdicts = []
    for pred in ((1, 2) if comp in (5, 8) else (1,)):
        for samples, photo, bps, order, planar in (
                (rgb, 2, 8, "<", 1), (rgb, 2, 8, "<", 2),
                (grey16, 1, 16, ">", 1)):
            blob = write_tiff(samples, photo, bps, comp=comp, planar=planar,
                              predictor=pred, rps=8, order=order)
            chunks = strips_of(blob)[0]
            for fill2 in (False, True):
                for how in DAMAGE:
                    verdicts.append(answers_as_cv2(rebuilt(
                        blob, damaged(chunks, how, 2, rng), fill2)))
    assert verdicts.count("decoded") == len(verdicts)


def _rgb_40x30(**kw):
    rgb = cv2.imread(str(PAGE / "card.jpg"))[:30, :40, ::-1].copy()
    return pil_tiff(Image.fromarray(rgb), **kw)


def _strip_replaced(blob, k, fn):
    """The file with strip k's bytes replaced in place by fn(bytes)."""
    t = ifd_tags(blob)
    o, c = t[273][k], t[279][k]
    new = fn(blob[o:o + c])
    assert len(new) == c
    return blob[:o] + new + blob[o + c:]


def _noise(seed, frac):
    def f(data):
        a = int(len(data) * frac)
        return data[:a] + np.random.default_rng(seed).integers(
            0, 256, len(data) - a, dtype=np.uint8).tobytes()
    return f


def ticket_damaged():
    """ticket.jpg (267 x 430) as PIL's RGB LZW TIFF in strips of 16 rows:
    the last two thirds of strip 8's data overwritten from seed 21
    (libtiff: "Using code not yet in table"), the last strip's
    StripByteCounts halved."""
    ticket = cv2.imread(str(PAGE / "ticket.jpg"))
    blob = pil_tiff(Image.fromarray(ticket[:, :, ::-1]),
                    compression="tiff_lzw", tiffinfo={278: 16})
    blob = _strip_replaced(blob, 8, _noise(21, 1 / 3))
    t = ifd_tags(blob)
    e = _tiff_entry(blob, 279)
    where, = struct.unpack("<I", blob[e + 8:e + 12])
    last = where + 4 * (len(t[279]) - 1)
    return blob[:last] + struct.pack("<I", t[279][-1] // 2) + \
        blob[last + 4:]


RECOVERED = {
    "deflate-noise": lambda: _strip_replaced(
        _rgb_40x30(compression="tiff_deflate"), 0, _noise(1, .5)),
    "deflate-zeroed": lambda: _strip_replaced(
        _rgb_40x30(compression="tiff_deflate"), 0,
        lambda d: d[:len(d) // 2] + bytes(len(d) - len(d) // 2)),
    "lzw-noise": lambda: _strip_replaced(
        _rgb_40x30(compression="tiff_lzw"), 0, _noise(2, .5)),
    "deflate-bad-check": lambda: _strip_replaced(
        _rgb_40x30(compression="tiff_deflate"), 0,
        lambda d: d[:-1] + bytes([d[-1] ^ 1])),
    "none-count-halved": lambda: _tiff_set(
        _rgb_40x30(), 279, 40 * 30 * 3 // 2),
    "ticket": ticket_damaged,
}


@pytest.mark.parametrize("case", list(RECOVERED))
def test_recovered_strips_match_cv2(case):
    """Damaged files cv2 reads with libtiff's warnings: a Deflate strip
    whose second half is noise ("incorrect data check" or a decoding
    error) or zeros (rows then zero, one row partial), an LZW strip of
    noise ("Using code not yet in table"), a Deflate stream whose Adler-32
    is off, an uncompressed single strip of half its count (the "Bogus
    StripByteCounts" estimate) and the damaged ticket sample."""
    assert answers_as_cv2(RECOVERED[case]()) == "decoded"


# ------------------------------------------------ uncompressed tiles
TILE_COUNTS = ("short-first", "short-mid", "short-last", "long-first",
               "long-mid", "long-all", "short-all", "plus-1024-mid",
               "minus-1000-mid")


@pytest.mark.parametrize("spp,bps", [(1, 8), (3, 8), (4, 8), (1, 16)])
def test_uncompressed_tile_counts_answer_as_cv2(spp, bps):
    """Tiles of 16 to 64 pixels, chunky and planar, one tile's count (the
    first, the middle, the last) or every count halved, 100 or 1024 bytes
    long or 1000 short: cv2 reads a first-plane tile only where libtiff's
    raw buffer (each count rounded up to a KiB, growing) is the tile size,
    a short tile as zeros, and estimates every count where the first two
    differ (three tiles or more); planar tiles grow that buffer with every
    plane of a tile, a fourth (unspecified extra, read as alpha) too; both
    verdicts occur."""
    rng = np.random.default_rng(spp * bps)
    s = rng.integers(0, 256, (33, 70, spp)).astype(np.uint8)
    if bps == 16:
        s = s.astype(np.uint16) * 257
    verdicts = []
    for tw, th in ((16, 16), (32, 32), (48, 16), (64, 16), (32, 64)):
        for planar in ((1, 2) if spp > 1 else (1,)):
            blob = write_tiff(s, 1 if spp == 1 else 2, bps, tile=(tw, th),
                              planar=planar, extra=[0] if spp == 4 else None)
            chunks, t = strips_of(blob)
            keep = {k: (3, list(v)) for k, v in t.items()
                    if k in (258, 259, 262, 277, 284, 338)}
            n = len(chunks)
            for mode in TILE_COUNTS:
                c = list(chunks)
                at = mode.split("-")[-1]
                for k in {"first": [0], "mid": [n // 2], "last": [n - 1],
                          "all": range(n)}[at]:
                    c[k] = {"short": c[k][:len(c[k]) // 2],
                            "long": c[k] + bytes(100),
                            "plus": c[k] + bytes(1024),
                            "minus": c[k][:max(1, len(c[k]) - 1000)]}[
                        mode.split("-")[0]]
                verdicts.append(answers_as_cv2(tiff_file(
                    70, 33, c, keep, tile=(tw, th))))
    assert "decoded" in verdicts and "none" in verdicts


@pytest.mark.parametrize("spp,extra", [(4, [0]), (4, [2]), (4, [0, 0]),
                                       (5, [0]), (5, [2]), (6, [2, 0])],
                         ids=["4-unspecified", "4-alpha", "4-two-extra",
                              "5-unspecified", "5-alpha", "6-alpha-and-one"])
def test_planar_cmyk_tiles_with_extra_samples_answer_as_cv2(spp, extra):
    """Planar tiled CMYK (Photometric 5) with one or two ExtraSamples,
    tiles of 16 to 64 pixels, each tile's byte count as written or cut
    and grown as in test_uncompressed_tile_counts_answer_as_cv2 (across
    the KiB-rounded raw buffer's rule): cv2 refuses 5 and 6 samples
    ("Unsupported number of channels"), reads 4 samples under any
    ExtraSamples as CMYK where the raw buffer is the tile's size; the port
    answers every file as cv2 does, and both verdicts occur for 4."""
    rng = np.random.default_rng(spp * 10 + len(extra))
    s = rng.integers(0, 256, (33, 70, spp)).astype(np.uint8)
    verdicts = []
    for tw, th in ((16, 16), (32, 32), (64, 16)):
        blob = write_tiff(s, 5, 8, tile=(tw, th), planar=2, extra=extra)
        chunks, t = strips_of(blob)
        keep = {k: (3, list(v)) for k, v in t.items()
                if k in (258, 259, 262, 277, 284, 338)}
        n = len(chunks)
        for mode in ("as-written",) + TILE_COUNTS:
            c = list(chunks)
            if mode != "as-written":
                at = mode.split("-")[-1]
                for k in {"first": [0], "mid": [n // 2], "last": [n - 1],
                          "all": range(n)}[at]:
                    c[k] = {"short": c[k][:len(c[k]) // 2],
                            "long": c[k] + bytes(100),
                            "plus": c[k] + bytes(1024),
                            "minus": c[k][:max(1, len(c[k]) - 1000)]}[
                        mode.split("-")[0]]
            verdicts.append(answers_as_cv2(tiff_file(70, 33, c, keep,
                                                     tile=(tw, th))))
    if spp == 4:
        assert "decoded" in verdicts and "none" in verdicts
    else:
        assert set(verdicts) == {"none"}


# ------------------------------------------------- extra samples
@pytest.mark.parametrize("photo", [0, 1, 3])
def test_extra_samples_answer_as_cv2(photo):
    """Grey (MinIsWhite, MinIsBlack) and palette images of 2 and 3
    samples (alpha unassociated or associated, unspecified extra
    samples), 8 and 16 bits (4 for a palette), chunky and planar, strips
    and 32 x 32 tiles, none and LZW: chunky tiles cut by the right edge are
    read with putgreytile's and put8bitcmaptile's skew in bytes; planar
    grey goes through the RGB put routines (its first plane as stored, an
    unassociated alpha multiplied in, 16 bits as RGB's); planar and
    16-bit palettes give None, as cv2."""
    rng = np.random.default_rng(photo)
    verdicts = []
    for bps in ((8, 4) if photo == 3 else (8, 16)):
        for spp, extra in ((2, [2]), (2, [1]), (2, [0]), (3, [2, 0])):
            if bps == 4 and spp > 1:
                continue
            top = 1 << (4 if photo == 3 else bps)
            s = rng.integers(0, top, (33, 70, spp)).astype(
                np.uint16 if bps == 16 else np.uint8)
            cmap = rng.integers(0, 65536, (3, 1 << bps)) if photo == 3 \
                else None
            for planar in (1, 2):
                for tile in (None, (32, 32)):
                    for comp in (1, 5):
                        verdicts.append(answers_as_cv2(write_tiff(
                            s, photo, bps, tile=tile, planar=planar,
                            extra=extra, cmap=cmap, comp=comp)))
    assert "decoded" in verdicts


# --------------------------------------------------- directory repairs
def _rgb_file(tags=None, drop=(), spp=3):
    img = np.random.default_rng(1).integers(0, 256, (20, 30, 3)).astype(
        np.uint8)[:, :, :spp]
    t = {258: (3, [8] * spp), 259: (3, [1]), 262: (3, [2 if spp == 3 else 1]),
         277: (3, [spp])}
    t.update(tags or {})
    for d in drop:
        t.pop(d)
    return tiff_file(30, 20, [img.tobytes()], t)


def _without(blob, tag):
    """The file with an entry's tag renumbered to an unknown one."""
    e = _tiff_entry(blob, tag)
    return blob[:e] + struct.pack("<H", 60000) + blob[e + 2:]


def _estimated_lzw(extra):
    """A grey LZW file without StripByteCounts whose one strip's data stop
    halfway, the directory after them with an entry of (type, count): the
    estimate counts that entry's bytes (type 0 as 1 a value; an unknown
    type fails it), and so how much of the directory the strip reads."""
    rng = np.random.default_rng(3)
    img = (rng.integers(0, 4, (30, 70)) * 60).astype(np.uint8)
    data = _lzw(img.tobytes())
    strip = data[:len(data) // 2]
    entries = sorted([(256, 3, 1, 70), (257, 3, 1, 30), (258, 3, 1, 8),
                      (259, 3, 1, 5), (262, 3, 1, 1), (273, 4, 1, 8),
                      (40000, *extra, 0)])
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHII", *e) for e in entries) + bytes(4)
    return b"II*\0" + struct.pack("<I", 8 + len(strip)) + strip + ifd


def _retyped(blob, tag, typ):
    """The file with an entry's field type changed, its bytes kept."""
    e = _tiff_entry(blob, tag)
    return blob[:e + 2] + struct.pack("<H", typ) + blob[e + 4:]


def _first_counts(blob, k, value):
    """The file with StripByteCounts[k] set to value."""
    e = _tiff_entry(blob, 279)
    where, = struct.unpack("<I", blob[e + 8:e + 12])
    at = where + 4 * k
    return blob[:at] + struct.pack("<I", value) + blob[at + 4:]


def _directory_cases():
    img = np.random.default_rng(1).integers(0, 256, (20, 30, 3)).astype(
        np.uint8)
    big = np.random.default_rng(2).integers(0, 256, (120, 90, 3)).astype(
        np.uint8)
    raw, big_raw = write_tiff(img, 2, 8), write_tiff(big, 2, 8)
    strips = write_tiff(big, 2, 8, rps=7)
    return {
        # StripByteCounts estimated
        "count-0": (_tiff_set(raw, 279, 0), "decoded"),
        "count-short": (_tiff_set(raw, 279, 700), "decoded"),
        "count-past-end": (_tiff_set(raw, 279, 100000), "decoded"),
        "chopped-count-short": (_tiff_set(big_raw, 279, 5000), "decoded"),
        "chopped-count-0": (_tiff_set(big_raw, 279, 0), "decoded"),
        "lzw-count-0": (_tiff_set(write_tiff(img, 2, 8, comp=5), 279, 0),
                        "decoded"),
        "deflate-count-0": (_tiff_set(write_tiff(img, 2, 8, comp=8), 279,
                                      0), "decoded"),
        "lzw-count-past-end": (_tiff_set(write_tiff(img, 2, 8, comp=5), 279,
                                         100000), "none"),
        "counts-missing": (_without(raw, 279), "decoded"),
        "counts-missing-lzw": (_without(write_tiff(img, 2, 8, comp=5), 279),
                               "decoded"),
        "counts-missing-planar": (_without(write_tiff(img, 2, 8, planar=2),
                                           279), "decoded"),
        "counts-missing-strips": (_without(write_tiff(img, 2, 8, rps=5),
                                           279), "none"),
        "estimate-type-0-entry": (_estimated_lzw((0, 7)), "decoded"),
        "estimate-unknown-type-entry": (_estimated_lzw((14, 5)), "none"),
        "strip-0-count-differs": (_first_counts(strips, 0, 1000), "none"),
        "strip-1-count-differs": (_first_counts(strips, 1, 1000), "none"),
        # tags libtiff ignores with a warning
        "fill-order-3": (_rgb_file({266: (3, [3])}), "decoded"),
        "orientation-9": (_rgb_file({274: (3, [9])}), "decoded"),
        "photometric-long": (_rgb_file({262: (4, [2])}), "decoded"),
        "predictor-5-uncompressed": (_rgb_file({317: (3, [5])}), "decoded"),
        "bits-per-sample-4-values": (_rgb_file({258: (3, [8, 8, 8, 9])}),
                                     "decoded"),
        # tags TIFFReadDirectory needs: refused
        "photometric-two-values": (_rgb_file({262: (3, [2, 2])}), "none"),
        "photometric-missing": (_rgb_file(drop=(262,)), "none"),
        "bits-per-sample-differ": (_rgb_file({258: (3, [8, 8, 9])}), "none"),
        "bits-per-sample-2-values": (_rgb_file({258: (3, [8, 8])}), "none"),
        "samples-per-pixel-0": (_rgb_file({277: (3, [0])}), "none"),
        "planar-3": (_rgb_file({284: (3, [3])}), "none"),
        "planar-rational": (_rgb_file({284: (5, [(1, 1)])}), "none"),
        "extra-samples-3": (_rgb_file({338: (3, [3])}), "none"),
        "extra-samples-leave-1-colour": (_rgb_file({338: (3, [0, 0])}),
                                         "none"),
        "rows-per-strip-float": (_retyped(raw, 278, 11), "none"),
        "rows-per-strip-sshort": (_retyped(raw, 278, 8), "decoded"),
        "photometric-float": (_retyped(raw, 262, 11), "none"),
        # compression schemes
        "compression-12345": (_rgb_file({259: (3, [12345])}), "decoded"),
        "compression-0": (_rgb_file({259: (3, [0])}), "decoded"),
        "compression-34712": (_rgb_file({259: (3, [34712])}), "decoded"),
        "compression-zstd": (_rgb_file({259: (3, [50000])}), "none"),
        "compression-ojpeg": (_rgb_file({259: (3, [6])}), "none"),
        # cv2's strip buffer: RowsPerStrip x width x 4 bytes under 1 GiB
        "rows-per-strip-under-1gib": (_tiff_set(raw, 278, 8947848),
                                      "decoded"),
        "rows-per-strip-past-1gib": (_tiff_set(raw, 278, 8947849), "none"),
        "rows-per-strip-2^32-1": (_tiff_set(raw, 278, 0xFFFFFFFF),
                                  "decoded"),
    }


@pytest.mark.parametrize("case", list(_directory_cases()))
def test_directory_repairs_answer_as_cv2(case):
    """What libtiff 4.7.1's TIFFReadDirectory repairs (the byte count
    estimates), ignores (a tag its reader refuses, where the directory can
    do without it) or refuses, and cv2's checks after it."""
    blob, verdict = _directory_cases()[case]
    assert answers_as_cv2(blob) == verdict


# ------------------------------------------------ the header mutants
def sweep_seeds():
    """The eight scanned layouts of the header sweep: T.4 2D and Group 4
    in strips of 7 rows, JPEG-in-TIFF (YCbCr 2 x 2), uncompressed YCbCr,
    CIELab and CMYK in LZW, a BigTIFF and RGB Deflate in strips of 16."""
    rgb = _small_rgb()[:40, :60].copy()
    im = Image.fromarray(rgb)
    bits = Image.fromarray(seeded_bits(8, 30, 70))
    return {
        "g3-2d": pil_tiff(bits, compression="group3",
                          tiffinfo={292: 1, 278: 7}),
        "g4": pil_tiff(bits, compression="group4", tiffinfo={278: 7}),
        "jpeg": pil_tiff(im, compression="jpeg"),
        "ycbcr": pil_tiff(im.convert("YCbCr")),
        "lab-lzw": pil_tiff(im.convert("LAB"), compression="tiff_lzw"),
        "cmyk-lzw": pil_tiff(im.convert("CMYK"), compression="tiff_lzw"),
        "bigtiff": pil_tiff(im, big_tiff=True),
        "rgb-deflate": pil_tiff(im, compression="tiff_deflate",
                                tiffinfo={278: 16}),
    }


@pytest.mark.parametrize("base,count", [(1000, 150), (5000, 1000)])
def test_header_mutants_agree_with_cv2(base, count):
    """Seeded header mutants of each sweep layout (150 each from seeds
    1000-1007, 1,200 in all; 1,000 each from seeds 5000-5007), the bytes
    mostly in the first 2 KiB: each decodes to cv2's pixels or gives None
    with it, or raises where cv2 raises. Of the first 1,200, 126 differed
    before libtiff's directory reading, codec recovery and JPEGTables
    source were followed; the last four were JPEGTables whose final
    segment runs past the tag (mutants 15, 27, 46 and 136 of "jpeg"). The
    second set reaches old-style LZW codes and entries of type 0 in a
    byte count estimate."""
    differ = []
    for k, (name, blob) in enumerate(sweep_seeds().items()):
        rng = np.random.default_rng(base + k)
        for i in range(count):
            mutant = _mutant(blob, rng)
            try:
                want = cv2.imdecode(np.frombuffer(mutant, np.uint8),
                                    cv2.IMREAD_COLOR)
            except cv2.error:
                want = "raises"
            try:
                got = imcodec.imdecode(mutant)
            except ValueError:
                got = "raises"
            if want is None:
                same = got is None
            elif isinstance(want, str):
                same = isinstance(got, str)
            else:
                same = isinstance(got, np.ndarray) and \
                    got.shape == want.shape and (got == want).all()
            if not same:
                differ.append((name, i))
    assert not differ, differ


# ------------------------------------------------------------ samples
RECOVERY_SAMPLES = ("sample_page_jpeg_planar.tif", "sample_lossless_scans.jpg",
                    "sample_ticket_damaged.tif")


def write_samples(out=SAMPLES):
    """The committed samples of this file's layouts (how they were made):
    the corpus page big_doc (1280 x 960) as planar YCbCr JPEG-in-TIFF at
    1 x 1 (three grey JPEG planes at quality 75); card.jpg (270 x 360) as
    a three-component lossless JPEG in a scan a component (predictors 1,
    4, 7, restarts every 16 rows); the damaged ticket (ticket_damaged)."""
    page = cv2.imread(str(PAGE / "big_doc.jpg"))
    card = cv2.imread(str(PAGE / "card.jpg"))
    blobs = {
        "sample_page_jpeg_planar.tif": planar_jpeg(page[:, :, ::-1].copy()),
        "sample_lossless_scans.jpg": lossless_jpeg(
            [card[:, :, 2 - i].astype(np.int64) for i in range(3)],
            predictor=[1, 4, 7], restart_rows=16, scans=[[0], [1], [2]]),
        "sample_ticket_damaged.tif": ticket_damaged(),
    }
    for name, blob in blobs.items():
        (out / name).write_bytes(blob)
    return blobs


def deflate_pages(out):
    """The Deflate pages whose decode PERF.md times with
    onnxocr_tpu_torch/tools/time_imdecode.py, written into `out`: big_doc
    (1280 x 960) as PIL's RGB Deflate TIFF, the same with predictor 2,
    and the first with its middle strip's second half noise (seed 21) →
    their paths."""
    page = Image.fromarray(cv2.imread(str(PAGE / "big_doc.jpg"))[:, :, ::-1])
    plain = pil_tiff(page, compression="tiff_deflate")
    middle = len(ifd_tags(plain)[273]) // 2
    blobs = {"deflate_page.tif": plain,
             "deflate_page_pred2.tif": pil_tiff(
                 page, compression="tiff_deflate", tiffinfo={317: 2}),
             "deflate_page_damaged.tif": _strip_replaced(
                 plain, middle, _noise(21, 1 / 2))}
    out.mkdir(parents=True, exist_ok=True)
    for name, blob in blobs.items():
        (out / name).write_bytes(blob)
    return [out / name for name in blobs]


@pytest.mark.parametrize("name", RECOVERY_SAMPLES)
def test_recovery_samples_match_cv2_and_their_record(name):
    """Each committed sample is what write_samples makes, under 300 KB,
    decodes to cv2's decode here and to the shape and sha256 recorded in
    codec_samples.json, which the chip smoke's phase TF checks on a
    machine without cv2."""
    recorded = json.loads((SAMPLES / "codec_samples.json").read_text())
    blob = (SAMPLES / name).read_bytes()
    assert len(blob) < 300_000 and recorded[name]["bytes"] == len(blob)
    assert answers_as_cv2(blob) == "decoded"
    got = imcodec.imdecode(blob)
    assert list(got.shape) == recorded[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == \
        recorded[name]["sha256"]

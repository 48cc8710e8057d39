"""The port's image codec (onnxocr_tpu_torch/utils/imcodec.py, C++ in
csrc/host/imcodec.cc built with g++) and its polyline twin against cv2 and
PIL on the CPU.

Every decode is held to `cv2.imdecode(buf, cv2.IMREAD_COLOR)` and is equal
value for value: PNG of every colour type, bit depth and filter type,
plain and Adam7-interlaced, with its eXIf orientation; JPEG baseline at
4:4:4, 4:2:2, 4:2:0, 4:1:1, 4:4:0 and grey, with restart intervals,
progressive, odd sizes and EXIF orientations 1–8; BMP at 24 and 32 bits,
bottom-up and top-down, at 1, 4 and 8 bits with palettes (PIL's, cv2's and
hand-built ones, the OS/2 core header too), RLE8 and RLE4 built by hand
(runs, absolute blocks, end of line, delta, end of bitmap and cv2's quirks
around them), 16 bits (5-5-5, 5-6-5 bit fields) and 32 bits with bit-field
masks (cv2 applies them from a 56-byte header on, scaling in float32), and
seeded BMPs of every kind, truncated and corrupted too. Bytes cv2 gives
None for (garbage, every truncation) give None. Formats the codec does not
read (WebP, TIFF) give None where cv2 decodes them. Hostile uploads of a
few hundred
bytes (over-subscribed or refused Huffman tables, sides and pixel counts
past libpng's, libjpeg's and cv2's limits) answer as cv2 does (None, or
ValueError where cv2 raises), a PNG zip bomb inflates only its image, and
seeded mutants of committed and generated images decode without a fault
in a build with AddressSanitizer. `imencode_jpeg` writes cv2's bytes
at quality 85 and 95 (so its decoded values equal those of cv2's encoding:
0 differ). `cv_ops.polylines2` equals `cv2.polylines(img, [pts], True,
(255, 0, 0), 2)` on seeded quads, clipped ones included, and `draw_ocr`
the JAX package's.
"""
import io
import os
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from onnxocr_tpu.utils.draw import draw_ocr as jdraw_ocr

from onnxocr_tpu_torch.ops import native
from onnxocr_tpu_torch.utils import cv_ops, imcodec
from onnxocr_tpu_torch.utils.draw import draw_ocr


def smooth_image(seed, h, w):
    """A seeded BGR image with photo-like structure (blurred noise)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 0)


def assert_decodes_as_cv2(blob):
    want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    got = imcodec.imdecode(blob)
    assert want is not None and got is not None
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_codec_library_builds_from_the_repo():
    path = native.build(imcodec.SOURCE, "libocrimcodec")
    assert path.parent == native.BUILD_DIR and path.name.startswith(
        "libocrimcodec-") and path.exists()
    assert imcodec.lib() is imcodec.lib()


# ------------------------------------------------------------------ PNG
def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows, bpp, first_filter):
    """Filter each row of `rows` (h, stride) uint8, cycling the five filter
    types from `first_filter`."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        ftype = (first_filter + y) % 5
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = [np.zeros_like(row), left, prev, (left + prev) >> 1,
                _paeth(left, prev, ul)][ftype]
        out.append(bytes([ftype]) + ((row - pred) & 255).astype(
            np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _pack(samples, depth):
    """(h, w, c) sample values → (h, stride) packed bytes."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return samples.reshape(h, -1).astype(np.uint8)
    per = 8 // depth
    flat = samples.reshape(h, w)
    pad = (-w) % per
    flat = np.pad(flat, ((0, 0), (0, pad)))
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return (flat.reshape(h, -1, per).astype(np.uint8) << shifts).sum(
        axis=2).astype(np.uint8)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def write_png(samples, depth, ctype, interlace=False, palette=None,
              first_filter=0, extra=b""):
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)
    if interlace:
        raw = b""
        for i, (x0, y0, dx, dy) in enumerate(ADAM7):
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filter_rows(_pack(sub, depth), bpp, first_filter + i)
    else:
        raw = _filter_rows(_pack(samples, depth), bpp, first_filter)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + extra + _chunk(b"IDAT", zlib.compress(raw, 6)) + \
        _chunk(b"IEND", b"")


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", PNG_KINDS,
                         ids=[f"type{c}-{d}bit" for c, d in PNG_KINDS])
def test_png_matches_cv2(ctype, depth, interlace):
    """Every colour type and depth, all five filter types in each image,
    plain and interlaced, at an odd size (Adam7 passes of one pixel)."""
    rng = np.random.default_rng(ctype * 100 + depth)
    for h, w in ((13, 17), (1, 1), (3, 9)):
        top = 1 << depth
        samples = rng.integers(0, top, (h, w, CHANNELS[ctype]))
        palette = None
        if ctype == 3:
            # a palette shorter than the index range: unset entries
            palette = rng.integers(0, 256, (max(1, top - 1), 3))
        for first in range(0, 5, 2):
            assert_decodes_as_cv2(write_png(samples, depth, ctype, interlace,
                                            palette, first))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation_matches_cv2(orientation):
    img = Image.fromarray(smooth_image(orientation, 21, 34)[:, :, ::-1])
    exif = img.getexif()
    exif[0x0112] = orientation
    buf = io.BytesIO()
    img.save(buf, "PNG", exif=exif.tobytes())
    assert_decodes_as_cv2(buf.getvalue())


def test_png_from_encoders_match_cv2():
    """cv2's own and PIL's encodings (RGBA with varying alpha, palette,
    grey, grey + alpha, 16-bit grey, 1-bit)."""
    img = smooth_image(0, 45, 61)
    ok, buf = cv2.imencode(".png", img)
    assert_decodes_as_cv2(bytes(buf))
    rng = np.random.default_rng(1)
    rgba = np.dstack([img[:, :, ::-1], rng.integers(0, 256, img.shape[:2])
                      ]).astype(np.uint8)
    for im in (Image.fromarray(rgba), Image.fromarray(rgba).convert("P"),
               Image.fromarray(rgba).convert("L"),
               Image.fromarray(rgba).convert("LA"),
               Image.fromarray(rgba).convert("1"),
               Image.fromarray((img[:, :, 0].astype(np.uint16) * 257))):
        out = io.BytesIO()
        im.save(out, "PNG")
        assert_decodes_as_cv2(out.getvalue())


# ----------------------------------------------------------------- JPEG
SIZES = ((64, 64), (61, 77), (17, 3), (1, 1), (9, 2), (100, 131))


@pytest.mark.parametrize("h,w", SIZES)
def test_jpeg_baseline_matches_cv2(h, w):
    """4:4:4 / 4:2:2 / 4:2:0 and grey from PIL, 4:1:1 / 4:4:0 and restart
    intervals from cv2: the islow IDCT, the fancy upsampling and the
    YCbCr tables give libjpeg-turbo's values exactly."""
    img = smooth_image(h * w, h, w)
    for sub in (0, 1, 2):
        out = io.BytesIO()
        Image.fromarray(img[:, :, ::-1]).save(out, "JPEG", quality=90,
                                              subsampling=sub)
        assert_decodes_as_cv2(out.getvalue())
    out = io.BytesIO()
    Image.fromarray(img[:, :, 0]).save(out, "JPEG", quality=90)
    assert_decodes_as_cv2(out.getvalue())
    for factor in (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440):
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                             factor])
        assert_decodes_as_cv2(bytes(buf))
    for interval in (1, 2, 5):
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL,
                                             interval])
        assert_decodes_as_cv2(bytes(buf))


@pytest.mark.parametrize("h,w", SIZES)
def test_jpeg_progressive_matches_cv2(h, w):
    img = smooth_image(h + w, h, w)
    out = io.BytesIO()
    Image.fromarray(img[:, :, ::-1]).save(out, "JPEG", quality=85,
                                          progressive=True)
    assert_decodes_as_cv2(out.getvalue())
    for factor in (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444):
        ok, buf = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
            cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
        assert_decodes_as_cv2(bytes(buf))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation_matches_cv2(orientation):
    """IMREAD_COLOR applies the EXIF orientation: phone photos come out
    upright."""
    img = Image.fromarray(smooth_image(orientation, 23, 37)[:, :, ::-1])
    exif = img.getexif()
    exif[0x0112] = orientation
    out = io.BytesIO()
    img.save(out, "JPEG", quality=90, exif=exif.tobytes())
    assert_decodes_as_cv2(out.getvalue())
    got = imcodec.imdecode(out.getvalue())
    assert got.shape[:2] == ((23, 37) if orientation < 5 else (37, 23))


# ------------------------------------------------------------------ BMP
def test_bmp_matches_cv2():
    img = smooth_image(3, 29, 31)
    bgra = np.dstack([img, np.full(img.shape[:2], 7, np.uint8)])
    blobs = [bytes(cv2.imencode(".bmp", img)[1]),
             bytes(cv2.imencode(".bmp", bgra)[1])]
    for arr in (img[:, :, ::-1], bgra[:, :, [2, 1, 0, 3]]):
        out = io.BytesIO()
        Image.fromarray(arr).save(out, "BMP")
        blobs.append(out.getvalue())
    # top-down: a negative height and the rows in reading order
    bottom_up = bytearray(blobs[0])
    offset, = struct.unpack("<I", bottom_up[10:14])
    h, = struct.unpack("<i", bottom_up[22:26])
    stride = (31 * 3 + 3) & ~3
    rows = bytes(bottom_up[offset:offset + stride * h])
    flipped = b"".join(rows[i * stride:(i + 1) * stride]
                       for i in reversed(range(h)))
    top_down = bottom_up[:22] + struct.pack("<i", -h) + bottom_up[26:offset] \
        + flipped + bottom_up[offset + stride * h:]
    blobs.append(bytes(top_down))
    for blob in blobs:
        assert_decodes_as_cv2(blob)


def bmp_file(w, h, bits, comp=0, pixels=b"", palette=b"", dib=40,
             clrused=0, masks=None, tail=b""):
    """A BMP: the header of `dib` bytes (12: the OS/2 core header; 56 and
    more carry R, G, B, A masks), `tail` (16-bit bit fields read after the
    header), the palette, then the pixels."""
    if dib == 12:
        hdr = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        hdr = struct.pack("<IiiHHIIiiII", dib, w, h, 1, bits, comp,
                          len(pixels), 2835, 2835, clrused, 0)
        hdr += struct.pack("<IIII", *(tuple(masks or (0, 0, 0)) + (0,))[:4])
        hdr = (hdr + bytes(max(0, dib - len(hdr))))[:dib]
    body = hdr + tail + palette
    return b"BM" + struct.pack("<IHHI", 14 + len(body) + len(pixels), 0, 0,
                               14 + len(body)) + body + pixels


def _palette(n, seed, entry=4):
    return bytes(np.random.default_rng(seed).integers(
        0, 256, n * entry).astype(np.uint8))


def test_bmp_palettes_match_cv2():
    """1-, 4- and 8-bit palettes from PIL (modes 1, L, P) and cv2 (grey),
    and built by hand: fewer entries than the depth holds (indices past
    them are black, as cv2's zeroed palette gives), top-down, a 4-bit
    palette and the OS/2 core header at 1, 4, 8 and 24 bits."""
    img = smooth_image(12, 23, 29)
    blobs = [bytes(cv2.imencode(".bmp", img[:, :, 1])[1])]
    for mode in ("1", "L", "P"):
        out = io.BytesIO()
        Image.fromarray(img[:, :, ::-1]).convert(mode).save(out, "BMP")
        blobs.append(out.getvalue())
    rng = np.random.default_rng(3)
    for bits, clrused, h in ((8, 5, 7), (8, 0, -7), (4, 0, 7), (4, 3, -7),
                             (1, 0, 7), (1, 1, 7)):
        stride = ((13 * bits + 7) // 8 + 3) & ~3
        pixels = bytes(rng.integers(0, 256, stride * 7).astype(np.uint8))
        blobs.append(bmp_file(13, h, bits, pixels=pixels,
                              palette=_palette(clrused or 1 << bits, bits),
                              clrused=clrused))
    for bits in (1, 4, 8, 24):
        stride = ((11 * bits + 7) // 8 + 3) & ~3
        pixels = bytes(rng.integers(0, 256, stride * 5).astype(np.uint8))
        blobs.append(bmp_file(11, 5, bits, pixels=pixels, dib=12,
                              palette=_palette(1 << bits, bits, 3)
                              if bits <= 8 else b""))
    for blob in blobs:
        assert_decodes_as_cv2(blob)


def test_bmp_16_and_32_bit_masks_match_cv2():
    """16 bits: BI_RGB (5-5-5) and the 5-5-5 and 5-6-5 bit fields after a
    40- and a 108-byte header; 32 bits with masks: ignored in a 40-byte
    header, applied from a 56-byte one on (another channel order, 10-bit
    fields, a 3-bit field whose top value cv2's float32 scale makes 254)."""
    rng = np.random.default_rng(4)
    px16 = bytes(rng.integers(0, 256, 20 * 4).astype(np.uint8))
    blobs = [bmp_file(9, 4, 16, pixels=px16)]
    for rgb in ((0x7C00, 0x3E0, 0x1F), (0xF800, 0x7E0, 0x1F)):
        for dib in (40, 108):
            blobs.append(bmp_file(9, -4, 16, 3, px16, dib=dib, masks=rgb,
                                  tail=struct.pack("<III", *rgb)))
    px32 = bytes(rng.integers(0, 256, 4 * 7 * 3).astype(np.uint8)) +         struct.pack("<I", 0xFFFFFFFF)
    for dib, rgb in ((40, (0xFF, 0xFF00, 0xFF0000)),
                     (56, (0xFF, 0xFF00, 0xFF0000)),
                     (108, (0xFF000000, 0xFF0000, 0xFF00)),
                     (124, (0x3FF00000, 0xFFC00, 0x3FF)),
                     (108, (0x1C000000, 0xFF00, 0x7))):
        blobs.append(bmp_file(11, 2, 32, 3, px32, dib=dib, masks=rgb,
                              tail=b"" if dib > 40 else
                              struct.pack("<III", *rgb)))
    for blob in blobs:
        assert_decodes_as_cv2(blob)
    # 7 of a 3-bit field: 254, not 255
    assert imcodec.imdecode(blobs[-1])[0, -1, 2] == 254


def _rle8_cases():
    """Hand-built RLE8 streams, 6 px wide, 3 rows: runs, an absolute block
    (odd, padded), end of line, delta, end of bitmap; a run that ends its
    row followed by an end of line (no second line break in cv2); an end
    of bitmap early (the rest filled with entry 0)."""
    return {
        "runs-eol": bytes([3, 1, 3, 2, 0, 0, 0, 5, 7, 8, 9, 10, 11, 0,
                           1, 4, 0, 0, 6, 3, 0, 1]),
        "full-row-then-eol": bytes([6, 5, 0, 0, 2, 6, 0, 0, 6, 7, 0, 1]),
        "delta": bytes([2, 9, 0, 2, 3, 1, 1, 4, 0, 0, 6, 2, 0, 1]),
        "early-eof": bytes([4, 3, 0, 1]),
        "absolute-fills-row": bytes([0, 6, 1, 2, 3, 4, 5, 6, 0, 0, 6, 1,
                                     6, 2]),
    }


def _rle4_cases():
    """Hand-built RLE4 streams, 7 px wide, 2 rows: alternating runs, an
    absolute block, end of line, a delta (cv2 skips dx pixels only), an
    end of bitmap ending the last row."""
    return {
        "runs-abs-eol": bytes([5, 0x12, 0, 0, 0, 5, 0x34, 0x56, 0x70, 0,
                               2, 0x89, 0, 0, 0, 1]),
        "delta": bytes([2, 0x1F, 0, 2, 3, 5, 2, 0xAB, 0, 0, 7, 0xCD, 0, 1]),
        "eof-ends-last-row": bytes([7, 0x21, 0, 0, 3, 0x43, 0, 1]),
    }


@pytest.mark.parametrize("case", list(_rle8_cases()) + [
    f"rle4-{c}" for c in _rle4_cases()])
def test_bmp_rle_matches_cv2(case):
    if case.startswith("rle4-"):
        stream, w, h, bits, comp = _rle4_cases()[case[5:]], 7, 2, 4, 2
    else:
        stream, w, h, bits, comp = _rle8_cases()[case], 6, 3, 8, 1
    assert_decodes_as_cv2(bmp_file(w, h, bits, comp, stream,
                                   _palette(1 << bits, 7)))


BMP_REFUSED = {
    # cv2 gives None for each, and so does the codec
    "palette-past-the-file": lambda: bmp_file(4, 1, 8, pixels=b"\0" * 4,
                                              palette=_palette(2, 0),
                                              clrused=0),
    "palette-count-300": lambda: bmp_file(4, 1, 8, pixels=b"\0" * 4,
                                          palette=_palette(300, 0),
                                          clrused=300),
    "rle8-run-past-the-row": lambda: bmp_file(
        6, 2, 8, 1, bytes([7, 1, 0, 1]), _palette(256, 0)),
    "rle8-block-past-the-row": lambda: bmp_file(
        6, 2, 8, 1, bytes([3, 1, 0, 4, 1, 2, 3, 4, 0, 1]), _palette(256, 0)),
    "rle8-block-after-a-full-row": lambda: bmp_file(
        6, 2, 8, 1, bytes([0, 6, 1, 2, 3, 4, 5, 6, 2, 1, 0, 1]),
        _palette(256, 0)),
    "rle8-codes-run-out": lambda: bmp_file(
        6, 2, 8, 1, bytes([6, 1, 0, 0, 3, 2]), _palette(256, 0)),
    "rle8-delta-past-the-data": lambda: bmp_file(
        6, 2, 8, 1, bytes([2, 1, 0, 2, 1]), _palette(256, 0)),
    "rle4-run-past-the-row": lambda: bmp_file(
        7, 1, 4, 2, bytes([8, 0x12, 0, 1]), _palette(16, 0)),
    "rle4-eof-before-the-last-row": lambda: bmp_file(
        7, 2, 4, 2, bytes([3, 0x12, 0, 1]), _palette(16, 0)),
    "16-bit-other-masks": lambda: bmp_file(
        2, 1, 16, 3, b"\0" * 4, tail=struct.pack("<III", 0xF00, 0xF0, 0xF)),
    "bits-per-pixel-2": lambda: bmp_file(4, 1, 2, pixels=b"\0" * 4,
                                         palette=_palette(4, 0)),
}


@pytest.mark.parametrize("case", list(BMP_REFUSED))
def test_bmp_refused_as_cv2(case):
    blob = BMP_REFUSED[case]()
    assert cv2.imdecode(np.frombuffer(blob, np.uint8),
                        cv2.IMREAD_COLOR) is None
    assert imcodec.imdecode(blob) is None


def test_bmp_palette_past_the_size_limit_raises_as_cv2():
    blob = bmp_file((1 << 20) + 1, 1, 8, palette=_palette(256, 0))
    with pytest.raises(cv2.error, match="validateInputImageSize"):
        cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    with pytest.raises(ValueError, match="validateInputImageSize"):
        imcodec.imdecode(blob)


def _seeded_bmp(rng):
    """A seeded BMP of one of the kinds cv2 reads (or a near miss): its
    depth, compression, header size, palette count, masks and pixels
    drawn at random; truncated or with one byte changed now and then."""
    w, h = int(rng.integers(1, 12)), int(rng.integers(1, 6))
    h = h if rng.random() < 0.8 else -h
    dib = int(rng.choice([40, 40, 56, 108, 124, 36, 52]))
    kind = int(rng.integers(0, 7))
    if kind <= 1:                                       # palettes, core
        bits = int(rng.choice([1, 4, 8]))
        clr = int(rng.choice([0, 0, 3, 16, 256]))
        pal = _palette(clr or 1 << bits, int(rng.integers(0, 99)),
                       3 if kind else 4)
        stride = ((w * bits + 7) // 8 + 3) & ~3
        px = bytes(rng.integers(0, 256, stride * abs(h)).astype(np.uint8))
        blob = bmp_file(w, abs(h), bits, pixels=px, palette=pal, dib=12)             if kind else bmp_file(w, h, bits, pixels=px, palette=pal,
                                  clrused=clr, dib=dib)
    elif kind <= 3:                                     # RLE8, RLE4
        rle4 = kind == 3
        codes = bytearray()
        for _ in range(int(rng.integers(1, 30))):
            r = rng.random()
            if r < 0.4:
                codes += bytes([int(rng.integers(1, w + 2)),
                                int(rng.integers(0, 256))])
            elif r < 0.6:
                n = int(rng.integers(3, max(w + 2, 4)))
                size = (((n + 1) >> 1) + 1) & ~1 if rle4 else (n + 1) & ~1
                codes += bytes([0, n]) + bytes(
                    rng.integers(0, 256, size).astype(np.uint8))
            elif r < 0.8:
                codes += bytes([0, 0])
            elif r < 0.9:
                codes += bytes([0, 2, int(rng.integers(0, w + 2)),
                                int(rng.integers(0, 3))])
            else:
                codes += bytes([0, 1])
        if rng.random() < 0.7:
            codes += bytes([0, 1])
        bits = 4 if rle4 else 8
        blob = bmp_file(w, h, bits, 2 if rle4 else 1, bytes(codes),
                        _palette(1 << bits, 5), dib=dib)
    elif kind == 4:                                     # 16-bit
        px = bytes(rng.integers(0, 256, ((w * 2 + 3) & ~3) * abs(h))
                   .astype(np.uint8))
        rgb = [(0x7C00, 0x3E0, 0x1F), (0xF800, 0x7E0, 0x1F),
               (0xF00, 0xF0, 0xF)][int(rng.integers(0, 3))]
        comp = int(rng.integers(0, 2)) * 3
        blob = bmp_file(w, h, 16, comp, px, dib=dib, masks=rgb,
                        tail=struct.pack("<III", *rgb) if comp else b"")
    else:                                               # 24, 32 (masks)
        bits = 24 if kind == 5 else 32
        px = bytes(rng.integers(0, 256, ((w * bits // 8 + 3) & ~3) * abs(h))
                   .astype(np.uint8))
        rgb = []
        for _ in range(3):
            nb = int(rng.integers(1, 33))
            rgb.append(((1 << nb) - 1) << int(rng.integers(0, 33 - nb)))
        blob = bmp_file(w, h, bits, 3 if bits == 32 else 0, px, dib=dib,
                        masks=rgb)
    if rng.random() < 0.15:
        blob = blob[:int(rng.integers(14, len(blob)))]
    if rng.random() < 0.1:
        b = bytearray(blob)
        b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        blob = bytes(b)
    return blob


def test_seeded_bmps_answer_as_cv2():
    """600 seeded BMPs (_seeded_bmp): each decodes to cv2's values, or
    gives None where cv2 does, or raises where cv2 raises."""
    rng = np.random.default_rng(14)
    decoded = 0
    for _ in range(600):
        blob = _seeded_bmp(rng)
        try:
            want = cv2.imdecode(np.frombuffer(blob, np.uint8),
                                cv2.IMREAD_COLOR)
        except cv2.error:
            with pytest.raises(ValueError):
                imcodec.imdecode(blob)
            continue
        got = imcodec.imdecode(blob)
        if want is None:
            assert got is None
            continue
        decoded += 1
        assert got is not None and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert decoded > 300


# --------------------------------------------------------- unreadable
def test_garbage_and_truncations_give_none():
    """Wherever cv2 gives None: garbage, a bare signature, and every
    truncation of a PNG, a JPEG (baseline and progressive) and a BMP; on
    no bytes at all both raise."""
    rng = np.random.default_rng(5)
    img = smooth_image(5, 33, 41)
    prog = io.BytesIO()
    Image.fromarray(img).save(prog, "JPEG", progressive=True)
    blobs = [bytes(cv2.imencode(ext, img)[1]) for ext in
             (".png", ".jpg", ".bmp")] + [prog.getvalue()]
    with pytest.raises(cv2.error, match="buf.empty"):
        cv2.imdecode(np.frombuffer(b"", np.uint8), cv2.IMREAD_COLOR)
    with pytest.raises(ValueError, match="buf.empty"):
        imcodec.imdecode(b"")
    cases = [rng.bytes(300), b"\xff\xd8\xff" + rng.bytes(200),
             b"\x89PNG\r\n\x1a\n" + rng.bytes(60), b"BM" + rng.bytes(80)]
    for blob in blobs:
        cases += [blob[:n] for n in (len(blob) // 4, len(blob) // 2,
                                     len(blob) - 10, len(blob) - 2,
                                     len(blob) - 1, 20, 5)]
    for blob in cases:
        want = cv2.imdecode(np.frombuffer(blob, np.uint8),
                            cv2.IMREAD_COLOR)
        assert want is None
        assert imcodec.imdecode(blob) is None


def test_formats_not_read_give_none():
    """WebP and TIFF: cv2 decodes them, the codec does not (ROADMAP lists
    them as not ported) and says None. A palette BMP, once among them, is
    read now, value-equal to cv2."""
    img = smooth_image(6, 20, 24)
    for ext in (".webp", ".tiff"):
        ok, buf = cv2.imencode(ext, img)
        assert ok and cv2.imdecode(buf, cv2.IMREAD_COLOR) is not None
        assert imcodec.imdecode(bytes(buf)) is None
    out = io.BytesIO()
    Image.fromarray(img[:, :, 0]).convert("P").save(out, "BMP")
    assert_decodes_as_cv2(out.getvalue())


# ------------------------------------------------ hostile uploads
def _segments(jpeg, marker):
    """Offsets of the marker segments of one kind before the first scan."""
    end, out, pos = jpeg.index(b"\xff\xda"), [], 0
    while (pos := jpeg.find(b"\xff" + bytes([marker]), pos)) >= 0 and \
            pos < end:
        out.append(pos)
        pos += 2
    return out


def _dht(tc_th, bits, vals):
    return b"\xff\xc4" + struct.pack(">HB", 3 + 16 + len(vals), tc_th) + \
        bytes(bits) + bytes(vals)


def _before_scan(jpeg, segment):
    i = jpeg.index(b"\xff\xda")
    return jpeg[:i] + segment + jpeg[i:]


def _sof_size(jpeg, h, w):
    i = _segments(jpeg, 0xC0)[0]
    return jpeg[:i + 5] + struct.pack(">HH", h, w) + jpeg[i + 9:]


def _no_dht(jpeg):
    out, pos = b"", 0
    for i in _segments(jpeg, 0xC4):
        out += jpeg[pos:i]
        pos = i + 2 + struct.unpack(">H", jpeg[i + 2:i + 4])[0]
    return out + jpeg[pos:]


def _png_header_only(w, h, depth, ctype):
    """A PNG whose image data is one filter byte."""
    return b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, 0)) + _chunk(
        b"IDAT", zlib.compress(b"\0")) + _chunk(b"IEND", b"")


def _bmp(w, h, pixels=True):
    """A 24-bit BMP of w x h black pixels, or its headers alone."""
    size = ((w * 3 + 3) & ~3) * abs(h) if pixels else 0
    return b"BM" + struct.pack("<IHHI", 54 + size, 0, 0, 54) + \
        struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, 0, 0, 0, 0, 0) + \
        bytes(size)


def _hostile(case):
    jpeg = bytes(cv2.imencode(".jpg", smooth_image(9, 40, 48))[1])
    return {
        # codes of length 1 for 255 values: the fast lookup table would be
        # written 64 KB past its end if the table were entered before it
        # is checked
        "dht-oversubscribed": lambda: _before_scan(
            jpeg, _dht(0x00, [255] + [0] * 15, [0] * 255)),
        "dht-all-ones-code": lambda: _before_scan(
            jpeg, _dht(0x10, [2] + [0] * 15, [0, 1])),
        "dht-dc-category-16": lambda: _before_scan(
            jpeg, _dht(0x00, [0, 1] + [0] * 14, [16])),
        # a refused table no scan uses, and no tables at all (libjpeg-turbo
        # decodes both: it builds tables when a scan uses them, and falls
        # back on the standard ones)
        "dht-refused-unused": lambda: _before_scan(
            jpeg, _dht(0x13, [2] + [0] * 15, [0, 1])),
        "dht-none": lambda: _no_dht(jpeg),
        "jpeg-side-65500": lambda: _sof_size(jpeg, 40, 65500),
        "jpeg-side-65501": lambda: _sof_size(jpeg, 40, 65501),
        "jpeg-65500x65500": lambda: _sof_size(jpeg, 65500, 65500),
        "png-2^29-wide-rgba16": lambda: _png_header_only(1 << 29, 1, 16, 6),
        "png-2^31-1-wide": lambda: _png_header_only((1 << 31) - 1, 1, 8, 0),
        "png-1000001-wide": lambda: write_png(
            np.zeros((1, 1_000_001, 1), np.uint8), 8, 0),
        "png-40000x40000": lambda: _png_header_only(40000, 40000, 8, 2),
        "bmp-2^20+1-wide": lambda: _bmp((1 << 20) + 1, 1),
        "bmp-2^31-1-wide": lambda: _bmp((1 << 31) - 1, 1, pixels=False),
    }[case]()


HOSTILE = {"dht-oversubscribed": "none", "dht-all-ones-code": "none",
           "dht-dc-category-16": "none", "dht-refused-unused": "equal",
           "dht-none": "equal", "jpeg-side-65500": "equal",
           "jpeg-side-65501": "none", "jpeg-65500x65500": "raises",
           "png-2^29-wide-rgba16": "none", "png-2^31-1-wide": "none",
           "png-1000001-wide": "none", "png-40000x40000": "raises",
           "bmp-2^20+1-wide": "raises", "bmp-2^31-1-wide": "raises"}


@pytest.mark.parametrize("case", list(HOSTILE))
def test_hostile_headers_answer_as_cv2(case):
    """Crafted tables and sizes of a few hundred bytes: None where cv2
    gives None (libjpeg's table checks, libpng's and libjpeg's longest
    sides, truncated data), ValueError where cv2 raises (its
    validateInputImageSize: 2^20 px a side, 2^30 px in all), both before
    anything is allocated; the image where cv2 decodes it."""
    blob = _hostile(case)
    expect = HOSTILE[case]
    if expect == "raises":
        with pytest.raises(cv2.error, match="validateInputImageSize"):
            cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
        with pytest.raises(ValueError, match="validateInputImageSize"):
            imcodec.imdecode(blob)
    elif expect == "none":
        assert cv2.imdecode(np.frombuffer(blob, np.uint8),
                            cv2.IMREAD_COLOR) is None
        assert imcodec.imdecode(blob) is None
    else:
        assert_decodes_as_cv2(blob)


def test_png_zip_bomb_inflates_only_the_image():
    """An IDAT stream of 54 KB that inflates to 51 MB behind a 1024 x 1000
    grey image: the codec inflates the image's 1 MB and stops, as libpng
    does (the rest is its benign "Too much image data"); the pixels equal
    cv2's. A stream that ends before the image does gives None."""
    import tracemalloc
    rows = np.tile(np.arange(1024, dtype=np.uint32) % 251, (1000, 1))
    raw = _filter_rows(rows.astype(np.uint8), 1, 0)
    bomb = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 1024, 1000, 8, 0, 0, 0, 0)) + _chunk(
        b"IDAT", zlib.compress(raw + bytes(50_000_000), 9)) + \
        _chunk(b"IEND", b"")
    assert len(bomb) < 64 * 1024
    imcodec.lib()
    tracemalloc.start()
    try:
        got = imcodec.imdecode(bomb)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 16 * 1024 * 1024, peak
    want = cv2.imdecode(np.frombuffer(bomb, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(got, want)
    cut = bomb[:33] + _chunk(b"IDAT", zlib.compress(raw, 9)[:-4]) + \
        _chunk(b"IEND", b"")
    assert cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR) \
        is None
    assert imcodec.imdecode(cut) is None


_DECODE_MUTANTS = """
import ctypes, pickle, sys
import numpy as np
from onnxocr_tpu_torch.utils import imcodec
loaded = ctypes.CDLL(sys.argv[1])
for name, (restype, argtypes) in imcodec._SIGNATURES.items():
    getattr(loaded, name).restype = restype
    getattr(loaded, name).argtypes = argtypes
imcodec._LIB = loaded
counts = {"decoded": 0, "none": 0, "raised": 0}
with open(sys.argv[2], "rb") as f:
    mutants = pickle.load(f)
for blob in mutants:
    try:
        img = imcodec.imdecode(blob)
    except ValueError:
        counts["raised"] += 1
        continue
    if img is None:
        counts["none"] += 1
    else:
        assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
        counts["decoded"] += 1
print(counts)
"""


def _mutant(blob, rng):
    """One seeded mutant of an encoded image. JPEG: bytes of a marker
    segment overwritten, or codes moved from a longer length to a shorter
    one in a DHT segment (its size unchanged, the table perhaps
    over-subscribed). PNG: bytes of chunk bodies (IHDR's fields mostly)
    overwritten with the CRCs rewritten, so that the mutant passes the CRC
    check. Any: bytes overwritten, inserted or cut, mostly in the first
    2 KiB where the headers and tables are."""
    b = bytearray(blob)
    kind = rng.integers(2)
    if kind and b[:2] == b"\xff\xd8":
        dht = _segments(blob, 0xC4)
        if rng.random() < 0.5:
            bits = int(rng.choice(dht)) + 5
            lo, hi = sorted(rng.choice(16, 2, replace=False))
            d = int(rng.integers(0, b[bits + hi] + 1))
            b[bits + hi] -= d
            b[bits + lo] = min(255, b[bits + lo] + d)
            return bytes(b)
        segs = [i for m in (0xC0, 0xC2, 0xC4, 0xDA, 0xDB, 0xDD)
                for i in _segments(blob, m)]
        for _ in range(rng.integers(1, 4)):
            i = int(rng.choice(segs)) + 4 + int(rng.integers(0, 18))
            b[i] = int(rng.choice([0, 1, 0x11, 0x22, 0xFF,
                                   rng.integers(256)]))
        return bytes(b)
    if kind and b[:4] == b"\x89PNG":
        pos, chunks = 8, []
        while pos + 12 <= len(b):
            n, = struct.unpack(">I", b[pos:pos + 4])
            chunks.append((b[pos + 4:pos + 8], b[pos + 8:pos + 8 + n]))
            pos += 12 + n
        for _ in range(rng.integers(1, 4)):
            body = chunks[0 if rng.random() < 0.5 else
                          rng.integers(len(chunks))][1]
            if body:
                body[int(rng.integers(min(len(body), 256)))] = int(
                    rng.choice([0, 1, 2, 3, 4, 6, 8, 16, 255,
                                rng.integers(256)]))
        return b"\x89PNG\r\n\x1a\n" + b"".join(_chunk(bytes(k), bytes(v))
                                             for k, v in chunks)
    for _ in range(rng.integers(1, 6)):
        i = int(rng.integers(min(len(b), 2048) if rng.random() < 0.8
                             else len(b)))
        r = rng.random()
        if r < 0.6:
            b[i] = int(rng.choice([0, 0xFF, rng.integers(256)]))
        elif r < 0.8:
            b[i:i] = rng.bytes(int(rng.integers(1, 8)))
        else:
            del b[i:i + int(rng.integers(1, 16))]
    return bytes(b)


def test_mutated_images_never_crash(tmp_path):
    """Seeded mutants of committed pages (two JPEGs, a PNG page) and of
    encodings of every kind the codec reads (progressive, restart
    intervals, grey, palette, 16-bit, interlaced, BMP) each decode to
    (H, W, 3) uint8, None or a ValueError: the library, built with
    AddressSanitizer where the compiler has it, reads and writes nothing
    out of bounds (a fault ends the process)."""
    import pickle
    import subprocess
    import sys
    repo = Path(__file__).resolve().parents[1]
    img = smooth_image(11, 37, 53)
    seeds = [(repo / "onnxocr_tpu" / p).read_bytes() for p in (
        "test_images/card.jpg", "test_images/small.jpg",
        "test_images_heldout/synth_00_doc.png")]
    for sub in (0, 2):
        out = io.BytesIO()
        Image.fromarray(img[:, :, ::-1]).save(out, "JPEG", subsampling=sub,
                                              progressive=True)
        seeds.append(out.getvalue())
    out = io.BytesIO()
    Image.fromarray(img[:, :, 0]).save(out, "JPEG", progressive=True)
    seeds += [out.getvalue(), bytes(cv2.imencode(
        ".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])[1])]
    seeds += [write_png(img[:, :, :1] // 64, 2, 3, palette=np.arange(
        12).reshape(4, 3) * 20), write_png(img.astype(np.uint16) * 257, 16, 2,
                                           interlace=True),
              write_png(np.dstack([img, img[:, :, :1]]), 8, 6),
              bytes(cv2.imencode(".bmp", img)[1])]
    rng = np.random.default_rng(0)
    mutants = [_mutant(blob, rng) for blob in seeds for _ in range(80)]
    with open(tmp_path / "mutants.pkl", "wb") as f:
        pickle.dump(mutants, f)
    env = dict(os.environ, PYTHONPATH=str(repo))
    flags = ["-std=c++17", "-shared", "-fPIC", "-O1", "-g"]
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    if os.path.isabs(asan) and os.path.exists(asan):
        flags += ["-fsanitize=address", "-fno-omit-frame-pointer"]
        env.update(LD_PRELOAD=asan, ASAN_OPTIONS="detect_leaks=0")
    lib = tmp_path / "libimcodec.so"
    subprocess.run(["g++", *flags, "-o", str(lib), str(imcodec.SOURCE)],
                   check=True, timeout=300)
    proc = subprocess.run(
        [sys.executable, "-c", _DECODE_MUTANTS, str(lib),
         str(tmp_path / "mutants.pkl")], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    counts = eval(proc.stdout.strip().splitlines()[-1])
    assert sum(counts.values()) == len(mutants)
    assert counts["decoded"] and counts["none"], counts


# -------------------------------------------------------------- encoder
@pytest.mark.parametrize("quality", [85, 95])
@pytest.mark.parametrize("h,w", SIZES + ((480, 640),))
def test_imencode_jpeg_matches_cv2(h, w, quality):
    """The encoder writes cv2.imencode's bytes (baseline 4:2:0, Annex K
    tables at libjpeg's quality scaling, the standard Huffman tables), so
    decoded by cv2 its values equal cv2's own encoding's: 0 differ."""
    img = smooth_image(quality + h, h, w)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    got = imcodec.imencode_jpeg(img, quality)
    assert got == bytes(buf)
    a = cv2.imdecode(np.frombuffer(got, np.uint8), cv2.IMREAD_COLOR)
    b = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    diff = np.abs(a.astype(int) - b.astype(int))
    print(f"{h}x{w} q{quality}: {int((diff > 0).sum())} of {diff.size} "
          f"values differ, max {int(diff.max())}")
    assert diff.max() == 0
    assert_decodes_as_cv2(got)


def test_imencode_jpeg_grey_input_and_errors():
    grey = smooth_image(7, 18, 22)[:, :, 0]
    got = imcodec.imdecode(imcodec.imencode_jpeg(grey, 90))
    ok, buf = cv2.imencode(".jpg", np.dstack([grey] * 3),
                           [cv2.IMWRITE_JPEG_QUALITY, 90])
    want = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError):
        imcodec.imencode_jpeg(grey.astype(np.float32))
    with pytest.raises(ValueError):
        imcodec.imencode_jpeg(np.zeros((0, 4, 3), np.uint8))


# ------------------------------------------------------------ polylines
def _quads(seed, n, h, w):
    rng = np.random.default_rng(seed)
    for i in range(n):
        if i % 3 == 0:   # past the edges
            q = rng.uniform(-30, max(h, w) + 30, (4, 2))
        else:
            q = rng.uniform(0, min(h, w), (4, 2))
        yield q.astype(np.int64)


@pytest.mark.parametrize("seed", range(4))
def test_polylines_twin_matches_cv2(seed):
    """cv_ops.polylines2 paints cv2.polylines(img, [pts], True, (255, 0,
    0), 2)'s pixels: seeded quads, a third of them past the image's edges,
    degenerate ones (repeated points) included."""
    rng = np.random.default_rng(100 + seed)
    for i, q in enumerate(_quads(seed, 120, 64, 90)):
        if i % 17 == 0:
            q[1] = q[0]
        h, w = int(rng.integers(20, 120)), int(rng.integers(20, 120))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        want = cv2.polylines(img.copy(), [q.reshape(-1, 1, 2)], True,
                             (255, 0, 0), 2)
        got = cv_ops.polylines2(img.copy(), q, (255, 0, 0))
        np.testing.assert_array_equal(got, want)


def test_draw_ocr_matches_jax():
    """The v2 preview's drawing: float boxes truncated to pixels, the
    drop_score filter, the input left untouched; with texts, the text
    panel of sav2Img."""
    img = smooth_image(9, 120, 160)
    rng = np.random.default_rng(9)
    boxes = [rng.uniform(-5, 165, (4, 2)).tolist() for _ in range(12)]
    scores = list(rng.uniform(0, 1, 12))
    before = img.copy()
    for kw in (dict(drop_score=0.0), dict(scores=scores, drop_score=0.5),
               dict(txts=[f"line {i} text" for i in range(12)],
                    scores=scores, drop_score=0.5)):
        np.testing.assert_array_equal(draw_ocr(img, boxes, **kw),
                                      jdraw_ocr(img, boxes, **kw))
    np.testing.assert_array_equal(img, before)

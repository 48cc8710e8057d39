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
None for (garbage, every truncation) give None. Hostile uploads of a
few hundred
bytes (over-subscribed or refused Huffman tables, sides and pixel counts
past libpng's, libjpeg's and cv2's limits) answer as cv2 does (None, or
ValueError where cv2 raises), a PNG zip bomb inflates only its image, and
seeded mutants of committed and generated images decode without a fault
in a build with AddressSanitizer. A baseline JPEG streams: decoding an
8192 x 8192 4:2:0 file raises the process's peak RSS by less than its
output plus 64 MB. TIFF (cv2's LZW, PIL's none / PackBits / LZW / Deflate
of modes 1, L, P, RGB, RGBA, I;16, and hand-built tiled, planar, 2- to
16-bit, MinIsWhite, palette, big-endian, multi-strip and oriented files)
and Netpbm P1–P6 (ASCII with comments, binary, 16-bit, truncated) decode
value-equal to cv2; hostile TIFF headers give None or cv2's ValueError,
and their seeded mutants decode without a fault under AddressSanitizer. A
4096 x 4096 16-bit RGBA Deflate TIFF decodes within its output plus 64 MB
of peak RSS, and a 24 MB ASCII P2 with a comment on every line in 3 s.
GIF (cv2's, PIL's static, interlaced and animated files with transparency
and disposal, hand-built layouts and LZW streams), PAM (every tuple type at
8 and 16 bits), PFM (both byte orders, grey and colour, special values),
Sun raster (depths 1, 8, 24, 32, colour maps; the types cv2 refuses) and
Radiance HDR (flat, RLE, mixed) answer as cv2 does, truncated and mutated
files too, and the five committed samples decode to cv2's recorded
hashes. `imencode_jpeg` writes cv2's bytes
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
    """Formats once not read, value-equal to cv2 now: WebP (cv2's default
    encoding), a GIF (PIL's), a palette BMP and cv2's own TIFF."""
    img = smooth_image(6, 20, 24)
    ok, buf = cv2.imencode(".webp", img)
    assert ok and cv2.imdecode(buf, cv2.IMREAD_COLOR) is not None
    assert_decodes_as_cv2(bytes(buf))
    gif = io.BytesIO()
    Image.fromarray(img[:, :, ::-1]).save(gif, "GIF")
    assert_decodes_as_cv2(gif.getvalue())
    ok, buf = cv2.imencode(".tiff", img)
    assert_decodes_as_cv2(bytes(buf))
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


# ------------------------------------------------- JPEG peak memory
_PEAK_RSS = """
import resource, sys
from onnxocr_tpu_torch.utils import imcodec
imcodec.lib()
buf = open(sys.argv[1], "rb").read()
def rss_kb():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
before = rss_kb()
img = imcodec.imdecode(buf)
peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(img.shape, (peak - before) * 1024, img.nbytes)
"""


def test_baseline_jpeg_streams_within_output_plus_64mb(tmp_path):
    """A seeded 8192 x 8192 baseline 4:2:0 JPEG decoded in a subprocess:
    the peak RSS (ru_maxrss) rises above the RSS before the decode by less
    than the output's bytes plus 64 MB (a decoder that keeps every
    coefficient, 2 bytes a sample, and whole planes, as this one did
    before it streamed, needs more)."""
    import subprocess
    import sys
    rng = np.random.default_rng(8192)
    small = cv2.GaussianBlur(rng.integers(0, 256, (256, 256, 3)).astype(
        np.uint8), (5, 5), 0)
    big = cv2.resize(small, (8192, 8192), interpolation=cv2.INTER_LINEAR)
    big[::7, ::5] ^= 0x55
    ok, buf = cv2.imencode(".jpg", big, [cv2.IMWRITE_JPEG_QUALITY, 90])
    del big
    path = tmp_path / "big.jpg"
    path.write_bytes(bytes(buf))
    repo = Path(__file__).resolve().parents[1]
    # ru_maxrss is kept across exec: the decoding process is forked by a
    # shell, not by this (large) process, so that its peak is its own
    proc = subprocess.run(["/bin/sh", "-c", '"$@"', "sh", sys.executable,
                           "-c", _PEAK_RSS, str(path)],
                          cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    shape, rise, out = proc.stdout.strip().rsplit(" ", 2)
    assert shape == "(8192, 8192, 3)"
    print(f"peak RSS rise {int(rise) / 2**20:.1f} MB, output "
          f"{int(out) / 2**20:.1f} MB")
    assert int(rise) < int(out) + 64 * 2**20


# ----------------------------------------------------------------- TIFF
def _packbits(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 255, data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and
                                             data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _lzw(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: MSB-first codes from 9 bits, wider
    once the next code passes the width, a clear when the table fills."""
    codes, nbits = [], 9
    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    codes.append((256, nbits))
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], nbits))
        table[wc] = nxt
        nxt += 1
        if nxt > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
        if nxt >= 4094:
            codes.append((256, nbits))
            table = {bytes([i]): i for i in range(256)}
            nxt, nbits = 258, 9
        w = bytes([c])
    if w:
        codes.append((table[w], nbits))
    codes.append((257, nbits))
    acc = nb = 0
    out = bytearray()
    for code, n in codes:
        acc, nb = (acc << n) | code, nb + n
        while nb >= 8:
            nb -= 8
            out.append((acc >> nb) & 255)
    if nb:
        out.append((acc << (8 - nb)) & 255)
    return bytes(out)


def write_tiff(samples, photo, bps, comp=1, planar=1, predictor=1,
               tile=None, rps=None, order="<", extra=None, cmap=None,
               orientation=None):
    """(h, w, spp) samples → the bytes of a one-IFD TIFF."""
    h, w, spp = samples.shape
    dt = np.dtype(order + "u2") if bps == 16 else np.uint8
    codec = {1: lambda r: r, 32773: _packbits, 5: _lzw,
             8: zlib.compress}[comp]

    def chunk(px):
        px = px.astype(np.int64)
        if predictor == 2:
            d = px.copy()
            d[:, 1:] = px[:, 1:] - px[:, :-1]
            px = d % (65536 if bps == 16 else 256)
        rows, cols, per = px.shape
        if bps < 8:
            bits = ((px.reshape(rows, -1, 1) >> np.arange(bps - 1, -1, -1))
                    & 1).reshape(rows, -1).astype(np.uint8)
            return codec(np.packbits(bits, axis=1).tobytes())
        return codec(px.astype(dt).tobytes())
    planes = [samples] if planar == 1 else \
        [samples[:, :, i:i + 1] for i in range(spp)]
    chunks = []
    for pl in planes:
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    t = np.zeros((th, tw, pl.shape[2]), pl.dtype)
                    part = pl[ty:ty + th, tx:tx + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(chunk(t))
        else:
            for y in range(0, h, rps or h):
                chunks.append(chunk(pl[y:y + (rps or h)]))
    offs, pos = [], 8
    for c in chunks:
        offs.append(pos)
        pos += len(c)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp),
            259: (3, [comp]), 262: (3, [photo]), 277: (3, [spp]),
            284: (3, [planar])}
    if tile:
        tags.update({322: (4, [tile[0]]), 323: (4, [tile[1]]),
                     324: (4, offs), 325: (4, [len(c) for c in chunks])})
    else:
        tags.update({273: (4, offs), 278: (4, [rps or h]),
                     279: (4, [len(c) for c in chunks])})
    if orientation:
        tags[274] = (3, [orientation])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if cmap is not None:
        tags[320] = (3, [int(v) for v in cmap.reshape(-1)])
    if extra is not None:
        tags[338] = (3, extra)
    ifd_pos = pos
    blob_pos = ifd_pos + 2 + 12 * len(tags) + 4
    ifd, blob = struct.pack(order + "H", len(tags)), bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        raw = struct.pack(order + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if len(raw) <= 4:
            ifd += struct.pack(order + "HHI", tag, typ, len(vals)) + \
                raw.ljust(4, b"\0")
        else:
            ifd += struct.pack(order + "HHII", tag, typ, len(vals),
                               blob_pos + len(blob))
            blob += raw + b"\0" * (len(raw) % 2)
    head = (b"II" if order == "<" else b"MM") + struct.pack(
        order + "HI", 42, ifd_pos)
    return head + b"".join(chunks) + ifd + b"\0\0\0\0" + bytes(blob)


@pytest.mark.parametrize("h,w", ((13, 17), (1, 1), (64, 64), (100, 131)))
def test_tiff_from_encoders_matches_cv2(h, w):
    """cv2's own TIFF (LZW, predictor 2) and PIL's at every compression
    PIL writes, of modes 1, L, P, RGB, RGBA (unassociated alpha: cv2 reads
    it premultiplied) and I;16."""
    rng = np.random.default_rng(h * w)
    img = smooth_image(h + w, h, w)
    alpha = rng.integers(0, 256, (h, w)).astype(np.uint8)
    for arr in (img, img[:, :, 0]):
        ok, buf = cv2.imencode(".tiff", arr)
        assert_decodes_as_cv2(bytes(buf))
    rgb = img[:, :, ::-1]
    grey16 = (alpha.astype(np.uint16) * 257 + rng.integers(0, 200, (h, w))
              ).astype(np.uint16)
    images = [Image.fromarray(rgb), Image.fromarray(np.dstack([rgb, alpha])),
              Image.fromarray(alpha), Image.fromarray(alpha).convert("1"),
              Image.fromarray(rgb).convert("P"), Image.fromarray(grey16)]
    for comp in (None, "packbits", "tiff_lzw", "tiff_deflate"):
        for im in images:
            out = io.BytesIO()
            im.save(out, "TIFF", **({} if comp is None else
                                    {"compression": comp}))
            assert_decodes_as_cv2(out.getvalue())


TIFF_KINDS = {  # name: (photometric, bits, spp, extra samples, colour map)
    "rgb": (2, 8, 3, None, False), "rgba-unassoc": (2, 8, 4, [2], False),
    "rgba-assoc": (2, 8, 4, [1], False), "rgb16": (2, 16, 3, None, False),
    "rgba16": (2, 16, 4, [2], False), "grey": (1, 8, 1, None, False),
    "white": (0, 8, 1, None, False), "grey16": (1, 16, 1, None, False),
    "white16": (0, 16, 1, None, False), "bilevel": (1, 1, 1, None, False),
    "bilevel-white": (0, 1, 1, None, False),
    "pal4": (3, 4, 1, None, True), "pal8": (3, 8, 1, None, True)}


@pytest.mark.parametrize("kind", list(TIFF_KINDS))
def test_tiff_hand_built_matches_cv2(kind):
    """Seeded samples written by hand (PIL writes no tiles or planar
    files): none / PackBits / LZW / Deflate; strips of 3 rows, one strip,
    16 x 16 tiles (compressed: cv2 refuses most uncompressed tiled
    layouts, see ROADMAP), planar 2; predictor 2; both byte orders; 8- and
    16-bit colour maps (libtiff takes a map below 256 as 8-bit). The
    16-bit grey tiles cut by the right edge follow libtiff's
    put16bitbwtile, which steps their rows by the skew in bytes."""
    photo, bps, spp, extra, pal = TIFF_KINDS[kind]
    rng = np.random.default_rng(len(kind))
    top = 1 << bps
    for h, w in ((13, 17), (40, 70)):
        samples = rng.integers(0, top, (h, w, spp)).astype(
            np.uint16 if bps == 16 else np.uint8)
        maps = [None]
        if pal:
            maps = [rng.integers(0, 65536, (3, top)),
                    rng.integers(0, 256, (3, top))]
        for cmap in maps:
            for comp in (1, 32773, 5, 8):
                layouts = [{}, {"rps": 3}]
                if comp != 1:
                    layouts.append({"tile": (16, 16)})
                if spp > 1:
                    layouts.append({"planar": 2})
                    if comp != 1:
                        layouts.append({"planar": 2, "tile": (16, 32)})
                for layout in layouts:
                    for pred in ((1, 2) if bps >= 8 else (1,)):
                        for order in ("<", ">"):
                            assert_decodes_as_cv2(write_tiff(
                                samples, photo, bps, comp=comp,
                                predictor=pred, order=order, extra=extra,
                                cmap=cmap, **layout))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_matches_cv2(orientation):
    img = smooth_image(orientation, 21, 34)
    blob = write_tiff(img[:, :, ::-1].copy(), 2, 8, comp=5, rps=4,
                      orientation=orientation)
    assert_decodes_as_cv2(blob)
    out = io.BytesIO()
    Image.fromarray(img[:, :, ::-1]).save(out, "TIFF",
                                          tiffinfo={274: orientation})
    assert_decodes_as_cv2(out.getvalue())


def _tiff_entry(blob, tag):
    """The offset of a tag's 12-byte entry in a little-endian TIFF."""
    ifd, = struct.unpack("<I", blob[4:8])
    count, = struct.unpack("<H", blob[ifd:ifd + 2])
    for e in range(ifd + 2, ifd + 2 + 12 * count, 12):
        if struct.unpack("<H", blob[e:e + 2])[0] == tag:
            return e
    raise KeyError(tag)


def _tiff_set(blob, tag, value):
    e = _tiff_entry(blob, tag)
    return blob[:e + 8] + struct.pack("<I", value) + blob[e + 12:]


def _hostile_tiffs():
    img = smooth_image(3, 24, 30)[:, :, ::-1].copy()
    lzw = write_tiff(img, 2, 8, comp=5)
    raw = write_tiff(img, 2, 8)
    strips = write_tiff(img, 2, 8, comp=32773, rps=4)
    bad_lzw = bytearray(lzw)
    bad_lzw[9] = 0xFF                     # codes past the table
    return {
        "offset-past-end": (_tiff_set(raw, 273, len(raw) + 10), "none"),
        "count-past-end": (_tiff_set(raw, 279, len(raw)), "decoded"),
        "short-strip": (_tiff_set(raw, 279, 100), "decoded"),
        "strip-count-mismatch": (
            strips[:_tiff_entry(strips, 273) + 4] + struct.pack("<I", 2) +
            strips[_tiff_entry(strips, 273) + 8:], "decoded"),
        "lzw-codes-out-of-range": (bytes(bad_lzw), "decoded"),
        "rows-per-strip-0": (_tiff_set(raw, 278, 0), "none"),
        "width-2^20+1": (_tiff_set(raw, 256, (1 << 20) + 1), "raises"),
        "40000x40000": (_tiff_set(_tiff_set(raw, 256, 40000), 257, 40000),
                        "raises"),
        "ifd-past-end": (raw[:4] + struct.pack("<I", len(raw) + 8) + raw[8:],
                         "none"),
        # 2^30 tiles of one offset and one count: past a million strips or
        # tiles libtiff refuses to pad the arrays, so the file bounds them
        "1x1-tiles-of-32768^2": (_tiff_set(_tiff_set(
            write_tiff(img[:1, :1], 2, 8, tile=(1, 1)), 256, 32768), 257,
            32768), "none-within-64mb"),
    }


_CAPPED_RSS = """
import resource, sys
resource.setrlimit(resource.RLIMIT_AS, (4 << 30, 4 << 30))
from onnxocr_tpu_torch.utils import imcodec
imcodec.lib()
buf = open(sys.argv[1], "rb").read()
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
img = imcodec.imdecode(buf)
peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(None if img is None else img.shape, (peak - before) * 1024)
"""


@pytest.mark.parametrize("case", list(_hostile_tiffs()))
def test_tiff_hostile_headers_answer_as_cv2(case, tmp_path):
    """A strip offset past the data, a zero strip height and an IFD past
    the end give None; a single uncompressed strip whose count runs past
    the data or falls short of the image (libtiff's "Bogus
    StripByteCounts" estimate), StripOffsets of fewer values than strips
    (the rest read as 0) and LZW codes past the table (the strip keeps
    what decoded before them) decode as cv2 decodes them; sizes past cv2's
    limits raise as cv2 raises; nothing is allocated for the image before
    the header is checked, nor for strip arrays the file does not hold:
    a 136-byte file of 2^30 tiles gives None in a subprocess (its address
    space capped at 4 GiB) whose peak RSS rises by less than 64 MB."""
    blob, expect = _hostile_tiffs()[case]
    if expect == "none-within-64mb":
        import subprocess
        import sys
        path = tmp_path / "hostile.tiff"
        path.write_bytes(blob)
        repo = Path(__file__).resolve().parents[1]
        proc = subprocess.run(
            [sys.executable, "-c", _CAPPED_RSS, str(path)], cwd=repo,
            env=dict(os.environ, PYTHONPATH=str(repo),
                     OPENBLAS_NUM_THREADS="1"),
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        got, rise = proc.stdout.split()
        assert got == "None" and int(rise) < 64 * 2**20
        assert cv2.imdecode(np.frombuffer(blob, np.uint8),
                            cv2.IMREAD_COLOR) is None
        return
    if expect == "raises":
        with pytest.raises(cv2.error, match="validateInputImageSize"):
            cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
        with pytest.raises(ValueError, match="validateInputImageSize"):
            imcodec.imdecode(blob)
        return
    want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    got = imcodec.imdecode(blob)
    if expect == "none":
        assert want is None and got is None
    else:
        assert want is not None and got is not None
        np.testing.assert_array_equal(got, want)


def test_tiff_not_read_gives_none():
    """What cv2 refuses gives None here too (4-bit grey: "should be
    palette"; 2 bits of any kind). The files this reader once left unread
    while cv2 decodes them — CMYK, FillOrder 2, uncompressed tiles of more
    than one tile (cv2 5.0 reads those whose tile fills a whole number of
    KiB) — are value-equal to cv2 now; tests/test_torch_tiff.py holds
    the rest of those layouts."""
    img = smooth_image(4, 32, 32)[:, :, ::-1].copy()
    for photo, bps in ((1, 2), (1, 4), (3, 2)):
        blob = write_tiff(img[:, :, :1] >> (8 - bps), photo, bps,
                          cmap=np.arange(3 << bps) * 100)
        assert cv2.imdecode(np.frombuffer(blob, np.uint8),
                            cv2.IMREAD_COLOR) is None
        assert imcodec.imdecode(blob) is None
    cmyk = write_tiff(np.dstack([img, img[:, :, :1]]), 5, 8)
    out = io.BytesIO()
    Image.fromarray(img).save(out, "TIFF", tiffinfo={266: 2})
    for blob in (cmyk, out.getvalue(),
                 write_tiff(np.dstack([img, img[:, :, :1]]), 2, 8,
                            tile=(16, 16), extra=[1])):
        assert_decodes_as_cv2(blob)


# --------------------------------------------------------------- Netpbm
def _pxm_cases(rng):
    for h, w in ((5, 7), (1, 1), (13, 17)):
        for maxval in (1, 7, 255, 256, 1000, 65535):
            for kind in (1, 2, 3, 5, 6):
                if kind == 1 and maxval != 1:
                    continue
                nch = 3 if kind in (3, 6) else 1
                vals = rng.integers(0, maxval + 1 if kind != 1 else 2,
                                    (h, w, nch))
                if kind in (2, 3):                 # some past maxval
                    vals = vals + rng.integers(0, 3, (h, w, nch))
                head = f"P{kind}\n# a comment\n{w} {h}\n" + (
                    f"{maxval}\n" if kind != 1 else "")
                if kind in (1, 2, 3):
                    sep = "" if kind == 1 and h > 1 else " "
                    body = ("\n".join(sep.join(str(int(v)) for v in
                                               row.reshape(-1))
                                      for row in vals) + "\n").encode()
                    blob = head.encode() + body
                    yield blob
                    yield blob[:-1]                # no byte after the last
                    yield blob.replace(b"\n", b" # c\n", 1)
                else:
                    body = vals.astype(">u2").tobytes() if maxval > 255 \
                        else np.minimum(vals, 255).astype(np.uint8).tobytes()
                    yield head.encode() + body
                    yield head.encode() + body[:-1]
        bits = rng.integers(0, 2, (h, w)).astype(np.uint8)
        yield f"P4\n{w} {h}\n".encode() + np.packbits(bits, axis=1).tobytes()


# comments among the samples: after whitespace, ended by '\r', holding
# digits and '#'; a '#' right after a number's digits (read as the byte
# after the number, so what follows it is data); any byte after the digits;
# P1's single digits, after which '#' does start a comment; a comment that
# never ends, before and after the last sample
PXM_COMMENTS = [
    b"P2\n3 1\n255\n1 # c 9 #\n2\r#x\r3\n",
    b"P2\n2 1\n255\n1#c\n2\n", b"P2\n2 1\n255\n1#\n2\n",
    b"P2\n2 1\n255\n1a2 \n", b"P2\n2 1\n255\n1ab2 \n",
    b"P1\n3 1\n1#c\n01\n", b"P1\n3 1\n1 # 0\r\n0 # 1\n1",
    b"P3\n1 1\n255\n1 2 3# never ends", b"P2\n2 1\n255\n1 # never ends",
    b"P2\n2 1\n255\n\t1\v\f#\n\n2 ", b"P2\n2 1\n255\n1 #\n"]


def test_netpbm_matches_cv2():
    """P1–P6 as cv2's PxMDecoder reads them: ASCII (comments, values past
    maxval, a file ending right after its last number), binary 8- and
    16-bit (samples as stored, no maxval scaling), bilevel; PIL's PPM,
    PGM, PBM and 16-bit PGM; bad headers and sizes."""
    rng = np.random.default_rng(11)
    decoded = 0
    blobs = list(_pxm_cases(rng))
    img = smooth_image(12, 9, 11)
    for im in (Image.fromarray(img), Image.fromarray(img[:, :, 0]),
               Image.fromarray(img[:, :, 0]).convert("1"),
               Image.fromarray(img[:, :, 0].astype(np.uint16) * 257)):
        out = io.BytesIO()
        im.save(out, "PPM")
        blobs.append(out.getvalue())
    blobs += [b"P6\n0 5\n255\n", b"P5 3 2 70000\n" + bytes(6),
              b"P2\n2 1\n255\n1 x\n", b"P5\n3 2\n255\n" + bytes(6) + b"x",
              b"P3\n1 1 255\n300 2 3\n", b"P7\n1 1\n"]
    blobs += PXM_COMMENTS
    for blob in blobs:
        want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
        got = imcodec.imdecode(blob)
        if want is None:
            assert got is None, blob[:30]
            continue
        decoded += 1
        assert got is not None and got.shape == want.shape, blob[:30]
        np.testing.assert_array_equal(got, want)
    assert decoded > 100
    for w, h in ((1 << 20) + 1, 1), (40000, 40000):
        blob = f"P5\n{w} {h}\n255\n".encode()
        with pytest.raises(cv2.error, match="validateInputImageSize"):
            cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
        with pytest.raises(ValueError, match="validateInputImageSize"):
            imcodec.imdecode(blob)


def test_tiff_and_netpbm_mutants_never_crash(tmp_path):
    """Seeded mutants of TIFFs (LZW, PackBits, Deflate, tiled, planar,
    16-bit) and Netpbm files decode to an image, None or a ValueError in
    a process whose codec library is built with AddressSanitizer (the LZW
    and PackBits decoders are C++)."""
    import pickle
    import subprocess
    import sys
    repo = Path(__file__).resolve().parents[1]
    img = smooth_image(13, 29, 37)[:, :, ::-1].copy()
    seeds = [write_tiff(img, 2, 8, comp=5, predictor=2),
             write_tiff(img, 2, 8, comp=32773, rps=5),
             write_tiff(img, 2, 8, comp=8, tile=(16, 16)),
             write_tiff(img.astype(np.uint16) * 257, 2, 16, comp=5,
                        planar=2),
             write_tiff(img[:, :, :1] // 64, 3, 2, comp=32773,
                        cmap=np.arange(12).reshape(3, 4) * 5000),
             b"P6\n37 29\n255\n" + img.tobytes(),
             b"P3\n2 2\n255\n1 2 3 4 5 6 7 8 9 10 11 12\n",
             b"P2\n# c\n3 2\n255\n1 # x 7\n2 3\r4 5 6\n",
             b"P1\n3 2\n1 0#c\n1\n0 1 0\n"]
    rng = np.random.default_rng(1)
    mutants = [_mutant(blob, rng) for blob in seeds for _ in range(60)]
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


def test_tiff_converts_into_the_output_within_64mb(tmp_path):
    """A seeded 4096 x 4096 16-bit RGBA TIFF (unassociated alpha, Deflate,
    predictor 2, strips of 16 rows: 128 MB of samples in a few MB of file)
    decoded in a subprocess: the peak RSS rises by less than the output's
    48 MB plus 64 MB, as each strip is converted into the output as it is
    decoded (a reader that holds every sample and converts the image in
    wide integers at once rose by 625 MB here). The pixels equal cv2's."""
    import subprocess
    import sys
    rng = np.random.default_rng(4096)
    small = rng.integers(0, 65536, (128, 128, 4)).astype(np.uint16)
    samples = np.repeat(np.repeat(small, 32, axis=0), 32, axis=1)
    blob = write_tiff(samples, 2, 16, comp=8, predictor=2, rps=16,
                      extra=[2])
    del samples
    path = tmp_path / "big.tiff"
    path.write_bytes(blob)
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run(["/bin/sh", "-c", '"$@"', "sh", sys.executable,
                           "-c", _PEAK_RSS + _DIGEST, str(path)],
                          cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    first, digest = proc.stdout.strip().splitlines()
    shape, rise, out = first.rsplit(" ", 2)
    assert shape == "(4096, 4096, 3)"
    print(f"peak RSS rise {int(rise) / 2**20:.1f} MB, output "
          f"{int(out) / 2**20:.1f} MB, file {len(blob) / 2**20:.1f} MB")
    assert int(rise) < int(out) + 64 * 2**20
    want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    import hashlib
    assert digest == hashlib.sha256(want.tobytes()).hexdigest()


_DIGEST = """
import hashlib
print(hashlib.sha256(img.tobytes()).hexdigest())
"""


@pytest.mark.parametrize("rle4", [False, True])
def test_bmp_rle_decodes_into_the_output_within_64mb(tmp_path, rle4):
    """A hostile 8192 x 8192 RLE8 / RLE4 BMP of a few KB (runs and
    absolute blocks, a delta, the end of bitmap) decoded in a subprocess:
    the peak RSS rises by less than the output's 192 MB plus 64 MB, as the
    runs are written into the output in its final orientation (an index
    plane, its palette lookup and the bottom-up flip rose by 384 MB on the
    same file). The pixels equal cv2's."""
    import hashlib
    import subprocess
    import sys
    n = 8192
    codes = bytearray()
    for k in range(40):
        block = b"\x12\x34\x50\x00" if rle4 else bytes([1, 2, 3, 4, 5, 0])
        codes += bytes([200, k % 16 * 17]) + b"\x00\x05" + block + \
            b"\x00\x00"                                 # run, block, EOL
    codes += b"\x00\x02\x10\x20" + bytes([90, 7])
    if rle4:              # an end of bitmap ends a row only: every EOL
        codes += b"\x00\x00" * (n - 40)
    codes += b"\x00\x01"
    pal = _palette(256 if not rle4 else 16, 9)
    blob = bmp_file(n, n, 4 if rle4 else 8, comp=2 if rle4 else 1,
                    pixels=bytes(codes), palette=pal)
    path = tmp_path / "big.bmp"
    path.write_bytes(blob)
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run(["/bin/sh", "-c", '"$@"', "sh", sys.executable,
                           "-c", _PEAK_RSS + _DIGEST, str(path)],
                          cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    first, digest = proc.stdout.strip().splitlines()
    shape, rise, out = first.rsplit(" ", 2)
    assert shape == f"({n}, {n}, 3)"
    print(f"peak RSS rise {int(rise) / 2**20:.1f} MB, output "
          f"{int(out) / 2**20:.1f} MB, file {len(blob)} bytes")
    assert int(rise) < int(out) + 64 * 2**20
    want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    assert digest == hashlib.sha256(want.tobytes()).hexdigest()


def test_ascii_netpbm_with_comments_reads_in_bounded_time():
    """A hostile ASCII upload: a seeded 4000 x 3000 P2 file of 24 MB whose
    every line ends in a comment holding digits and '#'. It decodes
    value-equal to cv2 within 3 s (cv2 reads it in C in well under a
    second, as this reader does; one that takes the numbers one by one in
    Python spent 10.4 s here, holding the interpreter lock all that
    time)."""
    import time
    rng = np.random.default_rng(3000)
    h, w = 3000, 4000
    note = np.frombuffer(b"# 12 #3\r", np.uint8)
    text = np.empty((h, 2 * w + note.size), np.uint8)
    text[:, 0:2 * w:2] = 48 + rng.integers(0, 10, (h, w))
    text[:, 1:2 * w:2] = np.frombuffer(b" \t", np.uint8)[
        rng.integers(0, 2, (h, w))]
    text[:, 2 * w:] = note
    blob = f"P2\n{w} {h}\n9\n".encode() + text.tobytes() + b"\n"
    del text
    want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    t0 = time.perf_counter()
    got = imcodec.imdecode(blob)
    took = time.perf_counter() - t0
    print(f"{len(blob) / 2**20:.1f} MB decoded in {took:.2f} s")
    assert want is not None and got is not None
    np.testing.assert_array_equal(got, want)
    assert took < 3.0


# ----------------------------------------------------------------- WebP
def _riff(chunks, extra=0):
    """A RIFF/WEBP container of (fourcc, payload) chunks, each padded to an
    even length; `extra` is added to the RIFF size."""
    body = b"WEBP" + b"".join(
        k + struct.pack("<I", len(v)) + v + b"\0" * (len(v) & 1)
        for k, v in chunks)
    return b"RIFF" + struct.pack("<I", len(body) + extra) + body


def _webp_chunks(blob):
    out, pos = [], 12
    while pos + 8 <= len(blob):
        n, = struct.unpack("<I", blob[pos + 4:pos + 8])
        out.append((blob[pos:pos + 4], blob[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def _webp(img, quality):
    ok, buf = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert ok
    return bytes(buf)


def _vp8x(flags, w, h):
    return bytes([flags, 0, 0, 0]) + struct.pack("<I", w - 1)[:3] + \
        struct.pack("<I", h - 1)[:3]


def _anmf(x, y, w, h, payload):
    return b"".join(struct.pack("<I", v)[:3] for v in
                    (x // 2, y // 2, w - 1, h - 1, 100)) + b"\0" + payload


def _animation(frames, **kw):
    out = io.BytesIO()
    frames[0].save(out, "WEBP", save_all=True, append_images=frames[1:],
                   duration=100, **kw)
    return out.getvalue()


def assert_answers_as_cv2(blob, pixels=True):
    """cv2's answer for any bytes: an image of its shape (equal to cv2's
    with `pixels`), None, or an error."""
    try:
        want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        with pytest.raises(ValueError):
            imcodec.imdecode(blob)
        return "raised"
    got = imcodec.imdecode(blob)
    if want is None:
        assert got is None
        return "none"
    assert got is not None and got.shape == want.shape
    if pixels:
        np.testing.assert_array_equal(got, want)
    return "decoded"


@pytest.mark.parametrize("h,w", [(1, 1), (17, 33), (480, 640)])
@pytest.mark.parametrize("quality", [1, 50, 90, 100])
def test_webp_lossy_matches_cv2(h, w, quality):
    """VP8 (RFC 6386 key frames) through libwebp's fancy upsampler and
    14-bit YUV -> BGR: value-equal to cv2 on a photo-like and a noisy
    image (every intra mode, both loop filters, segments and partitions
    as libwebp's encoder picks them)."""
    for img in (smooth_image(h * 7 + quality, h, w),
                np.random.default_rng(quality).integers(
                    0, 256, (h, w, 3)).astype(np.uint8)):
        blob = _webp(img, quality)
        assert blob[12:16] == b"VP8 "
        assert_decodes_as_cv2(blob)


@pytest.mark.parametrize("colours", [None, 2, 4, 16, 256])
def test_webp_lossless_matches_cv2(colours):
    """VP8L (IMWRITE_WEBP_QUALITY 101): a noisy image, and images of at
    most 2, 4, 16 and 256 colours, whose colour-indexing transform bundles
    8, 4, 2 and 1 pixels a code; 67 x 129 and 300 x 200 (prefix-code
    groups by the meta image, colour cache, LZ77 copies)."""
    rng = np.random.default_rng(colours or 7)
    for h, w in ((67, 129), (300, 200)):
        if colours is None:
            img = smooth_image(h + w, h, w)
            img[::3, ::2] = rng.integers(0, 256, img[::3, ::2].shape)
        else:
            pal = rng.integers(0, 256, (colours, 3)).astype(np.uint8)
            img = pal[rng.integers(0, colours, (h, w))]
            img[h // 2:] = pal[np.arange(w) % colours][None]
        blob = _webp(img, 101)
        assert blob[12:16] == b"VP8L"
        assert_decodes_as_cv2(blob)


@pytest.mark.parametrize("quality", [50, 101])
def test_webp_with_alpha_matches_cv2(quality):
    """BGRA: lossy as VP8X + ALPH (the alpha plane VP8L-coded and
    filtered) + VP8, lossless as VP8L with its alpha bit. cv2's
    IMREAD_COLOR keeps the colour channels of the BGRA decode and drops
    alpha (no compositing): the codec gives the same."""
    rng = np.random.default_rng(quality)
    for h, w in ((1, 1), (23, 37), (120, 160)):
        alpha = rng.integers(0, 256, (h, w)).astype(np.uint8)
        img = np.dstack([smooth_image(w, h, w), alpha])
        blob = _webp(img, quality)
        kinds = [k for k, _ in _webp_chunks(blob)]
        assert kinds == ([b"VP8X", b"ALPH", b"VP8 "] if quality < 101
                         else [b"VP8L"])
        assert_decodes_as_cv2(blob)


def test_webp_container_cases_answer_as_cv2():
    """The container as libwebp parses it: ICCP / EXIF / unknown chunks
    skipped, the alpha flag absent with an ALPH present, a raw ALPH of the
    right and of too few bytes, a refused ALPH header, trailing bytes
    inside and outside the RIFF size, a RIFF size too small, a VP8L
    stream without its container (cv2 reads it), and a file under 32 bytes
    (cv2 refuses it)."""
    rng = np.random.default_rng(9)
    img = smooth_image(9, 17, 33)
    blob = _webp(np.dstack([img, rng.integers(0, 256, (17, 33)).astype(
        np.uint8)]), 50)
    (_, vp8x), (_, alph), (_, vp8) = _webp_chunks(blob)
    no_flag = bytes([vp8x[0] & ~0x10]) + vp8x[1:]
    lossless = _webp(img, 101)
    cases = {
        "extra-chunks": _riff([(b"VP8X", vp8x), (b"ICCP", b"abc"),
                               (b"ALPH", alph), (b"VP8 ", vp8),
                               (b"EXIF", b"xyzw")]),
        "no-alpha-flag": _riff([(b"VP8X", no_flag), (b"ALPH", alph),
                                (b"VP8 ", vp8)]),
        "raw-alpha": _riff([(b"VP8X", vp8x),
                            (b"ALPH", b"\0" + rng.bytes(17 * 33)),
                            (b"VP8 ", vp8)]),
        "raw-alpha-short": _riff([(b"VP8X", vp8x), (b"ALPH", b"\0" * 30),
                                  (b"VP8 ", vp8)]),
        "alpha-method-3": _riff([(b"VP8X", vp8x),
                                 (b"ALPH", b"\3" + alph[1:]),
                                 (b"VP8 ", vp8)]),
        "alpha-bad-code": _riff([(b"VP8X", vp8x),
                                 (b"ALPH", b"\1" + b"\xff" * 20),
                                 (b"VP8 ", vp8)]),
        "trailing-in-riff": _riff(_webp_chunks(lossless), 4) + b"\0" * 4,
        "trailing-outside": lossless + b"junk",
        "riff-too-small": _riff(_webp_chunks(lossless), -2),
        "bare-vp8l": _webp_chunks(lossless)[0][1],
        "short": _webp(img[:1, :2], 101)[20:],
    }
    answers = {k: assert_answers_as_cv2(v) for k, v in cases.items()}
    assert answers["bare-vp8l"] == "decoded"
    assert answers["short"] == "none" and len(cases["short"]) < 32
    assert answers["alpha-bad-code"] == "none"


def test_webp_animation_gives_its_first_frame_as_cv2():
    """cv2 5.0's imdecode of an animated WebP is its first frame, drawn
    at its offset on a zeroed canvas (the background colour unused) after
    WebPDemux accepted the whole file: lossless and lossy (with alpha)
    frames from PIL's encoder, a hand-built frame off the canvas origin,
    and files the demuxer refuses (a frame past the canvas, no ANIM
    chunk, a still image under the animation flag)."""
    rng = np.random.default_rng(12)
    frames = [Image.fromarray(smooth_image(i, 20, 30)) for i in range(3)]
    rgba = [Image.fromarray(np.dstack([
        smooth_image(5 + i, 20, 30), rng.integers(0, 256, (20, 30)).astype(
            np.uint8)]), "RGBA") for i in range(2)]
    lossless = _animation(frames, lossless=True)
    payload = _webp_chunks(lossless)[2][1][16:]
    anim = b"\0" * 6
    cases = {
        "lossless": lossless,
        "lossy-alpha": _animation(rgba, quality=50),
        "offset": _riff([(b"VP8X", _vp8x(2, 40, 30)), (b"ANIM", anim),
                         (b"ANMF", _anmf(4, 6, 30, 20, payload))]),
        "background": _riff([(b"VP8X", _vp8x(2, 40, 30)),
                             (b"ANIM", b"\x10\x20\x30\x40\0\0"),
                             (b"ANMF", _anmf(4, 6, 30, 20, payload))]),
        "off-canvas": _riff([(b"VP8X", _vp8x(2, 32, 30)), (b"ANIM", anim),
                             (b"ANMF", _anmf(4, 6, 30, 20, payload))]),
        "no-anim-chunk": _riff([(b"VP8X", _vp8x(2, 40, 30)),
                                (b"ANMF", _anmf(4, 6, 30, 20, payload))]),
        "still-under-flag": _riff([(b"VP8X", _vp8x(2, 30, 20)),
                                   (b"VP8L", payload[8:])]),
    }
    answers = {k: assert_answers_as_cv2(v) for k, v in cases.items()}
    assert answers == {"lossless": "decoded", "lossy-alpha": "decoded",
                       "offset": "decoded", "background": "decoded",
                       "off-canvas": "none", "no-anim-chunk": "none",
                       "still-under-flag": "none"}
    got = imcodec.imdecode(cases["offset"])
    np.testing.assert_array_equal(got[6:26, 4:34],
                                  np.asarray(frames[0])[:, :, ::-1])
    assert not got[:6].any() and not got[:, :4].any()


def _webp_seeds():
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (23, 37, 3)).astype(np.uint8)
    smooth = smooth_image(21, 40, 50)
    alpha = np.dstack([img, rng.integers(0, 256, (23, 37)).astype(np.uint8)])
    pal = rng.integers(0, 256, (5, 3)).astype(np.uint8)[
        rng.integers(0, 5, (30, 30))]
    frames = [Image.fromarray(smooth_image(30 + i, 20, 30)) for i in range(2)]
    return [_webp(img, 10), _webp(img, 75), _webp(img, 101),
            _webp(smooth, 50), _webp(smooth, 101), _webp(alpha, 50),
            _webp(alpha, 101), _webp(pal, 101),
            _animation(frames, quality=60)]


def test_webp_truncations_and_flips_answer_as_cv2():
    """Every seed (lossy, lossless, alpha, palette, animation) cut at 25
    offsets, and 40 seeded mutants of each with 1-3 bits flipped: each
    gives cv2's verdict, an image of its shape, None, or an error where
    cv2 raises (a flipped canvas side past 2^20). The pixels of a corrupt
    file are not held: libwebp's garbage differs between its builds."""
    rng = np.random.default_rng(22)
    counts = {"decoded": 0, "none": 0, "raised": 0}
    for blob in _webp_seeds():
        for cut in np.linspace(1, len(blob) - 1, 25).astype(int):
            counts[assert_answers_as_cv2(blob[:cut], pixels=False)] += 1
        for _ in range(40):
            b = bytearray(blob)
            for _ in range(rng.integers(1, 4)):
                b[rng.integers(len(b))] ^= 1 << int(rng.integers(8))
            counts[assert_answers_as_cv2(bytes(b), pixels=False)] += 1
    print(counts)
    assert counts["decoded"] > 100 and counts["none"] > 100, counts


def test_webp_partitions_led_by_ff_answer_as_cv2():
    """A VP8 partition whose first byte is 0xFF (and up to two more bytes
    overwritten) breaks the boolean decoder's invariant; how far libwebp
    then reads, and so whether it meets the end of the data, follows its
    7-byte loads. Each such file gives cv2's verdict and shape."""
    rng = np.random.default_rng(24)
    seeds = []
    for q in (5, 75):
        for h, w in ((23, 37), (64, 80)):
            seeds.append(_webp(rng.integers(0, 256, (h, w, 3)).astype(
                np.uint8), q))
            seeds.append(_webp(smooth_image(int(rng.integers(99)), h, w),
                               q))
    counts = {"decoded": 0, "none": 0, "raised": 0}
    for blob in seeds:
        assert blob[12:16] == b"VP8 "
        first = int.from_bytes(blob[20:23], "little") >> 5
        for off in (30, 30 + first):        # the modes', the tokens'
            for _ in range(30):
                b = bytearray(blob)
                b[off] = 0xFF
                for _ in range(int(rng.integers(0, 3))):
                    j = off + int(rng.integers(0, 8))
                    if j < len(b):
                        b[j] = int(rng.integers(0, 256))
                counts[assert_answers_as_cv2(bytes(b), pixels=False)] += 1
    print(counts)
    assert counts["decoded"] > 50 and counts["none"] > 50, counts


def test_webp_oversize_header_is_refused_before_allocation():
    """Sides are read from the headers first: an animation canvas of
    2^24 x 2 px or of more than 2^30 px raises as cv2 raises (its
    validateInputImageSize), at once and without allocating it."""
    import time
    payload = _webp_chunks(_webp(smooth_image(1, 2, 2), 101))[0][1]
    for w, h in ((1 << 24, 2), (40000, 30000)):
        blob = _riff([(b"VP8X", _vp8x(2, w, h)), (b"ANIM", b"\0" * 6),
                      (b"ANMF", _anmf(0, 0, 2, 2, b"VP8L" + struct.pack(
                          "<I", len(payload)) + payload +
                          b"\0" * (len(payload) & 1)))])
        with pytest.raises(cv2.error):
            cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
        t0 = time.perf_counter()
        with pytest.raises(ValueError, match="larger than"):
            imcodec.imdecode(blob)
        assert time.perf_counter() - t0 < 0.5


def test_webp_mutants_never_crash(tmp_path):
    """Seeded mutants (bytes overwritten, inserted or cut, as for the
    other formats) of every WebP seed decode to an image, None or a
    ValueError in a process whose codec library is built with
    AddressSanitizer: no read or write outside a buffer."""
    import pickle
    import subprocess
    import sys
    repo = Path(__file__).resolve().parents[1]
    rng = np.random.default_rng(23)
    mutants = [_mutant(blob, rng) for blob in _webp_seeds()
               for _ in range(60)]
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


def _vp8l_constant(w, h, argb):
    """A VP8L stream of w x h pixels all `argb`: no transform, five simple
    one-symbol prefix codes, so every pixel takes no bits."""
    bits = [(0x2F, 8), (w - 1, 14), (h - 1, 14), (1, 1), (0, 3),
            (0, 1), (0, 1), (0, 1)]          # no transform, cache, meta
    for sym in ((argb >> 8) & 0xFF, (argb >> 16) & 0xFF, argb & 0xFF,
                argb >> 24, 0):
        bits += [(1, 1), (0, 1), (1, 1), (sym, 8)]
    acc = n = 0
    for v, k in bits:
        acc |= v << n
        n += k
    return acc.to_bytes((n + 7) // 8, "little")


def test_webp_decodes_within_output_plus_32mb(tmp_path):
    """Decoded in a subprocess, the peak RSS rises by less than the
    output plus 32 MB: a seeded 4096 x 4096 lossy file (macroblock rows
    filtered in a cache of 24 rows, converted as they are final) and a
    16383 x 4096 lossless one (pixels in a ring of 2^21, transformed row
    by row); a decoder that keeps whole YUV planes or every ARGB pixel
    needs 24 MB or 256 MB more. Both equal cv2's decode."""
    import hashlib
    import subprocess
    import sys
    rng = np.random.default_rng(4096)
    small = cv2.GaussianBlur(rng.integers(0, 256, (256, 256, 3)).astype(
        np.uint8), (5, 5), 0)
    big = cv2.resize(small, (4096, 4096), interpolation=cv2.INTER_LINEAR)
    big[::7, ::5] ^= 0x55
    stream = _vp8l_constant(16383, 4096, 0xFF336699)
    blobs = {"lossy": _webp(big, 80),
             "lossless": _riff([(b"VP8L", stream)])}
    del big
    repo = Path(__file__).resolve().parents[1]
    for name, blob in blobs.items():
        path = tmp_path / f"{name}.webp"
        path.write_bytes(blob)
        proc = subprocess.run(
            ["/bin/sh", "-c", '"$@"', "sh", sys.executable, "-c",
             _PEAK_RSS + _DIGEST, str(path)], cwd=repo,
            env=dict(os.environ, PYTHONPATH=str(repo)), capture_output=True,
            text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        first, digest = proc.stdout.strip().splitlines()
        shape, rise, out = first.rsplit(" ", 2)
        print(f"{name}: {shape} peak RSS rise {int(rise) / 2**20:.1f} MB, "
              f"output {int(out) / 2**20:.1f} MB")
        assert int(rise) < int(out) + 32 * 2**20
        want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
        assert digest == hashlib.sha256(want.tobytes()).hexdigest()


# ------------------------------------- GIF, PAM, PFM, Sun raster, HDR
def _sub_blocks(data):
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def _lzw_pack(codes, min_size):
    """Codes at the widths a standard GIF decoder reads them."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    size, nxt, first, acc, nbits, out = min_size + 1, eoi + 1, True, 0, 0, []
    for c in codes:
        acc |= c << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
        if c == clear:
            size, nxt, first = min_size + 1, eoi + 1, True
        elif c != eoi and first:
            first = False
        elif c != eoi and nxt < 4096:
            nxt += 1
            if nxt == 1 << size and size < 12:
                size += 1
    return bytes(out + ([acc & 255] if nbits else []))


def _gif_frame(x, y, w, h, idx, min_size=8, lct=None, interlace=False):
    flags = 0x40 if interlace else 0
    if lct is not None:
        flags |= 0x80 | max(0, (len(lct) // 3 - 1).bit_length() - 1)
    if interlace:
        order = [*range(0, h, 8), *range(4, h, 8), *range(2, h, 4),
                 *range(1, h, 2)]
        idx = b"".join(idx[r * w:(r + 1) * w] for r in order)
    clear = 1 << min_size
    codes = [clear, *idx, clear + 1]
    # a clear code before the table fills keeps every code a literal
    for k in range(len(codes) - 1, 0, -(4000 - clear)):
        if 0 < k < len(codes) - 1:
            codes.insert(k, clear)
    return (b"\x2c" + struct.pack("<4H", x, y, w, h) + bytes([flags]) +
            (lct or b"") + bytes([min_size]) +
            _sub_blocks(_lzw_pack(codes, min_size)))


def _gce(disposal=0, transparent=None):
    return b"\x21\xf9\x04" + bytes([(disposal << 2) | (
        transparent is not None)]) + b"\x0a\x00" + bytes(
        [transparent or 0]) + b"\0"


def _gif(w, h, gct, bg, blocks):
    flags = 0x80 | 0x70 | max(0, (len(gct) // 3 - 1).bit_length() - 1) \
        if gct else 0
    return (b"GIF89a" + struct.pack("<2H", w, h) + bytes([flags, bg, 0]) +
            (gct or b"") + b"".join(blocks) + b"\x3b")


def _gif_cases():
    rng = np.random.default_rng(31)
    img = smooth_image(31, 23, 37)
    gct = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
    idx = rng.integers(0, 256, 23 * 37).astype(np.uint8).tobytes()
    small = rng.integers(0, 16, 6 * 9).astype(np.uint8).tobytes()
    lct = rng.integers(0, 256, 12).astype(np.uint8).tobytes()
    pil = {}
    rgb = Image.fromarray(img[:, :, ::-1])
    for name, kw in {"pil-static": {}, "pil-interlaced": {"interlace": True},
                     "pil-transparent": {"transparency": 3}}.items():
        out = io.BytesIO()
        rgb.quantize(64).save(out, "GIF", **kw)
        pil[name] = out.getvalue()
    frames = [rgb.quantize(32), Image.fromarray(
        smooth_image(32, 23, 37)[:, :, ::-1]).quantize(32)]
    for disposal in (1, 2):
        out = io.BytesIO()
        frames[0].save(out, "GIF", save_all=True, append_images=frames[1:],
                       transparency=0, disposal=disposal, duration=40,
                       loop=0)
        pil[f"pil-animated-disposal{disposal}"] = out.getvalue()
    return {
        "cv2": bytes(cv2.imencode(".gif", img)[1]),
        **pil,
        "interlaced-11-rows": _gif(9, 11, gct, 5, [_gif_frame(
            0, 0, 9, 11, idx[:99], interlace=True)]),
        "offset-frame-on-background": _gif(40, 30, gct, 17, [_gif_frame(
            3, 4, 37, 23, idx)]),
        "transparent-index": _gif(12, 8, gct, 9, [_gce(0, 7), _gif_frame(
            2, 1, 9, 6, small, 4)]),
        "transparent-is-background": _gif(12, 8, gct, 7, [_gce(2, 7),
                                                        _gif_frame(
            2, 1, 9, 6, small, 4)]),
        "local-table": _gif(12, 8, gct, 1, [_gif_frame(
            0, 0, 9, 6, bytes(v % 4 for v in small), 2, lct=lct)]),
        "local-table-past-its-end": _gif(12, 8, gct[:48], 1, [_gif_frame(
            0, 0, 9, 6, small, 4, lct=lct)]),
        "no-table": _gif(9, 6, None, 0, [_gif_frame(0, 0, 9, 6, small, 4)]),
        "index-past-the-table": _gif(9, 6, gct[:24], 0, [_gif_frame(
            0, 0, 9, 6, small, 4)]),
        "two-frames": _gif(12, 8, gct, 3, [
            _gce(1, 2), _gif_frame(0, 0, 9, 6, small, 4), _gce(0),
            _gif_frame(3, 2, 9, 6, small[::-1], 4)]),
        "extensions": _gif(9, 6, gct, 0, [
            b"\x21\xfe\x03abc\0", b"\x21\xff\x0bNETSCAPE2.0\x03\x01\0\0\0",
            b"\x21\xff\x0bXMP DataXMP\x05hello\0", b"\x21\x01\x0c" +
            bytes(12) + b"\0", _gif_frame(0, 0, 9, 6, small, 4)]),
        "application-unknown": _gif(9, 6, gct, 0, [
            b"\x21\xff\x0bABCDEFGHIJK\x03\x01\0\0\0",
            _gif_frame(0, 0, 9, 6, small, 4)]),
        "application-block-size-3": _gif(9, 6, gct, 0, [
            b"\x21\xff\x03abc\0", _gif_frame(0, 0, 9, 6, small, 4)]),
        "disposal-4": _gif(9, 6, gct, 0, [b"\x21\xf9\x04\x10\0\0\0\0",
                                          _gif_frame(0, 0, 9, 6, small, 4)]),
        "frame-off-screen": _gif(9, 6, gct, 0, [_gif_frame(
            1, 0, 9, 6, small, 4)]),
        "background-past-table": _gif(9, 6, gct[:48], 16, [_gif_frame(
            0, 0, 9, 6, small, 4)]),
        "no-trailer": _gif(9, 6, gct, 0, [_gif_frame(
            0, 0, 9, 6, small, 4)])[:-1],
        "min-code-size-12": _gif(9, 6, gct, 0, [_gif_frame(
            0, 0, 9, 6, small, 4)]).replace(b"\x00\x04", b"\x00\x0c", 1),
        "GIF88a": b"GIF88a" + _gif(9, 6, gct, 0, [_gif_frame(
            0, 0, 9, 6, small, 4)])[6:],
    }


_GIF_VERDICTS = {"disposal-4": "none", "frame-off-screen": "none",
                 "background-past-table": "none", "no-trailer": "none",
                 "min-code-size-12": "none", "GIF88a": "none",
                 "index-past-the-table": "none",
                 "application-unknown": "none",
                 "application-block-size-3": "none"}


@pytest.mark.parametrize("case", sorted(_gif_cases()))
def test_gif_matches_cv2(case):
    """cv2 5.0's GIF reading: the first frame on the logical screen, which
    starts as the global background colour (black without a global
    table); transparent pixels keep it; a local table overwrites the
    global one's first entries; with no table, index i is grey i but 1,
    which is white; interlaced rows; and the files cv2 refuses (a disposal
    past 3, a frame off the screen, a background or an index past the
    tables, no trailer, a code size past 12, an unknown version, an
    application extension skipped to a zero byte that is not its end or
    of block size 3)."""
    blob = _gif_cases()[case]
    assert assert_answers_as_cv2(blob) == _GIF_VERDICTS.get(case, "decoded")


def test_gif_lzw_streams_answer_as_cv2():
    """Seeded LZW streams at code sizes 2 to 11 — clear and end codes
    anywhere, table codes, KwKwK, codes past the table, frames short of
    their pixels or with codes past their last one, data after the end
    code — each get cv2's verdict and pixels (cv2's lzwDecode: a byte at
    a time, an end code resets and goes on, codes past the frame are
    counted unchecked and a further byte fails)."""
    rng = np.random.default_rng(33)
    gct = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
    verdicts = {"decoded": 0, "none": 0}
    for _ in range(400):
        size = int(rng.choice([2, 3, 4, 8, 11]))
        w, h = int(rng.integers(1, 9)), int(rng.integers(1, 5))
        clear = 1 << size
        codes = [clear] if rng.random() < 0.9 else []
        nxt, out, prev = clear + 2, 0, None
        while out < w * h + int(rng.integers(-2, 4)) and len(codes) < 200:
            r = rng.random()
            if r < 0.08:
                codes.append(clear + (r < 0.05))
                nxt, prev = clear + 2, None
                continue
            if r < 0.12:
                c = int(rng.integers(0, min(nxt + 3, 4096)))
            elif r < 0.5 and prev is not None:
                c = int(rng.integers(clear + 2, nxt + 1))
            else:
                c = int(rng.integers(0, min(clear, 16)))
            if c in (clear, clear + 1):
                continue
            codes.append(c)
            if c > nxt or (c == nxt and prev is None):
                break
            out += 1 if c < clear else 2
            nxt += prev is not None and nxt < 4096
            prev = c
        if rng.random() < 0.6:
            codes.append(clear + 1)
        if rng.random() < 0.3:
            codes += [int(v) for v in rng.integers(0, clear, 2)]
        data = _lzw_pack(codes, size)
        frame = (b"\x2c" + struct.pack("<4H", 0, 0, w, h) +
                 bytes([0x40 * (rng.random() < 0.3), size]) +
                 _sub_blocks(data))
        verdicts[assert_answers_as_cv2(_gif(w, h, gct, 0, [frame]))] += 1
    assert verdicts["decoded"] > 100 and verdicts["none"] > 50, verdicts


def _pam(w, h, depth, maxval, tupl, data, header=None):
    tupl = "" if tupl is None else f"TUPLTYPE {tupl}\n"
    return (header or (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL "
                       f"{maxval}\n{tupl}ENDHDR\n").encode()) + data


@pytest.mark.parametrize("tupl,depth", [
    ("BLACKANDWHITE", 1), ("GRAYSCALE", 1), ("RGB", 3),
    ("GRAYSCALE_ALPHA", 2), ("RGB_ALPHA", 4), (None, 1), (None, 3), ("", 1)])
@pytest.mark.parametrize("maxval", [1, 200, 255, 4095, 65535])
def test_pam_matches_cv2(tupl, depth, maxval):
    """cv2's PAMDecoder at IMREAD_COLOR: samples as they are (no maxval
    scaling, 16-bit ones by their high byte), three channels in file order,
    one replicated, MAXVAL 1 as packed bits of each row's first bytes. Above
    MAXVAL 1 the _ALPHA forms convert the first ceil(w / depth) pixels of a
    row (cv2 leaves the rest unwritten, so only those are held; the port's
    rest is 0), RGB_ALPHA in BGR order. 16-bit files without a TUPLTYPE
    give None, as in cv2."""
    rng = np.random.default_rng(maxval + depth)
    h, w = 5, 23
    v = rng.integers(0, maxval + 1, (h, w, depth))
    data = v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    blob = _pam(w, h, depth, maxval, tupl, data)
    if depth in (1, 3) or maxval == 1:
        assert_answers_as_cv2(blob)
        return
    want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    got = imcodec.imdecode(blob)
    if want is None:
        assert got is None
        return
    n = -(-w // depth)
    assert got.shape == want.shape == (h, w, 3)
    np.testing.assert_array_equal(got[:, :n], want[:, :n])
    assert not got[:, n:].any()


@pytest.mark.parametrize("case", [
    "comment", "carriage-return", "leading-zero", "hex", "negative-maxval",
    "maxval-65536", "repeated-width", "lowercase", "space-after-magic",
    "no-endhdr-field", "tupltype-unknown", "tupltype-needs-depth",
    "nul-in-identifier", "zero-width", "truncated"])
def test_pam_headers_answer_as_cv2(case):
    """Header lines as cv2's ReadPAMHeaderLine and ParseInt read them."""
    px = bytes(range(12))
    head = {
        "comment": b"P7\n# a comment\nWIDTH 4\nHEIGHT 3\nDEPTH 1\n"
                   b"MAXVAL 255\nENDHDR\n",
        "carriage-return": b"P7\rWIDTH 4\rHEIGHT 3\rDEPTH 1\rMAXVAL 255\r"
                           b"ENDHDR\r",
        "leading-zero": b"P7\nWIDTH 004\nHEIGHT 3\nDEPTH 1\nMAXVAL 255\n"
                        b"ENDHDR\n",
        "hex": b"P7\nWIDTH 0x4\nHEIGHT 3\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
        "negative-maxval": b"P7\nWIDTH 4\nHEIGHT 3\nDEPTH 1\nMAXVAL -1\n"
                           b"ENDHDR\n",
        "maxval-65536": b"P7\nWIDTH 4\nHEIGHT 3\nDEPTH 1\nMAXVAL 65536\n"
                        b"ENDHDR\n",
        "repeated-width": b"P7\nWIDTH 4\nWIDTH 4\nHEIGHT 3\nDEPTH 1\n"
                          b"MAXVAL 255\nENDHDR\n",
        "lowercase": b"P7\nwidth 4\nHEIGHT 3\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
        "space-after-magic": b"P7 \nWIDTH 4\nHEIGHT 3\nDEPTH 1\nMAXVAL 255\n"
                             b"ENDHDR\n",
        "no-endhdr-field": b"P7\nWIDTH 4\nHEIGHT 3\nMAXVAL 255\nENDHDR\n",
        "tupltype-unknown": b"P7\nWIDTH 4\nHEIGHT 3\nDEPTH 1\nMAXVAL 255\n"
                            b"TUPLTYPE GREY\nENDHDR\n",
        "tupltype-needs-depth": b"P7\nWIDTH 4\nHEIGHT 3\nDEPTH 1\n"
                                b"MAXVAL 255\nTUPLTYPE RGB\nENDHDR\n",
        "nul-in-identifier": b"P7\nWIDTH 4\nHEIGHT\x003\nDEPTH 1\n"
                             b"MAXVAL 255\nENDHDR\n",
        "zero-width": b"P7\nWIDTH 0\nHEIGHT 3\nDEPTH 1\nMAXVAL 255\n"
                      b"ENDHDR\n",
        "truncated": b"P7\nWIDTH 4\nHEIGHT 3\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
    }[case]
    assert_answers_as_cv2(head + (px[:-1] if case == "truncated" else px))


def _pfm(v, scale, grey=False):
    h, w = v.shape[:2]
    body = v[::-1].astype("<f4" if scale < 0 else ">f4").tobytes()
    return (b"Pf" if grey else b"PF") + f"\n{w} {h}\n{scale}\n".encode() + \
        body


@pytest.mark.parametrize("grey", [False, True])
@pytest.mark.parametrize("scale", [-1.0, 1.0, -0.25, 3.5])
def test_pfm_matches_cv2(grey, scale):
    """cv2's PFMDecoder: bottom-up rows, the scale's sign for the byte
    order, samples divided by |scale| in float32, then convertTo(CV_8U) —
    nearest even, saturated, NaN, infinities and |v| >= 2^31 to 0. A grey
    "Pf" decodes to (H, W), as cv2 gives it."""
    rng = np.random.default_rng(int(abs(scale) * 8) + grey)
    v = (rng.standard_normal((7, 11, 1 if grey else 3)) * 150 + 120)
    v = v.astype(np.float32)
    v.flat[:9] = [np.nan, np.inf, -np.inf, 254.5, 255.5, 0.5, 1.5, 2.0 ** 31,
                  2.0 ** 31 - 128]
    blob = _pfm(v[:, :, 0] if grey else v, scale, grey)
    assert assert_answers_as_cv2(blob) == "decoded"
    assert imcodec.imdecode(blob).ndim == (2 if grey else 3)


@pytest.mark.parametrize("case", [
    "space-after-magic", "two-spaces", "scale-zero", "scale-text",
    "byte-over-127", "zero-width", "truncated", "trailing-bytes"])
def test_pfm_headers_answer_as_cv2(case):
    """PFM headers as cv2 reads them (a word ends at one white-space byte;
    atoi / atof; a zero scale fails; a side <= 0 raises)."""
    body = np.arange(6, dtype="<f4").tobytes()
    blob = {
        "space-after-magic": b"Pf \n3 2\n-1\n" + body,
        "two-spaces": b"Pf\n3  2\n-1\n" + body,
        "scale-zero": b"Pf\n3 2\n0\n" + body,
        "scale-text": b"Pf\n3 2\n-1.0e0x\n" + body,
        "byte-over-127": b"Pf\n3 2\n-1\xff\n" + body,
        "zero-width": b"Pf\n0 2\n-1\n" + body,
        "truncated": b"Pf\n3 2\n-1\n" + body[:-1],
        "trailing-bytes": b"Pf\n3 2\n-1\n" + body + b"tail",
    }[case]
    assert_answers_as_cv2(blob)


def _ras(w, h, depth, kind, maptype, cmap, rows):
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(rows), kind,
                       maptype, len(cmap)) + cmap + rows


@pytest.mark.parametrize("depth", [1, 8, 24, 32])
@pytest.mark.parametrize("colours", ["none", "map", "short-map", "grey-map"])
@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_sun_raster_matches_cv2(depth, colours, kind):
    """cv2's SunRasterDecoder: types old (0) and standard (1) at depths 1
    and 8 (a grey ramp, or a colour map of up to 2^depth entries in R, G,
    B planes, missing entries black), 24 (B, G, R) and 32 (X, B, G, R),
    rows padded to 16 bits. cv2 5.0 reads no byte-encoded (2, RLE) or
    RGB-format (3) raster, no colour map on 24 or 32 bits and none longer
    than 2^depth entries: None."""
    rng = np.random.default_rng(depth * 16 + kind)
    w, h = 13, 5
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    rows = rng.integers(0, 256, pitch * h).astype(np.uint8).tobytes()
    n = {"none": 0, "map": 1 << min(depth, 8), "short-map": 3,
         "grey-map": 1 << min(depth, 8)}[colours]
    cmap = rng.integers(0, 256, (3, n)).astype(np.uint8)
    if colours == "grey-map":
        cmap[:] = cmap[0]
    blob = _ras(w, h, depth, kind, int(n > 0), cmap.tobytes(), rows)
    verdict = assert_answers_as_cv2(blob)
    assert verdict == ("decoded" if kind < 2 and (
        n == 0 or (depth <= 8 and n <= 1 << depth)) else "none")


def _hdr(h, w, pixels, header=b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"):
    return header + f"-Y {h} +X {w}\n".encode() + pixels


@pytest.mark.parametrize("case", [
    "cv2-rle", "cv2-rle-bright", "flat", "flat-narrow", "rle-then-flat",
    "rgbe-magic", "gamma-line", "xyze", "plus-y", "run-too-long",
    "wrong-scanline-width", "truncated"])
def test_hdr_matches_cv2(case):
    """cv2's HdrDecoder (rgbe.c): the header lines, flat pixels and
    new-style RLE scanlines (flat where the width is under 8 or a
    scanline does not start 2 2), r, g, b times 2^(e - 136) and
    convertTo(CV_8U, 255) — so a pixel past 2^31 / 255 gives 0."""
    rng = np.random.default_rng(41)
    img = rng.random((6, 21, 3)).astype(np.float32)
    img[:, :10] = img[0, 0]
    px = rng.integers(0, 256, (6, 21, 4)).astype(np.uint8)
    px[..., 3] = rng.integers(120, 140, (6, 21))
    bright = (img * 1e9).astype(np.float32)
    rle = bytes(cv2.imencode(".hdr", img)[1])
    head = rle.index(b"+X 21\n") + 6
    scan = _hdr(6, 21, rle[head:])
    blob = {
        "cv2-rle": rle,
        "cv2-rle-bright": bytes(cv2.imencode(".hdr", bright)[1]),
        "flat": _hdr(6, 21, px.tobytes()),
        "flat-narrow": _hdr(6, 5, px[:, :5].tobytes()),
        "rle-then-flat": _hdr(6, 21, rle[head:head + rle[head:].index(
            b"\x02\x02\x00\x15", 4)] + px[1:].tobytes()),
        "rgbe-magic": b"#?RGBE" + scan[10:],
        "gamma-line": scan.replace(b"FORMAT", b"GAMMA=1.0\nFORMAT", 1),
        "xyze": scan.replace(b"rgbe", b"xyze", 1),
        "plus-y": scan.replace(b"-Y 6", b"+Y 6", 1),
        "run-too-long": _hdr(1, 21, b"\x02\x02\x00\x15\xff\x01"),
        "wrong-scanline-width": _hdr(6, 21, b"\x02\x02\x00\x16" +
                                     rle[head + 4:]),
        "truncated": rle[:-3],
    }[case]
    verdict = assert_answers_as_cv2(blob)
    assert (verdict == "decoded") == (case in (
        "cv2-rle", "cv2-rle-bright", "flat", "flat-narrow", "rle-then-flat",
        "rgbe-magic", "gamma-line"))


_SAMPLES = Path(__file__).resolve().parents[1] / "onnxocr_tpu_torch" / \
    "assets" / "samples"


def test_codec_samples_match_cv2():
    """The eighteen committed samples (an animated, interlaced GIF with
    transparency, a 16-bit RGB PAM, a little-endian PFM, an 8-bit Sun
    raster with a colour map, an RLE HDR, a reversible JP2, an
    irreversible tiled JPEG 2000 codestream, an irreversible JP2 of a
    1280 x 960 corpus page and that page as sequential and progressive
    arithmetic-coded JPEGs, as Group 4, as JPEG-in-TIFF and as planar
    YCbCr JPEG-in-TIFF; a CMYK LZW TIFF, a T.4 2D TIFF with FillOrder 2,
    a damaged LZW TIFF and lossless JPEGs in one scan and in a scan a
    component of small corpus pages) decode to cv2's decode here and to
    the shape and sha256 recorded beside them, which the chip smoke checks
    on a machine without cv2."""
    import hashlib
    import json
    recorded = json.loads((_SAMPLES / "codec_samples.json").read_text())
    assert sorted(Path(n).suffix for n in recorded) == [
        ".gif", ".hdr", ".j2k", ".jp2", ".jp2", ".jpg", ".jpg", ".jpg",
        ".jpg", ".pam", ".pfm", ".ras", ".tif", ".tif", ".tif", ".tif",
        ".tif", ".tif"]
    for name, want in recorded.items():
        blob = (_SAMPLES / name).read_bytes()
        assert_decodes_as_cv2(blob)
        got = imcodec.imdecode(blob)
        assert list(got.shape) == want["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]


@pytest.mark.parametrize("name", [
    "sample_anim.gif", "sample_rgb16.pam", "sample.pfm", "sample_cmap8.ras",
    "sample_rle.hdr"])
def test_new_formats_truncations_and_flips_answer_as_cv2(name):
    """Each sample cut at 40 offsets, and 60 seeded mutants with 1-3
    bytes overwritten or bits flipped: cv2's verdict (None for every
    truncation but the HDR's and PFM's trailing bytes), and its pixels
    where it decodes."""
    blob = (_SAMPLES / name).read_bytes()
    rng = np.random.default_rng(len(blob))
    cuts = sorted(set(np.linspace(1, len(blob) - 1, 40).astype(int)))
    verdicts = [assert_answers_as_cv2(blob[:k]) for k in cuts]
    assert verdicts.count("none") >= len(cuts) - 2
    for _ in range(60):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, len(b)))
            b[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 else \
                b[i] ^ (1 << int(rng.integers(0, 8)))
        assert_answers_as_cv2(bytes(b))


_DECODE_ANY_MUTANTS = _DECODE_MUTANTS.replace(
    "img.ndim == 3 and img.shape[2] == 3", "img.ndim in (2, 3)")


def test_new_format_mutants_never_crash(tmp_path):
    """Seeded mutants of the five samples and of hand-built GIF, PAM, PFM,
    Sun raster and HDR files decode to an image, None or a ValueError in
    a build with AddressSanitizer (a fault ends the process)."""
    import pickle
    import subprocess
    import sys
    repo = Path(__file__).resolve().parents[1]
    seeds = [(_SAMPLES / n).read_bytes() for n in sorted(
        os.listdir(_SAMPLES)) if n.endswith((".gif", ".pam", ".pfm", ".ras",
                                             ".hdr"))]
    seeds += list(_gif_cases().values())[:8]
    rng = np.random.default_rng(51)
    seeds += [_hdr(2, 9, b"\x02\x02\x00\x09" + bytes([0x89, 5]) * 4),
              _pfm(np.ones((3, 4), np.float32), -1.0, grey=True),
              _ras(9, 3, 1, 1, 0, b"", bytes(12)),
              _pam(5, 2, 2, 255, "GRAYSCALE_ALPHA", bytes(20))]
    mutants = [_mutant(blob, rng) for blob in seeds for _ in range(40)]
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
        [sys.executable, "-c", _DECODE_ANY_MUTANTS, str(lib),
         str(tmp_path / "mutants.pkl")], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    counts = eval(proc.stdout.strip().splitlines()[-1])
    assert sum(counts.values()) == len(mutants)
    assert counts["decoded"] and counts["none"], counts

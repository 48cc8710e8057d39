"""The image codec of the service and the crop writer, for a machine without
cv2 or PIL: counterparts of `cv2.imdecode(buf, cv2.IMREAD_COLOR)`, of
`cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, q])` and of the pixels
`cv2.imwrite` writes to a PNG (`imencode_png`).

`imdecode` reads PNG (every colour type and bit depth, Adam7 interlace),
JPEG (baseline and progressive, Huffman or arithmetic coding, 8-bit, 1,
3 or 4 (CMYK, YCCK) components, any integral sampling factors, restart
intervals, the EXIF orientation; a sequential file streams row by row), BMP (1-, 4- and 8-bit
palettes, RLE8 and RLE4, 16-bit 5-5-5 and 5-6-5, 24- and 32-bit with or
without bit-field masks, bottom-up and top-down, the OS/2 core header too),
baseline TIFF (the first IFD: none, PackBits, LZW, Deflate; predictor 2;
strips, tiles, planar; 1, 8, 16 bits; grey, RGB(A), palette; the
Orientation tag), Netpbm P1–P6, PAM (P7: BLACKANDWHITE, GRAYSCALE, RGB and
their _ALPHA forms cv2 knows, 8 and 16 bits), PFM (either byte order,
bottom-up rows), GIF (LZW, global and local tables, interlace; an
animation's first frame on the logical screen, transparency kept as the
background shows through), Sun raster (depths 1, 8, 24, 32, the colour
map) and Radiance HDR (flat and RLE RGBE), WebP (lossy VP8, lossless
VP8L, the VP8X container with alpha, which is dropped; an animation's first
frame on its zeroed canvas, as cv2 5.0 returns it) and JPEG 2000 (the JP2
box file with its colour, palette, component-mapping and channel-definition
boxes, and the bare codestream; every Part 1 coding option; what cv2 5.0
computes through OpenJPEG 2.5) into (H, W, 3) uint8 BGR — a grey PFM
("Pf") into (H, W), as cv2 gives it — and gives None where cv2 gives
None: bytes of another format (AVIF, ...), 12-bit, lossless or
hierarchical JPEGs, BMPs and TIFFs cv2 reads that this reader does not (other
16-bit masks, other compressions, CMYK, YCbCr, JPEG-in-TIFF), the Sun
raster types cv2 5.0 refuses itself (byte-encoded, RGB-format), the JPEG
2000 files cv2 5.0 refuses (signed or subsampled components, a largest
precision below 8, an image origin other than 0, too few components for
the colour space, CMYK or e-sYCC), HTJ2K code-blocks, truncated or
corrupt files, and sides longer than libpng or libjpeg reads. `jpeg_pil_rgb` is the PDF rasteriser's other JPEG reading,
PIL's `Image.open(...).convert('RGB')`: the stored orientation, and
Adobe's inverted CMYK through Pillow's cmyk2rgb. As IMREAD_COLOR does, it
drops alpha, replicates grey, reduces 16-bit samples to their high byte,
converts float samples by cvRound and saturation, and applies the EXIF
orientation (a JPEG's APP1, a PNG's eXIf chunk).

The pixel work is C++ (`csrc/host/imcodec.cc`: PNG unfiltering, the JPEG
decoder and encoder, written to compute what libjpeg-turbo computes at
cv2's settings, TIFF's LZW and PackBits, Netpbm's ASCII numbers and PFM's
header words, the GIF decoder and the Radiance HDR decoder, written to
compute what cv2 5.0's own decoders compute, the WebP decoder, written to
compute what libwebp computes; the JPEG 2000 decoder is
`csrc/host/jpeg2000.cc`, written to compute what OpenJPEG 2.5 computes
and decoding one tile at a time), built with g++ at first use into
`build/host/` like the DB postprocess library (`ops/native.py`); zlib
inflates PNG streams, and numpy lays out the samples of the uncompressed
formats (BMP, TIFF strips, Netpbm, PAM, PFM, Sun raster). There is no
fallback: where the library cannot be built, every call raises.
"""
from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "imcodec.cc"
JP2_SOURCE = SOURCE.with_name("jpeg2000.cc")

_LIB: Optional[ctypes.CDLL] = None
_JP2_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)
_LL = ctypes.c_longlong
_SIGNATURES = {
    "ocr_png_unpack": (ctypes.c_int, [
        _U8P, _LL, ctypes.c_int, ctypes.c_int,     # raw, bytes, w, h
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # depth, channels, interl.
        _U8P]),                  # out (h, w, 3) BGR, or (h, w, channels)
    "ocr_jpeg_size": (ctypes.c_int, [_U8P, _LL, _IP, _IP]),
    "ocr_jpeg_decode": (ctypes.c_int, [
        _U8P, _LL, ctypes.c_int, ctypes.c_int,     # buf, bytes, h, w
        _U8P]),                                    # out BGR
    "ocr_jpeg_decode_native": (ctypes.c_int, [
        _U8P, _LL, ctypes.c_int, ctypes.c_int,     # buf, bytes, h, w
        _U8P]),                                    # out h * w * ncomp
    "ocr_jpeg_encode": (_LL, [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bgr, h, w, quality
        _U8P, _LL]),                                     # out, capacity
    "ocr_tiff_lzw": (_LL, [_U8P, _LL, _U8P, _LL]),   # in, bytes, out, need
    "ocr_tiff_packbits": (_LL, [_U8P, _LL, _U8P, _LL]),
    "ocr_pxm_header": (ctypes.c_int, [               # buf, bytes, pos, n,
        _U8P, _LL, ctypes.POINTER(_LL), _LL, _IP]),  # out int32
    "ocr_pxm_samples": (ctypes.c_int, [              # buf, bytes, pos, n,
        _U8P, _LL, ctypes.POINTER(_LL), _LL, ctypes.c_int,  # single,
        ctypes.POINTER(ctypes.c_uint16)]),                  # out uint16
    "ocr_webp_info": (ctypes.c_int, [_U8P, _LL, _IP, _IP]),  # buf, bytes, w, h
    "ocr_webp_decode": (ctypes.c_int, [
        _U8P, _LL, ctypes.c_int, ctypes.c_int,     # buf, bytes, h, w
        _U8P]),                                    # out BGR
    "ocr_gif_info": (ctypes.c_int, [_U8P, _LL, _IP, _IP]),   # buf, bytes, w, h
    "ocr_gif_decode": (ctypes.c_int, [
        _U8P, _LL, ctypes.c_int, ctypes.c_int,     # buf, bytes, h, w
        _U8P]),                                    # out BGR
    "ocr_pfm_header": (ctypes.c_int, [               # buf, bytes, w, h,
        _U8P, _LL, _IP, _IP, ctypes.POINTER(ctypes.c_double),  # scale,
        ctypes.POINTER(_LL)]),                                  # pos
    "ocr_hdr_info": (ctypes.c_int, [                 # buf, bytes, w, h, pos
        _U8P, _LL, _IP, _IP, ctypes.POINTER(_LL)]),
    "ocr_hdr_decode": (ctypes.c_int, [
        _U8P, _LL, _LL, ctypes.c_int, ctypes.c_int,  # buf, bytes, pos, h, w
        _U8P]),                                      # out BGR
}

_JP2_SIGNATURES = {
    "ocr_jp2_info": (ctypes.c_int, [_U8P, _LL, _IP, _IP]),  # buf, bytes, w, h
    "ocr_jp2_decode": (ctypes.c_int, [
        _U8P, _LL, ctypes.c_int, ctypes.c_int,     # buf, bytes, h, w
        _U8P]),                                    # out BGR
}

# Sizes are checked before anything is allocated. libpng and libjpeg refuse
# a longer side (PNG_USER_WIDTH_MAX / _HEIGHT_MAX, JPEG_MAX_DIMENSION): cv2
# gives None. cv2's validateInputImageSize refuses a longer side or more
# pixels at its defaults (CV_IO_MAX_IMAGE_WIDTH / _HEIGHT / _PIXELS): cv2
# raises.
FORMAT_MAX_SIDE = {"png": 1_000_000, "jpeg": 65500}
MAX_SIDE = 1 << 20
MAX_PIXELS = 1 << 30

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type → (channels, allowed bit depths)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
              3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
_PNG_CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")


class _Unreadable(ValueError):
    """Bytes that cv2.imdecode would not decode either."""


def _load(source: Path, stem: str, signatures) -> ctypes.CDLL:
    loaded = ctypes.CDLL(str(native.build(source, stem)))
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(loaded, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return loaded


def lib() -> ctypes.CDLL:
    """The loaded codec library, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _load(SOURCE, "libocrimcodec", _SIGNATURES)
    return _LIB


def jp2_lib() -> ctypes.CDLL:
    """The loaded JPEG 2000 library, built first if needed."""
    global _JP2_LIB
    with _LOCK:
        if _JP2_LIB is None:
            _JP2_LIB = _load(JP2_SOURCE, "libocrjp2", _JP2_SIGNATURES)
    return _JP2_LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


# ------------------------------------------------------------------ PNG
def _png(buf: bytes) -> np.ndarray:
    pos, hdr, palette, idat, orientation = 8, None, None, [], 1
    while True:
        if pos + 8 > len(buf):
            raise _Unreadable("PNG: no IEND chunk")
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + n]
        if pos + 12 + n > len(buf):
            raise _Unreadable("PNG: truncated chunk")
        crc, = struct.unpack(">I", buf[pos + 8 + n:pos + 12 + n])
        if kind in _PNG_CRITICAL and zlib.crc32(kind + body) != crc:
            raise _Unreadable(f"PNG: bad CRC on {kind!r}")
        pos += 12 + n
        if hdr is None and kind != b"IHDR":
            raise _Unreadable("PNG: IHDR is not first")
        if kind == b"IHDR":
            if len(body) != 13:
                raise _Unreadable("PNG: bad IHDR")
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3],
                                    np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            orientation = _tiff_orientation(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, comp, filt, interlace = hdr
    if ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][1] or \
            comp or filt or interlace > 1 or not w or not h:
        raise _Unreadable("PNG: bad IHDR values")
    _check_size("png", w, h)
    if ctype == 3 and palette is None:
        raise _Unreadable("PNG: palette image without PLTE")
    channels = _PNG_TYPES[ctype][0]
    # inflate no more than the image holds: a stream that inflates further
    # (a zip bomb among them) is cut there, as libpng stops reading; one
    # that ends early is libpng's "Not enough image data"
    need = _png_raw_size(w, h, depth * channels, interlace)
    inflater = zlib.decompressobj()
    raw = inflater.decompress(b"".join(idat), need + 1)
    if len(raw) <= need and not inflater.eof:
        raise _Unreadable("PNG: truncated image data")
    raw = np.frombuffer(raw, np.uint8, min(len(raw), need))
    samples = np.empty((h, w, 3 if channels >= 3 else channels), np.uint8)
    rc = lib().ocr_png_unpack(_ptr(raw), raw.size, w, h, depth, channels,
                              interlace, _ptr(samples))
    if rc != 0:
        raise _Unreadable("PNG: short image data" if rc == -1
                          else "PNG: bad filter type")
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)     # unset entries are black
        table[:min(len(palette), 256)] = palette[:256]
        bgr = table[samples[:, :, 0]][:, :, ::-1]
    elif channels <= 2:                          # grey (+ alpha)
        grey = samples[:, :, 0]
        if depth < 8:
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        bgr = np.repeat(grey[:, :, None], 3, axis=2)
    else:
        bgr = samples                            # BGR from the library
    return _oriented(bgr, orientation)


def _png_raw_size(w: int, h: int, bits_pp: int, interlace: int) -> int:
    """Bytes of the inflated image data: each row of each pass (all seven
    of Adam7 when interlaced) with its filter byte."""
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
              (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)) if interlace \
        else ((0, 0, 1, 1),)
    total = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            total += ph * (1 + (pw * bits_pp + 7) // 8)
    return total


def _tiff_orientation(tiff: bytes) -> int:
    """The orientation tag of IFD0 of EXIF data (a PNG's eXIf chunk, a
    JPEG's APP1 segment), 1 when absent."""
    if tiff[:6] == b"Exif\0\0":
        tiff = tiff[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None or len(tiff) < 8:
        return 1
    magic, ifd = struct.unpack(order + "HI", tiff[2:8])
    if magic != 42 or ifd + 2 > len(tiff):
        return 1
    count, = struct.unpack(order + "H", tiff[ifd:ifd + 2])
    for e in range(ifd + 2, min(ifd + 2 + 12 * count, len(tiff) - 11), 12):
        tag, = struct.unpack(order + "H", tiff[e:e + 2])
        if tag == 0x0112:
            return struct.unpack(order + "H", tiff[e + 8:e + 10])[0]
    return 1


# ----------------------------------------------------------------- JPEG
def _oriented(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ExifTransform for the EXIF orientation tag."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
        orientation = {5: 1, 6: 2, 7: 3, 8: 4}[orientation]
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    return np.ascontiguousarray(img)


def _jpeg(buf: bytes) -> np.ndarray:
    data = np.frombuffer(buf, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    codec = lib()
    if codec.ocr_jpeg_size(_ptr(data), data.size, ctypes.byref(h),
                           ctypes.byref(w)) != 0 or not h.value or \
            not w.value:
        raise _Unreadable("JPEG: no frame header")
    _check_size("jpeg", w.value, h.value)
    out = np.empty((h.value, w.value, 3), np.uint8)
    if codec.ocr_jpeg_decode(_ptr(data), data.size, h.value, w.value,
                             _ptr(out)) != 0:
        raise _Unreadable("JPEG: not decoded")
    return _oriented(out, _jpeg_orientation(buf))


def jpeg_native(buf: bytes) -> Optional[np.ndarray]:
    """A JPEG's samples in libjpeg's output space, in the stored
    orientation: (H, W, 1) grey, (H, W, 3) RGB or (H, W, 4) CMYK (as
    stored: Adobe files hold it inverted); None where this decoder does
    not read the file."""
    data = np.frombuffer(bytes(buf), np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    codec = lib()
    if codec.ocr_jpeg_size(_ptr(data), data.size, ctypes.byref(h),
                           ctypes.byref(w)) != 0 or not h.value or \
            not w.value or h.value * w.value > MAX_PIXELS:
        return None
    out = np.empty(h.value * w.value * 4, np.uint8)
    nc = codec.ocr_jpeg_decode_native(_ptr(data), data.size, h.value,
                                      w.value, _ptr(out))
    if nc <= 0:
        return None
    return out[:h.value * w.value * nc].reshape(h.value, w.value, nc)


def jpeg_pil_rgb(buf: bytes) -> Optional[np.ndarray]:
    """(H, W, 3) uint8 RGB as `Image.open(BytesIO(buf)).convert('RGB')`
    gives it for a JPEG: grey replicated, RGB as decoded, CMYK read as
    Adobe's inverted CMYK ("CMYK;I") and converted by Pillow's cmyk2rgb
    (c' = (255 - k) - (c (255 - k)) / 255, rounded as MULDIV255); None
    where this decoder does not read the file."""
    px = jpeg_native(buf)
    if px is None:
        return None
    if px.shape[2] == 1:
        return np.repeat(px, 3, axis=2)
    if px.shape[2] == 3:
        return px
    inv = 255 - px.astype(np.int32)
    nk = 255 - inv[:, :, 3:4]
    t = inv[:, :, :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _jpeg_orientation(buf: bytes) -> int:
    """The orientation tag of the first EXIF APP1 segment before the first
    scan (the markers libjpeg has read when cv2 looks), 1 when absent."""
    pos = 2
    while pos + 4 <= len(buf):
        while pos < len(buf) and buf[pos] != 0xFF:
            pos += 1
        while pos < len(buf) and buf[pos] == 0xFF:
            pos += 1
        if pos + 3 > len(buf):
            break
        marker = buf[pos]
        pos += 1
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            continue
        if marker in (0xD9, 0xDA):
            break
        n, = struct.unpack(">H", buf[pos:pos + 2])
        if marker == 0xE1 and buf[pos + 2:pos + 8] == b"Exif\0\0":
            return _tiff_orientation(buf[pos + 2:pos + n])
        pos += n
    return 1


# ------------------------------------------------------------------ BMP
def _u32(buf: bytes, pos: int) -> int:
    if pos + 4 > len(buf):
        raise _Unreadable("BMP: truncated header")
    return struct.unpack("<I", buf[pos:pos + 4])[0]


def _bmp(buf: bytes) -> np.ndarray:
    """cv2's BmpDecoder at IMREAD_COLOR: a BITMAPINFOHEADER or a later one
    (36 bytes or more) or the 12-byte OS/2 core header; 1-, 4- and 8-bit
    palettes (entries past the palette's count are black, as cv2's zeroed
    palette gives), RLE8 and RLE4, 16 bits as 5-5-5 (BI_RGB, or bit fields
    of 5-5-5 or 5-6-5 read after the header), 24 bits, and 32 bits (the
    header's R, G, B masks applied when it has them, 56 bytes or more, and
    none is 0; else the bytes as B, G, R)."""
    offset = _u32(buf, 10)
    dib = struct.unpack("<i", buf[14:18])[0]
    masks32 = None
    if dib >= 36:
        w, h = struct.unpack("<ii", buf[18:26])
        bits = _u32(buf, 26) >> 16
        comp = _u32(buf, 30)
        clrused = struct.unpack("<i", buf[46:50])[0]
        if comp > 3:
            raise _Unreadable(f"BMP: compression {comp}")
        ok = w > 0 and h != 0 and (
            (bits in (1, 4, 8, 24, 32) and comp == 0) or
            (bits in (16, 32) and comp in (0, 3)) or
            (bits == 4 and comp == 2) or (bits == 8 and comp == 1))
        if not ok:
            raise _Unreadable(f"BMP: {bits}-bit, compression {comp}")
        n_pal, entry = clrused or 1 << bits, 4
        if bits <= 8 and not 0 <= clrused <= 256:
            raise _Unreadable("BMP: palette count past 256")
        if bits == 16:
            if comp == 3:
                rgb = tuple(_u32(buf, 14 + dib + 4 * k) for k in range(3))
                if rgb not in ((0x7C00, 0x3E0, 0x1F), (0xF800, 0x7E0, 0x1F)):
                    raise _Unreadable("BMP: other 16-bit masks")
                bits = 15 if rgb[0] == 0x7C00 else 16
            else:
                bits = 15
        elif bits == 32 and comp == 3 and dib >= 56:
            masks32 = [_u32(buf, 54 + 4 * k) for k in range(3)]
            if 0 in masks32:
                masks32 = None
    elif dib == 12:
        w, h, _planes, bits = struct.unpack("<HHHH", buf[18:26])
        comp, n_pal, entry = 0, 1 << bits, 3
        if w == 0 or h == 0 or bits not in (1, 4, 8, 24, 32):
            raise _Unreadable(f"BMP: {bits}-bit core header")
    else:
        raise _Unreadable(f"BMP: a {dib}-byte header")
    palette = None
    if bits <= 8:                    # read with the header, as cv2 does
        pos = 14 + dib
        if pos + n_pal * entry > len(buf):
            raise _Unreadable("BMP: truncated palette")
        palette = np.zeros((256, 3), np.uint8)
        n = min(n_pal, 256)
        palette[:n] = np.frombuffer(buf, np.uint8, n * entry, pos).reshape(
            n, entry)[:, :3]
    rows = abs(h)
    _check_size("bmp", w, rows)
    if comp in (1, 2):
        px = palette[_bmp_rle(buf, offset, w, rows, comp == 2)]
    else:
        px = _bmp_rows(buf, offset, w, rows, bits, palette, masks32)
    return np.ascontiguousarray(px[::-1] if h > 0 else px)


def _bmp_rows(buf, offset, w, rows, bits, palette, masks32):
    """Uncompressed rows, in file order → (rows, w, 3) BGR."""
    stride = ((w * (16 if bits == 15 else bits) + 7) // 8 + 3) & ~3
    if offset + stride * rows > len(buf):
        raise _Unreadable("BMP: truncated pixel data")
    raw = np.frombuffer(buf, np.uint8, stride * rows, offset).reshape(
        rows, stride)
    if bits <= 8:
        idx = np.unpackbits(raw, axis=1) if bits == 1 else raw
        if bits == 4:
            idx = np.stack([raw >> 4, raw & 15], -1).reshape(rows, -1)
        return palette[idx[:, :w]]
    if bits in (15, 16):
        t = raw[:, :2 * w].view("<u2").astype(np.uint32)
        if bits == 15:
            chans = [t << 3, t >> 2, t >> 7]
            keep = (0xF8, 0xF8, 0xF8)
        else:
            chans = [t << 3, t >> 3, t >> 8]
            keep = (0xF8, 0xFC, 0xF8)
        return np.stack([(c & k).astype(np.uint8)
                         for c, k in zip(chans, keep)], -1)
    bpp = bits // 8
    px = raw[:, :w * bpp].reshape(rows, w, bpp)
    if masks32 is None:
        return px[:, :, :3]
    v = px.view("<u4")[:, :, 0]
    out = []
    for mask in masks32[::-1]:       # B, G, R from the R, G, B masks
        shift = (mask & -mask).bit_length() - 1
        # cv2 scales in float32 and truncates: 7 of a 3-bit field is 254
        scale = np.float32(255) / np.float32(mask >> shift)
        out.append(((v & np.uint32(mask)) >> np.uint32(shift)).astype(
            np.float32) * scale)
    return np.stack(out, -1).astype(np.uint8)


def _bmp_rle(buf, offset, w, rows, rle4):
    """RLE8 / RLE4 codes from `offset` → (rows, w) palette indices in file
    order, as cv2 decodes them: a run or an absolute block past the row's
    end, or codes running out before the last row, make the file
    unreadable; end of line, end of bitmap and delta skip pixels with
    palette entry 0 (a delta in RLE4 skips dx pixels only and an end of
    bitmap in RLE4 ends the row only, as cv2 does); an end of line just
    after a run that ended its row is no second line break in RLE8."""
    idx = np.zeros((rows, w), np.uint8)
    x = y = 0
    pos = offset
    end = len(buf)

    def fill(count):
        nonlocal x, y
        while True:
            n = min(count, w - x)
            x += n
            count -= n
            if x >= w:
                x = 0
                y += 1
                if y >= rows:
                    return
            if count <= 0:
                return

    line_end_flag = 0
    while True:
        if pos + 2 > end:
            raise _Unreadable("BMP: RLE codes run out")
        n, code = buf[pos], buf[pos + 1]
        pos += 2
        if n:                                    # a run
            if x + n > w:
                raise _Unreadable("BMP: RLE run past the row")
            if rle4:
                idx[y, x:x + n] = np.resize(
                    np.array([code >> 4, code & 15], np.uint8), n)
                x += n
                continue
            idx[y, x:x + n] = code
            prev = y
            fill(n)
            line_end_flag = y - prev
            if y >= rows:
                break
        elif code > 2:                           # an absolute block
            if x + code > w:
                raise _Unreadable("BMP: RLE block past the row")
            size = ((code + 1) // 2 + 1) & ~1 if rle4 else (code + 1) & ~1
            if pos + size > end:
                raise _Unreadable("BMP: RLE block past the data")
            raw = np.frombuffer(buf, np.uint8, size, pos)
            pos += size
            if rle4:
                raw = np.stack([raw >> 4, raw & 15], -1).reshape(-1)
            idx[y, x:x + code] = raw[:code]
            x += code
            line_end_flag = 0
        else:                                    # end of line / bitmap, delta
            skip, down = w - x, rows - y
            if code == 2:
                if pos + 2 > end:
                    raise _Unreadable("BMP: RLE delta past the data")
                skip, down = buf[pos], buf[pos + 1]
                pos += 2
            if rle4:
                fill(skip)
                if y >= rows:
                    break
                continue
            if code or not line_end_flag or x > 0:
                if code:
                    skip += down * w
                fill(skip)
            line_end_flag = 0
            if y >= rows:
                break
    return idx


# ----------------------------------------------------------------- TIFF
# the integer field types: BYTE, SHORT, LONG → struct code, bytes
_TIFF_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4)}


def _tiff_ifd(buf: bytes):
    """The first IFD of a classic TIFF → (byte order, {tag: tuple of
    values}) for the integer-typed tags."""
    order = {b"II": "<", b"MM": ">"}[buf[:2]]
    magic, ifd = struct.unpack(order + "HI", buf[2:8])
    if magic != 42:
        raise _Unreadable("TIFF: not a classic TIFF")
    count, = struct.unpack(order + "H", buf[ifd:ifd + 2])
    tags = {}
    for e in range(ifd + 2, ifd + 2 + 12 * count, 12):
        tag, typ, n, value = struct.unpack(order + "HHI4s", buf[e:e + 12])
        if typ not in _TIFF_TYPES:
            continue
        code, width = _TIFF_TYPES[typ]
        size = width * n
        if size <= 4:
            data = value[:size]
        else:
            off, = struct.unpack(order + "I", value)
            if off + size > len(buf):
                raise _Unreadable(f"TIFF: tag {tag} past the end")
            data = buf[off:off + size]
        tags[tag] = struct.unpack(f"{order}{n}{code}", data)
    return order, tags


def _tiff_chunk(buf: bytes, off: int, n: int, need: int, comp: int
                ) -> np.ndarray:
    """One strip or tile decompressed to exactly `need` bytes, as libtiff
    reads it (None, PackBits, LZW, Deflate)."""
    if n < 0 or off + n > len(buf):
        raise _Unreadable("TIFF: strip or tile past the end of the data")
    raw = np.frombuffer(buf, np.uint8, n, off)
    if comp == 1:
        if n < need:
            raise _Unreadable("TIFF: short strip")
        return raw[:need]
    if comp in (8, 32946):
        inflater = zlib.decompressobj()
        out = inflater.decompress(raw.tobytes(), need)
        if len(out) < need:
            raise _Unreadable("TIFF: short Deflate strip")
        return np.frombuffer(out, np.uint8)
    out = np.empty(need, np.uint8)
    fn = lib().ocr_tiff_lzw if comp == 5 else lib().ocr_tiff_packbits
    src = np.ascontiguousarray(raw)
    if fn(_ptr(src), n, _ptr(out), need) != need:
        raise _Unreadable("TIFF: bad or short LZW / PackBits data")
    return out


def _skew16(chunk: np.ndarray, dtype, predicted: bool, npix: int,
            per: int) -> np.ndarray:
    """A 16-bit grey tile cut by the right edge as libtiff's
    put16bitbwtile reads it: row r from byte r · (npix · 2 · per + tw −
    npix) of the decoded tile (host order, the predictor undone), the
    first npix pixels of each row kept (the rest is never read)."""
    rows, row_bytes = chunk.shape
    tw = row_bytes // (2 * per)
    v = chunk.view(dtype).astype(np.uint16).reshape(rows, tw, per)
    if predicted:
        v = np.cumsum(v, axis=1, dtype=np.uint16)
    flat = np.concatenate([v.astype("<u2").reshape(-1).view(np.uint8),
                           np.zeros(2, np.uint8)])
    step = npix * 2 * per + (tw - npix)
    out = np.zeros((rows, row_bytes), np.uint8)
    for r in range(rows):
        a = r * step
        part = flat[a:a + npix * 2 * per]
        out[r, :part.size] = part
    out = out.view("<u2").reshape(rows, tw, per)
    if predicted:                     # undone already: redo the differences
        out = np.diff(out, axis=1, prepend=np.zeros((rows, 1, per),
                                                     np.uint16))
    return out.astype(dtype).view(np.uint8).reshape(rows, row_bytes)


def _tiff(buf: bytes) -> np.ndarray:
    """cv2's TiffDecoder at IMREAD_COLOR, which reads through libtiff's
    TIFFReadRGBA*: the first IFD; compression none, PackBits, LZW or
    Deflate; predictor 2 (which libtiff undoes for LZW and Deflate only);
    strips or tiles; chunky or planar samples; 1, 8 or 16 bits (4 for a
    palette); grey (MinIsBlack, MinIsWhite), RGB with or without alpha and
    palette images. As TIFFReadRGBA converts them: 16-bit grey keeps its
    high byte and 16-bit colour (v + 128) / 257; an unassociated alpha is
    multiplied in ((c a + 127) / 255) and dropped; a colour map whose
    entries all lie below 256 is taken as 8-bit, else its high bytes. The
    Orientation tag is applied as cv2 applies it."""
    order, tags = _tiff_ifd(buf)

    def one(tag, default=None):
        v = tags.get(tag)
        return v[0] if v else default
    w, h = one(256, 0), one(257, 0)
    if not w or not h:
        raise _Unreadable("TIFF: no image size")
    _check_size("tiff", w, h)
    spp = one(277, 1)
    bps_all = tags.get(258, (1,))
    bps = bps_all[0]
    comp, photo = one(259, 1), one(262)
    planar, predictor = one(284, 1), one(317, 1)
    if any(b != bps for b in bps_all) or bps not in (1, 4, 8, 16) or \
            comp not in (1, 5, 8, 32773, 32946) or planar not in (1, 2) or \
            predictor not in (1, 2) or (predictor == 2 and bps == 1) or \
            one(339, 1) != 1 or not 1 <= spp <= 8 or one(266, 1) != 1:
        raise _Unreadable("TIFF: a layout TIFFReadRGBA does not take here")
    extra = tags.get(338, ())
    if photo in (0, 1):
        colour = 1
    elif photo == 2 and spp >= 3:
        colour = 3
    elif photo == 3 and spp == 1 and bps <= 8 and 320 in tags:
        colour = 1
    else:
        raise _Unreadable(f"TIFF: photometric {photo} is not read")
    if bps < 8 and (spp != 1 or predictor == 2 or
                    (bps == 4 and photo != 3)):
        # cv2's readHeader takes 4 bits for a palette only, 2 not at all
        raise _Unreadable("TIFF: packed samples cv2 does not read")
    tiled = 322 in tags
    if tiled:
        cw, ch = one(322, 0), one(323, 0)
        offsets, counts = tags.get(324, ()), tags.get(325, ())
    else:
        cw, ch = w, min(one(278, h), h)      # 0: libtiff's "Bad value"
        offsets, counts = tags.get(273, ()), tags.get(279, ())
    if not cw or not ch or cw * ch * spp * max(1, bps // 8) >= 1 << 30:
        # cv2: "TIFF tile size is too large: >= 1Gb"
        raise _Unreadable("TIFF: empty or oversized strips or tiles")
    across, down = -(-w // cw), -(-h // ch)
    planes = spp if planar == 2 else 1
    per = spp // planes                      # samples in one chunk
    if min(len(offsets), len(counts)) < across * down * planes:
        raise _Unreadable("TIFF: too few strip or tile offsets")
    n_chunks = across * down * planes
    if any(o + c > len(buf) for o, c in zip(offsets[:n_chunks],
                                             counts[:n_chunks])):
        # checked before the image is allocated
        raise _Unreadable("TIFF: strip or tile past the end of the data")
    row_bytes = (cw * per * bps + 7) // 8
    if tiled and comp == 1 and across * down * planes > 1:
        # cv2 5.0 refuses uncompressed tiles of most layouts (its libtiff's
        # "Invalid tile byte count") and reads others: not read here
        raise _Unreadable("TIFF: uncompressed tiles are not read")
    if photo == 3:
        n = 1 << bps
        cmap = np.asarray(tags[320], np.int64)
        if cmap.size < 3 * n:
            raise _Unreadable("TIFF: short colour map")
        cmap = cmap[:3 * n].reshape(3, n)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        lut = np.ascontiguousarray(cmap[::-1].T.astype(np.uint8))   # BGR
    elif colour == 1:                 # grey sample → its 8-bit value
        v = np.arange(1 << bps, dtype=np.uint32)
        if bps == 16:
            v = v >> 8
        elif bps < 8:                            # libtiff's x * 255 / range
            v = v * 255 // ((1 << bps) - 1)
        lut = (255 - v if photo == 0 else v).astype(np.uint8)[:, None]
    else:                             # 16-bit colour: (v + 128) / 257
        lut = ((np.arange(1 << 16, dtype=np.uint32) + 128) // 257).astype(
            np.uint8) if bps == 16 else None
    alpha = colour == 3 and spp > 3 and extra[:1] == (2,)
    # libtiff's put16bitbwtile steps a clipped tile's rows by the skew in
    # bytes, not in samples: rows after the first of a tile cut by the
    # right edge are read from there
    skewed = tiled and bps == 16 and colour == 1 and photo != 3
    predicted = predictor == 2 and comp in (5, 8, 32946)
    dtype = np.dtype(order + "u2") if bps == 16 else np.uint8
    # converted strip by strip (tile by tile), a band of rows at a time,
    # into the output, as TIFFReadRGBA* converts: only the output and each
    # plane's decoded chunk grow with the image
    band = max(1, (1 << 20) // (cw * spp))
    out = np.empty((h, w, 3), np.uint8)
    for ty in range(down):
        for tx in range(across):
            rows = ch if tiled else min(ch, h - ty * ch)
            npix = min(cw, w - tx * cw)
            chunks = []
            for p in range(planes):
                k = (p * down + ty) * across + tx
                chunk = _tiff_chunk(buf, offsets[k], counts[k],
                                    rows * row_bytes, comp).reshape(
                    rows, row_bytes)
                if skewed and npix < cw:
                    chunk = _skew16(chunk, dtype, predicted, npix, per)
                chunks.append(chunk)
            y0, x0 = ty * ch, tx * cw
            last = min(rows, h - y0)
            for b0 in range(0, last, band):
                b1 = min(b0 + band, last)
                px = np.concatenate([_tiff_samples(
                    c[b0:b1], bps, dtype, cw, per, predicted)[:, :npix]
                    for c in chunks], axis=2)
                out[y0 + b0:y0 + b1, x0:x0 + npix] = _tiff_bgr(
                    px, colour, lut, alpha)
    return _oriented(out, one(274, 1))


def _tiff_samples(rows: np.ndarray, bps: int, dtype, cw: int, per: int,
                  predicted: bool) -> np.ndarray:
    """Decoded rows of a strip or tile → (rows, cw, per) samples, the
    horizontal differencing undone (modular: libtiff's LZW and Deflate
    codecs undo it; none and PackBits ignore it)."""
    if bps < 8:
        bits = np.unpackbits(rows, axis=1)[:, :cw * per * bps]
        px = bits.reshape(len(rows), -1, bps) @ (
            1 << np.arange(bps - 1, -1, -1)).astype(np.uint8)
    else:
        px = rows.view(dtype).astype(np.uint16 if bps == 16 else np.uint8)
    px = px.reshape(len(rows), cw, per)
    return np.cumsum(px, axis=1, dtype=px.dtype) if predicted else px


def _tiff_bgr(px: np.ndarray, colour: int, lut, alpha: bool) -> np.ndarray:
    """(rows, n, spp) samples → (rows, n, 3) BGR as TIFFReadRGBA gives
    them: grey and palette through `lut`, 16-bit colour through `lut`
    too; an unassociated alpha multiplied in ((c a + 127) / 255, in
    uint16, which holds 255 · 255 + 127) and dropped."""
    if colour == 1:
        return lut[px[:, :, 0]] if lut.shape[1] == 3 else \
            np.broadcast_to(lut[px[:, :, 0]], px.shape[:2] + (3,))
    rgb = px[:, :, 2::-1]
    if lut is not None:
        rgb = lut[rgb]
    if alpha:
        a = px[:, :, 3:4] if lut is None else lut[px[:, :, 3:4]]
        rgb = (rgb.astype(np.uint16) * a + 127) // 255
    return rgb


# -------------------------------------------------------------- Netpbm
_SPACE = b" \t\n\v\f\r"


def _pxm(buf: bytes) -> np.ndarray:
    """cv2's PxMDecoder at IMREAD_COLOR for P1–P6: binary samples as they
    are (16-bit ones big-endian, their high byte; no maxval scaling),
    ASCII ones clipped to maxval and scaled v · 255 / maxval (16-bit ones
    kept, then their high byte), bilevel 1 black and 0 white. Numbers are
    read in C++ (`ocr_pxm_header`, `ocr_pxm_samples`: cv2's ReadNumber)."""
    kind = buf[1] - 48
    data = np.frombuffer(buf, np.uint8)
    pos = _LL(2)
    head = np.zeros(3, np.int32)
    if lib().ocr_pxm_header(_ptr(data), len(buf), ctypes.byref(pos),
                            2 if kind in (1, 4) else 3,
                            head.ctypes.data_as(_IP)):
        raise _Unreadable("PxM: bad header")
    w, h, maxval = (int(v) for v in head)
    maxval = 1 if kind in (1, 4) else maxval
    if maxval > 65535 or not w or not h or not maxval:
        raise _Unreadable("PxM: bad header")
    _check_size("pxm", w, h)
    nch = 3 if kind in (3, 6) else 1
    n = w * h * nch
    pos = pos.value
    if kind == 4:
        pitch = (w + 7) // 8
        if pos + pitch * h > len(buf):
            raise _Unreadable("PxM: short data")
        bits = np.unpackbits(data[pos:pos + pitch * h].reshape(h, pitch),
                             axis=1)[:, :w]
        v = (1 - bits) * np.uint8(255)
    elif kind in (5, 6):
        size = 2 if maxval > 255 else 1
        if pos + n * size > len(buf):
            raise _Unreadable("PxM: short data")
        v = np.frombuffer(buf, ">u2" if size == 2 else np.uint8, n, pos)
        if size == 2:
            v = (v >> 8).astype(np.uint8)
    else:
        if n > len(buf) - pos:        # a number takes a byte at least
            raise _Unreadable("PxM: short data")
        v = np.empty(n, np.uint16)
        at = _LL(pos)
        if lib().ocr_pxm_samples(_ptr(data), len(buf), ctypes.byref(at), n,
                                 kind == 1, v.ctypes.data_as(
                                     ctypes.POINTER(ctypes.c_uint16))):
            raise _Unreadable("PxM: bad or short ASCII data")
        if kind == 1:
            v = np.where(v != 0, 0, 255).astype(np.uint8)
        else:
            v = np.minimum(v, maxval)
            v = (v >> 8) if maxval > 255 else \
                v.astype(np.uint32) * 255 // maxval
            v = v.astype(np.uint8)
    v = np.asarray(v, np.uint8).reshape(h, w, nch)
    return np.ascontiguousarray(v[:, :, ::-1] if nch == 3 else
                                np.repeat(v, 3, axis=2))


def _check_size(fmt: str, w: int, h: int) -> None:
    side = FORMAT_MAX_SIDE.get(fmt)
    if side and (w > side or h > side):
        raise _Unreadable(f"{fmt}: a side of {max(w, h)} px is not read")
    if w > MAX_SIDE or h > MAX_SIDE or w * h > MAX_PIXELS:
        raise ValueError(f"a {w} x {h} image is larger than cv2.imdecode "
                         f"reads (validateInputImageSize)")


def _check_positive(w: int, h: int) -> None:
    """cv2's validateInputImageSize asserts a positive size: it raises."""
    if w <= 0 or h <= 0:
        raise ValueError(f"a {w} x {h} image (cv2.imdecode asserts a "
                         f"positive size)")
    _check_size("", w, h)


def _gif(buf: bytes) -> np.ndarray:
    """cv2's GifDecoder: the first frame on the logical screen (C++)."""
    data = np.frombuffer(buf, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    codec = lib()
    if codec.ocr_gif_info(_ptr(data), data.size, ctypes.byref(w),
                          ctypes.byref(h)) != 0:
        raise _Unreadable("GIF: not a GIF cv2 reads")
    _check_size("gif", w.value, h.value)
    out = np.empty((h.value, w.value, 3), np.uint8)
    if codec.ocr_gif_decode(_ptr(data), data.size, h.value, w.value,
                            _ptr(out)) != 0:
        raise _Unreadable("GIF: first frame not decoded")
    return out


# cv2's PAM tuple types (grfmt_pam.cpp `formats`) → the channels each needs
_PAM_TUPLTYPES = {b"": None, b"BLACKANDWHITE": 1, b"GRAYSCALE": 1,
                  b"GRAYSCALE_ALPHA": 2, b"RGB": 3, b"RGB_ALPHA": 4}
_PAM_FIELDS = (b"ENDHDR", b"HEIGHT", b"WIDTH", b"DEPTH", b"MAXVAL",
               b"TUPLTYPE")


def _pam_line(buf: bytes, pos: int):
    """One header line as cv2's ReadPAMHeaderLine reads it → (field or
    None for a comment, value, next position)."""
    def get(i):
        if i >= len(buf):
            raise _Unreadable("PAM: short header")
        return buf[i]
    c = get(pos)
    while c in _SPACE:
        pos += 1
        c = get(pos)
    if c == 35:                                       # '#'
        while c not in (10, 13):
            pos += 1
            c = get(pos)
        return None, b"", pos + 1
    start = pos
    while pos - start < 8 and c not in _SPACE:
        pos += 1
        c = get(pos)
    if c not in _SPACE:
        raise _Unreadable("PAM: identifier too long")
    field = buf[start:pos].split(b"\0", 1)[0]       # C strings
    if field not in _PAM_FIELDS:
        raise _Unreadable("PAM: unknown field")
    pos += 1
    if c in (10, 13):
        return field, b"", pos
    c = get(pos)
    while c in _SPACE:
        pos += 1
        c = get(pos)
    start = pos
    while pos - start < 255 and c not in (10, 13):
        pos += 1
        c = get(pos)
    if c not in (10, 13):
        raise _Unreadable("PAM: value too long")
    return field, buf[start:pos].rstrip(_SPACE).split(b"\0", 1)[0], pos + 1


def _pam_int(value: bytes) -> int:
    """cv2's ParseInt: an optional '-' and digits, nothing else."""
    neg = value[:1] == b"-"
    digits = value[1:] if neg else value
    if (neg and not digits[:1].isdigit()) or (digits and not digits.isdigit()):
        raise _Unreadable("PAM: not a number")
    v = int(digits or b"0")
    if v >= 0x7FFFFFFF:
        raise _Unreadable("PAM: number too large")
    return -v if neg else v


def _pam(buf: bytes) -> np.ndarray:
    """cv2's PAMDecoder at IMREAD_COLOR. Samples are taken as they are (no
    maxval scaling; 16-bit ones big-endian, their high byte). Three
    channels are copied in file order; one is replicated; MAXVAL 1 reads
    each row's first bytes as packed bits, 1 white (cv2's FillColorRow1);
    GRAYSCALE_ALPHA and RGB_ALPHA convert only the first ceil(w / depth)
    pixels of a row (the bound of cv2's basic_conversion is the width in
    samples), RGB_ALPHA to BGR. cv2 leaves the rest of such a row
    unwritten; here it is 0."""
    if buf[2] not in (10, 13):
        raise _Unreadable("PAM: bad magic")
    pos, seen, tupl = 3, {}, None
    while True:
        field, value, pos = _pam_line(buf, pos)
        if field is None:
            continue
        if field == b"ENDHDR":
            break
        if field == b"TUPLTYPE":
            if value not in _PAM_TUPLTYPES:
                raise _Unreadable("PAM: unknown TUPLTYPE")
            tupl = value
            continue
        if field in seen:
            raise _Unreadable("PAM: repeated field")
        seen[field] = _pam_int(value)
        if field == b"MAXVAL" and seen[field] > 65535:
            raise _Unreadable("PAM: MAXVAL > 65535")
    if len(seen) != 4:
        raise _Unreadable("PAM: missing field")
    w, h = seen[b"WIDTH"], seen[b"HEIGHT"]
    ch, maxval = seen[b"DEPTH"], seen[b"MAXVAL"]
    if tupl in (None, b""):
        if ch == 1 and maxval < 256:
            tupl = b"BLACKANDWHITE" if maxval == 1 else b"GRAYSCALE"
        elif ch == 3 and maxval < 256:
            tupl = b"RGB"
        else:
            raise _Unreadable("PAM: no TUPLTYPE for this DEPTH and MAXVAL")
    if ch != _PAM_TUPLTYPES[tupl] or not 1 <= ch <= 512:
        raise _Unreadable("PAM: DEPTH does not fit the TUPLTYPE")
    _check_positive(w, h)
    size = 2 if maxval > 255 else 1
    row = w * ch * size
    if pos + row * h > len(buf):
        raise _Unreadable("PAM: short data")
    rows = np.frombuffer(buf, np.uint8, row * h, pos).reshape(h, row)
    if maxval == 1:
        bits = np.unpackbits(rows[:, :(w + 7) // 8], axis=1)[:, :w]
        return np.repeat((bits * np.uint8(255))[:, :, None], 3, axis=2)
    px = rows.view(">u2").astype(np.uint16) >> 8 if size == 2 else rows
    px = px.astype(np.uint8).reshape(h, w, ch)
    if ch == 3:
        return np.ascontiguousarray(px)
    out = np.zeros((h, w, 3), np.uint8)
    n = -(-w // ch)
    first = px.reshape(h, w * ch)[:, :n * ch].reshape(h, n, ch)
    out[:, :n] = first[:, :, 2::-1] if ch == 4 else first[:, :, :1]
    return out


def _pfm(buf: bytes) -> np.ndarray:
    """cv2's PFMDecoder at IMREAD_COLOR: rows bottom-up, little-endian for
    a negative scale, divided by |scale| in float, then convertTo(CV_8U)
    (nearest even, saturated; NaN and |v| >= 2^31 give 0). "PF" gives BGR;
    "Pf" gives an (H, W) image, as cv2 does."""
    data = np.frombuffer(buf, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    scale, pos = ctypes.c_double(), _LL()
    if lib().ocr_pfm_header(_ptr(data), data.size, ctypes.byref(w),
                            ctypes.byref(h), ctypes.byref(scale),
                            ctypes.byref(pos)) != 0:
        raise _Unreadable("PFM: bad header")
    w, h, scale, pos = w.value, h.value, scale.value, pos.value
    _check_positive(w, h)
    ch = 3 if buf[1] == 70 else 1                    # 'F'
    if pos + w * h * ch * 4 > len(buf):
        raise _Unreadable("PFM: short data")
    if not abs(scale) > 0:
        raise _Unreadable("PFM: zero scale")
    v = np.frombuffer(buf, "<f4" if scale < 0 else ">f4", w * h * ch, pos)
    v = v.astype(np.float32).reshape(h, w, ch)[::-1]
    if ch == 3:
        v = v[:, :, ::-1]
    v = v * np.float32(1.0 / abs(scale))
    out = _float_to_u8(v)
    return np.ascontiguousarray(out[:, :, 0] if ch == 1 else out)


def _float_to_u8(v: np.ndarray) -> np.ndarray:
    """cv2's float32 → uint8 convertTo: cvRound (nearest even; NaN and
    |v| >= 2^31 give INT_MIN) then saturation."""
    with np.errstate(invalid="ignore"):
        r = np.rint(v)
        return np.clip(np.where(np.abs(r) < np.float32(2 ** 31), r, 0), 0,
                       255).astype(np.uint8)


_SUN_MAGIC = b"\x59\xa6\x6a\x95"


def _sun(buf: bytes) -> np.ndarray:
    """cv2's SunRasterDecoder: the old and standard types (0, 1) at depths
    1, 8 (a grey ramp, or the colour map: at most 2^depth entries, planes
    R, G, B, missing entries black), 24 (B, G, R) and 32 (X, B, G, R); rows
    padded to 16 bits. cv2 5.0 reads no other type: byte-encoded (RLE, 2)
    and RGB-format (3) rasters give None, as there."""
    if len(buf) < 32:
        raise _Unreadable("Sun raster: short header")
    _, w, h, depth, _, kind, maptype, maplen = struct.unpack(">8i", buf[:32])
    if w <= 0 or h <= 0 or depth not in (1, 8, 24, 32) or kind not in (0, 1):
        raise _Unreadable("Sun raster: not a layout cv2 reads")
    entries = 1 << depth if depth <= 8 else 0
    if maptype == 1 and 0 < maplen <= entries * 3:
        if 32 + maplen > len(buf):
            raise _Unreadable("Sun raster: short colour map")
        n = maplen // 3
        cmap = np.frombuffer(buf, np.uint8, 3 * n, 32).reshape(3, n)
        palette = np.zeros((entries, 3), np.uint8)
        palette[:n] = cmap[::-1].T
    elif maptype == 0 and maplen == 0:
        palette = None if depth > 8 else np.repeat(
            (np.arange(entries) * 255 // (entries - 1)).astype(
                np.uint8)[:, None], 3, axis=1)
    else:
        raise _Unreadable("Sun raster: colour map cv2 does not read")
    _check_size("sun", w, h)
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    pos = 32 + maplen
    if pos + pitch * h > len(buf):
        raise _Unreadable("Sun raster: short data")
    rows = np.frombuffer(buf, np.uint8, pitch * h, pos).reshape(h, pitch)
    if depth == 1:
        return palette[np.unpackbits(rows, axis=1)[:, :w]]
    if depth == 8:
        return palette[rows[:, :w]]
    return np.ascontiguousarray(rows[:, :w * 3].reshape(h, w, 3) if
                                depth == 24 else
                                rows[:, :w * 4].reshape(h, w, 4)[:, :, 1:])


def _hdr(buf: bytes) -> np.ndarray:
    """cv2's HdrDecoder (rgbe.c) at IMREAD_COLOR, in C++."""
    data = np.frombuffer(buf, np.uint8)
    w, h, pos = ctypes.c_int(), ctypes.c_int(), _LL()
    codec = lib()
    if codec.ocr_hdr_info(_ptr(data), data.size, ctypes.byref(w),
                          ctypes.byref(h), ctypes.byref(pos)) != 0:
        raise _Unreadable("HDR: bad header")
    if w.value <= 0 or h.value <= 0:
        raise _Unreadable("HDR: no pixels")
    _check_size("hdr", w.value, h.value)
    out = np.empty((h.value, w.value, 3), np.uint8)
    if codec.ocr_hdr_decode(_ptr(data), data.size, pos.value, h.value,
                            w.value, _ptr(out)) != 0:
        raise _Unreadable("HDR: bad pixel data")
    return out


def _webp(buf: bytes) -> np.ndarray:
    data = np.frombuffer(buf, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    codec = lib()
    if codec.ocr_webp_info(_ptr(data), data.size, ctypes.byref(w),
                           ctypes.byref(h)) != 0:
        raise _Unreadable("WebP: not a WebP cv2 reads")
    _check_size("webp", w.value, h.value)
    out = np.empty((h.value, w.value, 3), np.uint8)
    if codec.ocr_webp_decode(_ptr(data), data.size, h.value, w.value,
                             _ptr(out)) != 0:
        raise _Unreadable("WebP: not decoded")
    return out


JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"


def _jp2(buf: bytes) -> np.ndarray:
    """cv2's OpenJPEG decoder at IMREAD_COLOR (C++, tile by tile)."""
    data = np.frombuffer(buf, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    codec = jp2_lib()
    if codec.ocr_jp2_info(_ptr(data), data.size, ctypes.byref(w),
                          ctypes.byref(h)) != 0:
        raise _Unreadable("JPEG 2000: a header cv2 does not read")
    _check_size("jp2", w.value, h.value)
    out = np.empty((h.value, w.value, 3), np.uint8)
    if codec.ocr_jp2_decode(_ptr(data), data.size, h.value, w.value,
                            _ptr(out)) != 0:
        raise _Unreadable("JPEG 2000: not decoded")
    return out


def imdecode(buf) -> Optional[np.ndarray]:
    """Encoded image bytes of any format the module reads, JPEG 2000 (JP2
    or a bare codestream) included → (H, W, 3) uint8 BGR ((H, W) for a grey
    PFM, as cv2 gives it), or None where `cv2.imdecode(np.frombuffer(buf,
    np.uint8), cv2.IMREAD_COLOR)` gives None. Raises ValueError where cv2
    raises: an empty buffer, an image of more than MAX_SIDE px a side or
    MAX_PIXELS px in all, a PAM, PFM or GIF of a side <= 0."""
    buf = bytes(buf)
    if not buf:
        raise ValueError("an empty buffer (cv2.imdecode asserts !buf.empty())")
    try:
        if buf[:3] == b"\xff\xd8\xff":
            return _jpeg(buf)
        if buf[:8] == PNG_SIGNATURE:
            return _png(buf)
        if buf[:2] == b"BM":
            return _bmp(buf)
        if buf[:4] in (b"II*\0", b"MM\0*"):
            return _tiff(buf)
        if len(buf) >= 3 and buf[:1] == b"P" and 49 <= buf[1] <= 54 and \
                buf[2] in _SPACE:
            return _pxm(buf)
        if len(buf) >= 3 and buf[:1] == b"P" and buf[2] in _SPACE:
            if buf[1] == 55:                                      # '7'
                return _pam(buf)
            if buf[1] in (70, 102):                               # 'F', 'f'
                return _pfm(buf)
        if buf[:3] == b"GIF":
            return _gif(buf)
        if buf[:4] == _SUN_MAGIC:
            return _sun(buf)
        if buf[:6] == b"#?RGBE" or buf[:10] == b"#?RADIANCE":
            return _hdr(buf)
        if buf[:12] == JP2_SIGNATURE or buf[:4] == J2K_SIGNATURE:
            return _jp2(buf)
        # cv2 asks libwebp whether the first 32 bytes are a WebP: a RIFF
        # container, or a bare VP8 / VP8L stream
        return _webp(buf)
    except (_Unreadable, struct.error, zlib.error, KeyError, IndexError):
        return None
    return None


def imencode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 BGR (or (H, W) grey, written as BGR) → a baseline
    4:2:0 JPEG at `quality`, the bytes `cv2.imencode('.jpg', img,
    [cv2.IMWRITE_JPEG_QUALITY, quality])` writes (cv2.imwrite's default
    quality is 95)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"uint8 images only, got {img.dtype}")
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    if img.ndim != 3 or img.shape[2] != 3 or not img.shape[0] or \
            not img.shape[1] or max(img.shape[:2]) > 65535:
        raise ValueError(f"expected a (H, W, 3) image, got {img.shape}")
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    codec = lib()
    cap = h * w * 3 + 65536
    for _ in range(2):
        out = np.empty(cap, np.uint8)
        n = codec.ocr_jpeg_encode(_ptr(img), h, w, int(quality), _ptr(out),
                                  cap)
        if n > 0:
            return out[:n].tobytes()
        if n == 0:
            raise MemoryError("JPEG encoder: out of memory")
        cap = -n
    raise RuntimeError("JPEG encoder: output buffer sized wrongly")


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data +
            struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def imencode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 BGR → an 8-bit RGB PNG of the pixels
    `cv2.imwrite(path, img)` writes for a .png path (the channels back in
    RGB order): cv2's Sub filter on every row, zlib at level 1 with the
    RLE strategy, IDAT chunks of 8192 bytes. The pixels decode equal to
    cv2's file; the compressed bytes may differ."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"uint8 images only, got {img.dtype}")
    if img.ndim != 3 or img.shape[2] != 3 or not img.shape[0] or \
            not img.shape[1]:
        raise ValueError(f"expected a (H, W, 3) image, got {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img[:, :, ::-1]).reshape(h, w * 3)
    sub = rows.copy()
    sub[:, 3:] = rows[:, 3:] - rows[:, :-3]  # uint8 wraps mod 256
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1).tobytes()
    co = zlib.compressobj(1, zlib.DEFLATED, 15, 9, zlib.Z_RLE)
    z = co.compress(raw) + co.flush()
    out = [b"\x89PNG\r\n\x1a\n",
           _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    out += [_png_chunk(b"IDAT", z[i:i + 8192]) for i in range(0, len(z), 8192)]
    out.append(_png_chunk(b"IEND", b""))
    return b"".join(out)

"""The image codec of the service and the crop writer, for a machine without
cv2 or PIL: counterparts of `cv2.imdecode(buf, cv2.IMREAD_COLOR)`, of
`cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, q])` and of the pixels
`cv2.imwrite` writes to a PNG (`imencode_png`).

`imdecode` reads PNG (every colour type and bit depth, Adam7 interlace),
JPEG (baseline and progressive, Huffman or arithmetic coding, 8-bit, 1,
3 or 4 (CMYK, YCCK) components, any integral sampling factors, restart
intervals, the EXIF orientation; a sequential file streams row by row;
lossless SOF3 at precisions 2-8, predictors 1-7, point transform and
restarts, where libjpeg-turbo needs no colour conversion: three
components as RGB, four as CMYK), BMP (1-, 4- and 8-bit
palettes, RLE8 and RLE4, 16-bit 5-5-5 and 5-6-5, 24- and 32-bit with or
without bit-field masks, bottom-up and top-down, the OS/2 core header too),
TIFF and BigTIFF (the first IFD: none, PackBits, LZW, Deflate, CCITT
modified Huffman, T.4 1D and 2D, T.6, JPEG with JPEGTables; predictor 2;
FillOrder 2; strips, tiles, planar; 1, 8, 16 bits; grey, RGB(A), palette,
CMYK, YCbCr (subsampled too), CIELab; the Orientation tag), Netpbm P1–P6,
PAM (P7: BLACKANDWHITE, GRAYSCALE, RGB and
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
None: bytes of another format (AVIF, ...), 12-bit, 16-bit lossless,
arithmetic lossless or hierarchical JPEGs, lossless JPEGs libjpeg-turbo
would have to convert (grey to BGR, YCbCr, YCCK), BMPs and TIFFs cv2 reads
that this reader does not (other 16-bit masks, old-style JPEG, other
compressions, a YCbCr JPEG stored planar), the TIFF layouts cv2 5.0
refuses itself (uncompressed tiles that do not fill a whole number of KiB,
YCbCr subsamplings with no put routine, planar CIELab, 16-bit CMYK), the
Sun raster types cv2 5.0 refuses itself (byte-encoded, RGB-format), the
JPEG 2000 files cv2 5.0 refuses (signed or subsampled components, a
largest precision below 8, an image origin other than 0, too few
components for the colour space, CMYK or e-sYCC), HTJ2K code-blocks,
truncated or corrupt files (a corrupt CCITT or JPEG-in-TIFF strip
decodes as libtiff's recovery leaves it, as cv2 returns it), and sides
longer than libpng or libjpeg reads. `jpeg_pil_rgb` is the PDF rasteriser's other JPEG reading,
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
and decoding one tile at a time; TIFF's CCITT decoder and CIELab
conversion are `csrc/host/tiff.cc`, libtiff 4.7's), built with g++ at
first use into `build/host/` like the DB postprocess library
(`ops/native.py`); zlib inflates PNG streams, and numpy lays out the
samples of the uncompressed formats (BMP, TIFF strips, Netpbm, PAM, PFM,
Sun raster) and converts TIFF's CMYK and YCbCr. There is no
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
TIFF_SOURCE = SOURCE.with_name("tiff.cc")

_LIB: Optional[ctypes.CDLL] = None
_JP2_LIB: Optional[ctypes.CDLL] = None
_TIFF_LIB: Optional[ctypes.CDLL] = None
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
    "ocr_jpeg_tiff": (ctypes.c_int, [
        _U8P, _LL, _U8P, _LL,                      # tables, bytes, strip, bytes
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # segment w, h, taller ok
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # components, h, v sampling
        ctypes.c_int, _U8P, _LL, ctypes.c_int]),   # YCbCr, out, row, rows
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

_TIFF_SIGNATURES = {
    "ocr_tiff_fax": (ctypes.c_int, [
        _U8P, _LL, ctypes.c_int, ctypes.c_int,     # in, bytes, comp, T4Options
        ctypes.c_int, ctypes.c_int, _LL,           # FillOrder 2, width, row
        ctypes.c_int, _IP,                         # rows, codec mode
        ctypes.POINTER(ctypes.c_uint32), _LL,      # run arrays, entries
        _U8P]),                                    # out
    "ocr_tiff_lab": (ctypes.c_int, [
        ctypes.c_void_p, _LL, ctypes.c_int,        # samples, pixels, 16-bit
        ctypes.c_float, ctypes.c_float, _U8P]),    # white point, out BGR
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
        return _bmp_rle(buf, offset, w, rows, comp == 2, palette, h > 0)
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


def _bmp_rle(buf, offset, w, rows, rle4, palette, bottom_up):
    """RLE8 / RLE4 codes from `offset` → (rows, w, 3) BGR, as cv2 decodes
    them: a run or an absolute block past the row's end, or codes running
    out before the last row, make the file unreadable; end of line, end of
    bitmap and delta skip pixels, which keep palette entry 0 (a delta in
    RLE4 skips dx pixels only and an end of bitmap in RLE4 ends the row
    only, as cv2 does); an end of line just after a run that ended its row
    is no second line break in RLE8. The runs are written into the output
    in its final orientation: a decode holds the output and one block's
    indices (a few bytes of codes can ask for 2^30 pixels)."""
    out = np.empty((rows, w, 3), np.uint8)
    out[:] = palette[0]

    def row(y):                       # file row y → output row
        return out[rows - 1 - y if bottom_up else y]
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
                row(y)[x:x + n] = palette[np.resize(
                    np.array([code >> 4, code & 15], np.uint8), n)]
                x += n
                continue
            row(y)[x:x + n] = palette[code]
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
            row(y)[x:x + code] = palette[raw[:code]]
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
    return out


# ----------------------------------------------------------------- TIFF
# the integer field types: BYTE, SHORT, LONG, LONG8, IFD8 → struct code,
# bytes
_TIFF_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 16: ("Q", 8),
               18: ("Q", 8)}
# none, CCITT RLE, T.4, T.6, LZW, JPEG, Deflate, PackBits, Deflate (old)
_TIFF_COMPRESSIONS = (1, 2, 3, 4, 5, 7, 8, 32773, 32946)
_FAX = (2, 3, 4)
# YCbCr subsamplings TIFFReadRGBA has a put routine for (tif_getimage.c)
_YCBCR_CHUNKY = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
_BIT_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                        np.uint8)
# libtiff's defaults: YCbCrCoefficients, ReferenceBlackWhite of YCbCr, and
# the WhitePoint (D50, as TIFFGetFieldDefaulted computes it in float)
_LUMA = tuple(np.float32(v) for v in (0.299, 0.587, 0.114))
_REF_BW = tuple(np.float32(v) for v in (0, 255, 128, 255, 128, 255))
_D50 = (np.float32(96.4250), np.float32(100.0), np.float32(82.4680))
_WHITE = (_D50[0] / (_D50[0] + _D50[1] + _D50[2]),
          _D50[1] / (_D50[0] + _D50[1] + _D50[2]))


def _tiff_ifd(buf: bytes):
    """The first IFD of a classic TIFF (magic 42: 12-byte entries, 4-byte
    offsets) or a BigTIFF (magic 43: 20-byte entries, 8-byte offsets, the
    LONG8 / IFD8 types) → (byte order, {tag: values}): a tuple of ints for
    the integer-typed tags, of float32 for the RATIONAL ones (as libtiff
    converts them), the bytes of JPEGTables."""
    order = {b"II": "<", b"MM": ">"}[buf[:2]]
    magic, = struct.unpack(order + "H", buf[2:4])
    if magic == 42:
        ifd, = struct.unpack(order + "I", buf[4:8])
        count_code, entry, inline, off_code = "H", 12, 4, "I"
    elif magic == 43:
        size, zero, ifd = struct.unpack(order + "HHQ", buf[4:16])
        if size != 8 or zero:
            raise _Unreadable("BigTIFF: bad header")
        count_code, entry, inline, off_code = "Q", 20, 8, "Q"
    else:
        raise _Unreadable("TIFF: not a classic TIFF or a BigTIFF")
    head = struct.calcsize(count_code)
    count, = struct.unpack(order + count_code, buf[ifd:ifd + head])
    if magic == 43 and count > 4096:
        # libtiff's "Sanity check on directory count failed"
        raise _Unreadable("BigTIFF: directory count past 4096")
    tags = {}
    for e in range(ifd + head, ifd + head + entry * count, entry):
        tag, typ = struct.unpack(order + "HH", buf[e:e + 4])
        n, = struct.unpack(order + off_code, buf[e + 4:e + 4 + inline])
        value = buf[e + 4 + inline:e + entry]
        if len(value) < inline:
            raise _Unreadable("TIFF: truncated directory")
        if tag == 347 and typ in (1, 7):                 # JPEGTables
            code, width = "B", 1
        elif typ == 5:                                   # RATIONAL
            code, width = "I", 8
        elif typ in _TIFF_TYPES:
            code, width = _TIFF_TYPES[typ]
        else:
            continue
        size = width * n
        if size <= inline:
            data = value[:size]
        else:
            off, = struct.unpack(order + off_code, value)
            if off + size > len(buf):
                raise _Unreadable(f"TIFF: tag {tag} past the end")
            data = buf[off:off + size]
        if tag == 347 and typ in (1, 7):
            tags[tag] = bytes(data)
        elif typ == 5:
            v = struct.unpack(f"{order}{2 * n}I", data)
            tags[tag] = tuple(np.float32(v[k] / v[k + 1] if v[k + 1] else 0)
                              for k in range(0, 2 * n, 2))
        else:
            tags[tag] = struct.unpack(f"{order}{n}{code}", data)
    return order, tags


def tiff_lib() -> ctypes.CDLL:
    """The loaded TIFF library (CCITT fax, CIELab), built first if
    needed."""
    global _TIFF_LIB
    with _LOCK:
        if _TIFF_LIB is None:
            _TIFF_LIB = _load(TIFF_SOURCE, "libocrtiff", _TIFF_SIGNATURES)
    return _TIFF_LIB


class _Chunk:
    """How one strip or tile decodes: the compression and its parameters
    that libtiff's codecs read."""

    def __init__(self, comp, fill_lsb, t4opts=0, tables=b"", jpeg=None):
        self.comp, self.fill_lsb, self.t4opts = comp, fill_lsb, t4opts
        self.tables = np.frombuffer(tables, np.uint8)
        self.jpeg = jpeg            # (ncomp, hs, vs, ycc) for compression 7
        # what of the fax codec outlives a strip: its mode, which one strip
        # can change for the next, and its run arrays (tiff.cc)
        self.fax_mode = np.zeros(1, np.int32)
        self.fax_runs = None


def _tiff_chunk(buf: bytes, off: int, n: int, need: int, how: _Chunk, *,
                width: int = 0, rows: int = 0, seg=None) -> np.ndarray:
    """One strip or tile decompressed to exactly `need` bytes, as libtiff
    reads it (None, PackBits, LZW, Deflate, CCITT, JPEG). FillOrder 2
    reverses each byte's bits first, except for CCITT and JPEG, whose
    codecs take the data as it is (libtiff's TIFF_NOBITREV). A CCITT or
    JPEG strip that fails while decoding keeps what it wrote into a zeroed
    buffer, as TIFFReadRGBA* converts libtiff's strip buffer then."""
    comp = how.comp
    if n <= 0 or off + n > len(buf):
        # 0: libtiff's "Invalid strip byte count" (TIFFFillStrip)
        raise _Unreadable("TIFF: strip or tile past the end of the data")
    raw = np.frombuffer(buf, np.uint8, n, off)
    if comp in _FAX:
        out = np.zeros(need, np.uint8)
        src = np.ascontiguousarray(raw)
        if how.fax_runs is None:
            how.fax_runs = np.zeros(4 * ((width + 32) // 32 * 32) + 16,
                                    np.uint32)
        if tiff_lib().ocr_tiff_fax(
                _ptr(src), n, comp, how.t4opts, how.fill_lsb, width,
                need // max(rows, 1), rows, how.fax_mode.ctypes.data_as(_IP),
                how.fax_runs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                how.fax_runs.size, _ptr(out)) < 0:
            raise _Unreadable("TIFF: CCITT layout libtiff refuses")
        return out
    if comp == 7:
        seg_w, seg_h, taller_ok, bpl = seg
        ncomp, hs, vs, ycc = how.jpeg
        out = np.zeros(need, np.uint8)
        src = np.ascontiguousarray(raw)
        if lib().ocr_jpeg_tiff(_ptr(how.tables), how.tables.size, _ptr(src),
                               n, seg_w, seg_h, taller_ok, ncomp, hs, vs,
                               ycc, _ptr(out), bpl, need // bpl) < 0:
            raise _Unreadable("TIFF: a JPEG strip libtiff refuses")
        return out
    if how.fill_lsb:
        raw = _BIT_REVERSE[raw]
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


def _jpeg_sampling(buf: bytes, off: int, n: int):
    """Component 0's sampling factors in the first strip's SOF of a YCbCr
    JPEG-in-TIFF without YCbCrSubsampling (libtiff's
    JPEGFixupTagsSubsampling), None where it finds none it takes."""
    end = min(off + n, len(buf))
    if buf[off:off + 2] != b"\xff\xd8":
        return None
    p = off + 2
    while p + 4 <= end:
        if buf[p] != 0xFF:
            return None
        while p < end and buf[p] == 0xFF:
            p += 1
        m = buf[p]
        p += 1
        if m in (0xD9, 0xDA) or p + 2 > end:
            return None
        length, = struct.unpack(">H", buf[p:p + 2])
        if m in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
            if p + 11 + 6 > end or buf[p + 7] != 3:
                return None
            hv = [buf[p + 9 + 3 * i] for i in range(3)]
            hs, vs = hv[0] >> 4, hv[0] & 15
            if hs not in (1, 2, 4) or vs not in (1, 2, 4) or \
                    hv[1] != 0x11 or hv[2] != 0x11:
                return None
            return hs, vs
        p += length
    return None


def _ycbcr_tables(luma, ref):
    """TIFFYCbCrToRGBInit's tables (tif_color.c) in its float32 and 16.16
    fixed-point arithmetic → Y, Cr→R, Cb→B, Cr→G, Cb→G (int64 arrays of
    256)."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)

    def clamp(f, lo, hi):
        return np.where(~(f >= lo), lo, np.where(f > hi, hi, f))

    def fix(x):           # (int32_t)(x * 65536L + 0.5): float, then double
        return int(float(f32(x) * f32(65536)) + 0.5)

    f1 = f32(2) - f32(2) * lr
    d1 = fix(clamp(f1, f32(0), f32(2)))
    d2 = -fix(clamp(lr * f1 / lg, f32(0), f32(2)))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(clamp(f3, f32(0), f32(2)))
    d4 = -fix(clamp(lb * f3 / lg, f32(0), f32(2)))

    def code2v(c, rb, rw, cr):
        rb, rw = f32(rb), f32(rw)
        den = rw - rb
        den = den if den != 0 else f32(1)
        v = (c - int(np.trunc(rb))).astype(np.float32) * f32(cr) / den
        return np.trunc(clamp(v, f32(-4096), f32(4096))).astype(np.int64)

    x = np.arange(-128, 128)
    cr = code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127)
    cb = code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127)
    y = code2v(x + 128, ref[0], ref[1], 255)
    return (y, (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16, d2 * cr,
            d4 * cb + 32768)


def _ycbcr_unblock(chunk: np.ndarray, rows: int, cw: int, sh: int, sv: int
                   ) -> np.ndarray:
    """A strip or tile of subsampled YCbCr data units (sh · sv luma samples
    then Cb, Cr) → (rows, cw · 3) Y, Cb, Cr per pixel, each pixel taking its
    own luma and its unit's chroma, as tif_getimage.c's putcontig8bitYCbCr
    routines read them."""
    across = -(-cw // sh)
    units = chunk.reshape(-1, across, sh * sv + 2)
    yy, xx = np.arange(rows), np.arange(cw)
    luma = units[(yy // sv)[:, None], (xx // sh)[None, :],
                 ((yy % sv)[:, None] * sh + (xx % sh)[None, :])]
    chroma = units[(yy // sv)[:, None], (xx // sh)[None, :], sh * sv:]
    return np.concatenate([luma[:, :, None], chroma], axis=2).reshape(
        rows, cw * 3)


def _tiff(buf: bytes) -> np.ndarray:
    """cv2's TiffDecoder at IMREAD_COLOR, which reads through libtiff's
    TIFFReadRGBA*: the first IFD of a classic TIFF or a BigTIFF;
    compression none, PackBits, LZW, Deflate, CCITT (2, 3, 4; `ocr_tiff_fax`
    in csrc/host/tiff.cc) or JPEG (7, 8 bits a sample; the JPEG decoder
    with the JPEGTables); FillOrder 2; predictor 2 (which libtiff undoes for LZW and
    Deflate only); strips or tiles (uncompressed tiles only where a tile
    fills a whole number of KiB: cv2 5.0's libtiff refuses the others with
    "Invalid tile byte count"); chunky or planar samples; 1, 8 or 16 bits
    (4 for a palette); grey (MinIsBlack, MinIsWhite), RGB with or without
    alpha, palette, CMYK (InkSet 1), YCbCr (8-bit; subsampled in the
    layouts libtiff has a put routine for; JPEG's through libjpeg's
    conversion) and CIELab (chunky, 8 or 16 bits). As TIFFReadRGBA
    converts them: 16-bit grey keeps its high byte and 16-bit colour (v +
    128) / 257; an unassociated alpha is multiplied in ((c a + 127) / 255)
    and dropped; a colour map whose entries all lie below 256 is taken as
    8-bit, else its high bytes; CMYK by (255 − K)(255 − C) / 255; YCbCr
    through TIFFYCbCrToRGB's fixed-point tables; CIELab through libtiff's
    float XYZ → sRGB. The Orientation tag is applied as cv2 applies it."""
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
    fill_lsb = one(266, 1) == 2
    if any(b != bps for b in bps_all) or bps not in (1, 4, 8, 16) or \
            comp not in _TIFF_COMPRESSIONS or planar not in (1, 2) or \
            predictor not in (1, 2) or (predictor == 2 and bps == 1) or \
            one(339, 1) != 1 or not 1 <= spp <= 8 or \
            (comp in _FAX and (bps != 1 or spp != 1)):
        raise _Unreadable("TIFF: a layout TIFFReadRGBA does not take here")
    extra = tags.get(338, ())
    sub = (1, 1)
    if photo in (0, 1):
        colour = "grey"
    elif photo == 2 and spp >= 3:
        colour = "rgb"
    elif photo == 3 and spp == 1 and bps <= 8 and 320 in tags:
        colour = "palette"
    elif photo == 5 and spp == 4 and bps == 8 and one(332, 1) == 1:
        colour = "cmyk"
    elif photo == 6 and spp == 3 and bps == 8:
        colour = "ycbcr"
        sub = tuple(tags.get(530, (2, 2))[:2])
    elif photo == 8 and spp == 3 and bps in (8, 16) and planar == 1:
        colour = "lab"
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
    how = _Chunk(comp, fill_lsb, one(292, 0), tags.get(347, b""))
    blocked = None                    # subsampled YCbCr data units (sh, sv)
    if comp == 7:
        if bps != 8:
            # JPEGPreDecode's "Improper JPEG data precision": the frame's
            # 8 bits must be BitsPerSample
            raise _Unreadable("TIFF: JPEG with BitsPerSample other than 8")
        if colour == "ycbcr":
            if planar != 1:
                raise _Unreadable("TIFF: planar YCbCr JPEG is not read")
            if 530 not in tags:
                sub = _jpeg_sampling(buf, offsets[0], counts[0]) or (2, 2)
            if sub[0] not in (1, 2, 4) or sub[1] not in (1, 2, 4):
                raise _Unreadable("TIFF: YCbCr subsampling not read")
            # libtiff sets JPEGCOLORMODE_RGB: libjpeg converts to RGB
            how.jpeg = (3, sub[0], sub[1], 1)
            colour = "rgb"
        else:
            how.jpeg = (per, 1, 1, 0)
    elif colour == "ycbcr":
        if planar == 1 and sub not in _YCBCR_CHUNKY or \
                planar == 2 and sub != (1, 1):
            raise _Unreadable("TIFF: a YCbCr subsampling with no put routine")
        if sub != (1, 1):
            blocked = sub
    row_bytes = (cw * per * bps + 7) // 8

    def chunk_bytes(rows):
        if blocked:
            sh, sv = blocked
            return -(-rows // sv) * -(-cw // sh) * (sh * sv + 2)
        return rows * row_bytes
    if tiled and comp == 1 and chunk_bytes(ch) % 1024:
        # cv2 5.0 refuses the others: its libtiff's "Invalid tile byte
        # count ... Expected <tile size>, got <it rounded up to a KiB>"
        raise _Unreadable("TIFF: an uncompressed tile cv2 does not read")
    lut = conv = None
    if photo == 3:
        n = 1 << bps
        cmap = np.asarray(tags[320], np.int64)
        if cmap.size < 3 * n:
            raise _Unreadable("TIFF: short colour map")
        cmap = cmap[:3 * n].reshape(3, n)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        lut = np.ascontiguousarray(cmap[::-1].T.astype(np.uint8))   # BGR
    elif colour == "grey":            # grey sample → its 8-bit value
        v = np.arange(1 << bps, dtype=np.uint32)
        if bps == 16:
            v = v >> 8
        elif bps < 8:                            # libtiff's x * 255 / range
            v = v * 255 // ((1 << bps) - 1)
        lut = (255 - v if photo == 0 else v).astype(np.uint8)[:, None]
    elif colour == "rgb" and bps == 16:          # (v + 128) / 257
        lut = ((np.arange(1 << 16, dtype=np.uint32) + 128) // 257).astype(
            np.uint8)
    elif colour == "ycbcr":
        luma = tags.get(529, _LUMA)[:3]
        ref = tags.get(532, _REF_BW)[:6]
        if len(luma) < 3 or len(ref) < 6 or np.isnan(luma).any() or \
                abs(luma[1]) < 1e-9 or not all(
                    -0x7FFFFFFF + 128 < v < 0x7FFFFFFF for v in ref):
            raise _Unreadable("TIFF: YCbCr coefficients libtiff refuses")
        conv = _ycbcr_tables(luma, ref)
    elif colour == "lab":
        white = tags.get(318, _WHITE)
        if len(white) < 2 or white[1] == 0:
            raise _Unreadable("TIFF: invalid WhitePoint")
        conv = (np.float32(white[0]), np.float32(white[1]))
    alpha = colour == "rgb" and spp > 3 and extra[:1] == (2,)
    # libtiff's put16bitbwtile steps a clipped tile's rows by the skew in
    # bytes, not in samples: rows after the first of a tile cut by the
    # right edge are read from there
    skewed = tiled and bps == 16 and colour == "grey"
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
            seg = (cw, rows, int(not tiled and ty == down - 1),
                   row_bytes)
            chunks = []
            for p in range(planes):
                k = (p * down + ty) * across + tx
                need = chunk_bytes(rows)
                if blocked and not tiled:
                    # gtStripContig reads a whole number of its scanlines,
                    # a unit row's bytes / sv rounded down: the strip's
                    # last bytes stay 0
                    sh, sv = blocked
                    need = min(need, -(-rows // sv) * sv * (
                        chunk_bytes(sv) // sv))
                chunk = _tiff_chunk(buf, offsets[k], counts[k], need, how,
                                    width=cw, rows=rows, seg=seg)
                if blocked:
                    chunk = _ycbcr_unblock(np.concatenate([chunk, np.zeros(
                        chunk_bytes(rows) - need, np.uint8)]), rows, cw,
                        *blocked)
                else:
                    chunk = chunk.reshape(rows, row_bytes)
                if skewed and npix < cw:
                    chunk = _skew16(chunk, dtype, predicted, npix, per)
                chunks.append(chunk)
            y0, x0 = ty * ch, tx * cw
            last = min(rows, h - y0)
            for b0 in range(0, last, band):
                b1 = min(b0 + band, last)
                px = np.concatenate([_tiff_samples(
                    c[b0:b1], bps, dtype, cw, 3 if blocked else per,
                    predicted)[:, :npix] for c in chunks], axis=2)
                out[y0 + b0:y0 + b1, x0:x0 + npix] = _tiff_bgr(
                    px, colour, lut, alpha, conv)
    return _oriented(out, one(274, 1))


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


def _tiff_bgr(px: np.ndarray, colour: str, lut, alpha: bool, conv
              ) -> np.ndarray:
    """(rows, n, spp) samples → (rows, n, 3) BGR as TIFFReadRGBA gives
    them: grey and palette through `lut`, 16-bit colour through `lut`
    too; an unassociated alpha multiplied in ((c a + 127) / 255, in
    uint16, which holds 255 · 255 + 127) and dropped; CMYK, YCbCr (`conv`:
    its tables) and CIELab (`conv`: the white point) converted."""
    if colour in ("grey", "palette"):
        return lut[px[:, :, 0]] if lut.shape[1] == 3 else \
            np.broadcast_to(lut[px[:, :, 0]], px.shape[:2] + (3,))
    if colour == "cmyk":              # putRGBcontig8bitCMYKtile
        k = 255 - px[:, :, 3:4].astype(np.uint16)
        return (k * (255 - px[:, :, 2::-1].astype(np.uint16)) // 255
                ).astype(np.uint8)
    if colour == "ycbcr":             # TIFFYCbCrtoRGB
        y_tab, cr_r, cb_b, cr_g, cb_g = conv
        y = y_tab[px[:, :, 0]]
        cb, cr = px[:, :, 1], px[:, :, 2]
        bgr = np.stack([y + cb_b[cb], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                        y + cr_r[cr]], -1)
        return np.clip(bgr, 0, 255).astype(np.uint8)
    if colour == "lab":
        src = np.ascontiguousarray(px)
        out = np.empty(px.shape[:2] + (3,), np.uint8)
        if tiff_lib().ocr_tiff_lab(src.ctypes.data_as(ctypes.c_void_p),
                                   px.shape[0] * px.shape[1],
                                   int(px.dtype == np.uint16), conv[0],
                                   conv[1], _ptr(out)) != 0:
            raise _Unreadable("TIFF: invalid WhitePoint")
        return out
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
        if buf[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
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

"""The image codec of the service and the crop writer, for a machine without
cv2 or PIL: counterparts of `cv2.imdecode(buf, cv2.IMREAD_COLOR)` and of
`cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, q])`.

`imdecode` reads PNG (every colour type and bit depth, Adam7 interlace),
JPEG (baseline and progressive Huffman, 8-bit, 1 or 3 components, any
integral sampling factors, restart intervals, the EXIF orientation) and BMP
(24- and 32-bit, bottom-up and top-down) into (H, W, 3) uint8 BGR, and
gives None where cv2 gives None: bytes of another format (WebP, TIFF, ...),
arithmetic-coded, 12-bit, lossless or 4-component (CMYK / YCCK) JPEGs,
other BMP depths, truncated or corrupt files, and sides longer than
libpng or libjpeg reads. As IMREAD_COLOR does, it
drops alpha, replicates grey, reduces 16-bit samples to their high byte and
applies the EXIF orientation (a JPEG's APP1, a PNG's eXIf chunk).

The pixel work is C++ (`csrc/host/imcodec.cc`: PNG unfiltering, the JPEG
decoder and encoder, written to compute what libjpeg-turbo computes at
cv2's settings), built with g++ at first use into `build/host/` like the DB
postprocess library (`ops/native.py`); zlib inflates PNG streams. There is
no fallback: where the library cannot be built, every call raises.
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

_LIB: Optional[ctypes.CDLL] = None
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
    "ocr_jpeg_encode": (_LL, [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bgr, h, w, quality
        _U8P, _LL]),                                     # out, capacity
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


def lib() -> ctypes.CDLL:
    """The loaded codec library, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            loaded = ctypes.CDLL(str(native.build(SOURCE, "libocrimcodec")))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = loaded
    return _LIB


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
def _bmp(buf: bytes) -> np.ndarray:
    offset, = struct.unpack("<I", buf[10:14])
    dib, = struct.unpack("<I", buf[14:18])
    if dib < 40:
        raise _Unreadable("BMP: core headers are not read")
    w, h, _planes, bits, compression = struct.unpack("<iiHHI", buf[18:34])
    if bits not in (24, 32) or w <= 0 or h == 0:
        raise _Unreadable(f"BMP: {bits}-bit images are not read")
    if compression == 3 and bits == 32:      # BI_BITFIELDS: BGRX masks only
        masks = struct.unpack("<III", buf[54:66])  # after or in the header
        if masks != (0xFF0000, 0xFF00, 0xFF):
            raise _Unreadable("BMP: other bit-field masks are not read")
    elif compression != 0:
        raise _Unreadable("BMP: compressed images are not read")
    rows, bpp = abs(h), bits // 8
    _check_size("bmp", w, rows)
    stride = (w * bpp + 3) & ~3
    if offset + stride * rows > len(buf):
        raise _Unreadable("BMP: truncated pixel data")
    px = np.frombuffer(buf, np.uint8, stride * rows, offset).reshape(
        rows, stride)[:, :w * bpp].reshape(rows, w, bpp)[:, :, :3]
    return np.ascontiguousarray(px[::-1] if h > 0 else px)


def _check_size(fmt: str, w: int, h: int) -> None:
    side = FORMAT_MAX_SIDE.get(fmt)
    if side and (w > side or h > side):
        raise _Unreadable(f"{fmt}: a side of {max(w, h)} px is not read")
    if w > MAX_SIDE or h > MAX_SIDE or w * h > MAX_PIXELS:
        raise ValueError(f"a {w} x {h} image is larger than cv2.imdecode "
                         f"reads (validateInputImageSize)")


def imdecode(buf) -> Optional[np.ndarray]:
    """Encoded image bytes → (H, W, 3) uint8 BGR, or None where
    `cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)` gives
    None. Raises ValueError where cv2 raises: an empty buffer, an image of
    more than MAX_SIDE px a side or MAX_PIXELS px in all."""
    buf = bytes(buf)
    if not buf:
        raise ValueError("an empty buffer (cv2.imdecode asserts !buf.empty())")
    try:
        if buf[:3] == b"\xff\xd8\xff":
            return _jpeg(buf)
        if buf[:8] == PNG_SIGNATURE:
            return _png(buf)
        if buf[:2] == b"BM" and len(buf) >= 54:
            return _bmp(buf)
    except (_Unreadable, struct.error, zlib.error):
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

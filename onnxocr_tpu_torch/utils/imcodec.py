"""The image codec of the service and the crop writer, for a machine without
cv2 or PIL: counterparts of `cv2.imdecode(buf, cv2.IMREAD_COLOR)` and of
`cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, q])`.

`imdecode` reads PNG (every colour type and bit depth, Adam7 interlace),
JPEG (baseline and progressive Huffman, 8-bit, 1, 3 or 4 (CMYK, YCCK)
components, any integral sampling factors, restart intervals, the EXIF
orientation) and BMP (1-, 4- and 8-bit palettes, RLE8 and RLE4, 16-bit
5-5-5 and 5-6-5, 24- and 32-bit with or without bit-field masks, bottom-up
and top-down, the OS/2 core header too) into (H, W, 3) uint8 BGR, and
gives None where cv2 gives None: bytes of another format (WebP, TIFF,
...), arithmetic-coded, 12-bit or lossless JPEGs, BMPs cv2 does not read
(other 16-bit masks, other compressions), truncated or corrupt files, and
sides longer than libpng or libjpeg reads. `jpeg_pil_rgb` is the PDF rasteriser's other JPEG reading,
PIL's `Image.open(...).convert('RGB')`: the stored orientation, and
Adobe's inverted CMYK through Pillow's cmyk2rgb. As IMREAD_COLOR does, it
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
    "ocr_jpeg_decode_native": (ctypes.c_int, [
        _U8P, _LL, ctypes.c_int, ctypes.c_int,     # buf, bytes, h, w
        _U8P]),                                    # out h * w * ncomp
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
        if buf[:2] == b"BM":
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

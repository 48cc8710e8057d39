"""Minimal PNG reader on the standard library (zlib) and numpy, for machines
without cv2 or PIL: 8-bit greyscale, RGB and RGBA, non-interlaced."""
from __future__ import annotations

import struct
import zlib

import numpy as np

_CHANNELS = {0: 1, 2: 3, 6: 4}


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    rows = raw.reshape(h, stride + 1)
    for y in range(h):
        ftype = rows[y, 0]
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:    # Sub: running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:    # Up
            cur = (line + prev) & 255
        elif ftype in (3, 4):   # Average / Paeth: sequential along the row
            cur = line.copy()
            for i in range(0, stride, bpp):
                up = prev[i:i + bpp]
                if i:
                    left = cur[i - bpp:i]
                    if ftype == 3:
                        pred = (left + up) >> 1
                    else:
                        ul = prev[i - bpp:i]
                        p = left + up - ul
                        pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                        pred = np.where((pa <= pb) & (pa <= pc), left,
                                        np.where(pb <= pc, up, ul))
                else:
                    pred = up >> 1 if ftype == 3 else up
                cur[i:i + bpp] = (cur[i:i + bpp] + pred) & 255
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """→ (H, W, C) uint8 in the file's channel order (RGB / RGBA / grey)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: unsupported PNG (depth {depth}, colour "
                         f"type {ctype}, interlace {interlace})")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _unfilter(raw, h, w * c, c).reshape(h, w, c)


def read_bgr(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR, as cv2.imread returns it."""
    img = read_png(path)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, 2::-1])

"""A PNG writer for 8-bit grey and BGR images: every row takes the Up
filter, the stream is zlib's at `level`. Enough to send a scanner's output
as bytes; the decoding is the program's work."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(
        ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode(img: np.ndarray, level: int = 1) -> bytes:
    """(H, W) grey or (H, W, 3) BGR uint8 → PNG bytes."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3:
        img = np.ascontiguousarray(img[:, :, ::-1])  # BGR → RGB
        colour, ch = 2, 3
    else:
        colour, ch = 0, 1
    h, w = img.shape[:2]
    rows = img.reshape(h, w * ch)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]  # uint8 wraps, as the Up filter does
    raw = np.empty((h, w * ch + 1), np.uint8)
    raw[:, 0] = 2
    raw[0, 0] = 0
    raw[0, 1:] = rows[0]
    raw[1:, 1:] = up[1:]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) +
            _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) +
            _chunk(b"IEND", b""))

"""Minimal protobuf wire-format reader. The port's own copy of
onnxocr_tpu/onnx/wire.py.

The environment has no `onnx` package and no generated protobuf stubs, so this
module implements just enough of the protobuf wire format to decode ONNX
ModelProto files (see ir.py for the schema-aware layer).

Wire format recap (https://protobuf.dev/programming-guides/encoding/):
  record   = tag payload
  tag      = varint(field_number << 3 | wire_type)
  wire 0   = varint payload
  wire 1   = 8-byte little-endian (fixed64 / double)
  wire 2   = varint length + that many bytes (strings, bytes, sub-messages,
             packed repeated scalars)
  wire 5   = 4-byte little-endian (fixed32 / float)

Groups (wire 3/4) are obsolete and unused by ONNX.
"""
from __future__ import annotations

import struct
from typing import Iterator, Tuple

VARINT = 0
FIXED64 = 1
LENGTH = 2
FIXED32 = 5


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """Decode a varint at `pos`; returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def iter_fields(buf: bytes, start: int = 0, end: int | None = None
                ) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) records.

    For LENGTH fields the value is a memoryview of the payload bytes; for
    VARINT an int; for FIXED32/FIXED64 the raw 4/8 bytes (callers decide
    whether they mean float, double, or fixed ints).
    """
    if end is None:
        end = len(buf)
    mv = memoryview(buf)
    pos = start
    while pos < end:
        tag, pos = read_varint(buf, pos)
        field_no = tag >> 3
        wire = tag & 7
        if wire == VARINT:
            val, pos = read_varint(buf, pos)
            yield field_no, wire, val
        elif wire == LENGTH:
            size, pos = read_varint(buf, pos)
            yield field_no, wire, mv[pos:pos + size]
            pos += size
        elif wire == FIXED32:
            yield field_no, wire, mv[pos:pos + 4]
            pos += 4
        elif wire == FIXED64:
            yield field_no, wire, mv[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire} at {pos}")


def as_float(raw) -> float:
    return struct.unpack("<f", raw)[0]


def as_double(raw) -> float:
    return struct.unpack("<d", raw)[0]


def zigzag(n: int) -> int:
    """Decode a zigzag-encoded signed varint (sint32/sint64)."""
    return (n >> 1) ^ -(n & 1)


def signed(n: int, bits: int = 64) -> int:
    """Interpret an unsigned varint as two's-complement signed int."""
    if n >= 1 << (bits - 1):
        n -= 1 << bits
    return n


def unpack_packed_varints(raw) -> list:
    out = []
    buf = bytes(raw)
    pos = 0
    n = len(buf)
    while pos < n:
        v, pos = read_varint(buf, pos)
        out.append(v)
    return out


def unpack_packed_floats(raw) -> list:
    buf = bytes(raw)
    return list(struct.unpack(f"<{len(buf) // 4}f", buf))


def unpack_packed_doubles(raw) -> list:
    buf = bytes(raw)
    return list(struct.unpack(f"<{len(buf) // 8}d", buf))

"""ctypes loader for the host C++ library of the DB postprocess
(csrc/host/geometry.cc): contour tracing, min-area rect, round-join polygon
offset and the even-odd box scorer. Counterpart of
onnxocr_tpu/runtime/native.py.

The host C++ compiler builds the library at first use with the JAX
package's flags (`g++ -std=c++17 -shared -fPIC -O2`) into `build/host/` at
the repository root, named by a hash of its source, so an edited source
never loads a stale build. There is no fallback: where the library cannot
be built or loaded, every call raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "host" / "geometry.cc"
BUILD_DIR = _PKG.parent / "build" / "host"
CXX_FLAGS = ["-std=c++17", "-shared", "-fPIC", "-O2"]

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "ocr_find_contours": (ctypes.c_int, [
        _U8P, ctypes.c_int, ctypes.c_int,       # bitmap, h, w
        _I32P, _I32P,                           # out points (x, y)*, lengths
        ctypes.c_int, ctypes.c_int]),           # max points, max contours
    "ocr_find_contours_filtered": (ctypes.c_int, [
        _U8P, ctypes.c_int, ctypes.c_int, _I32P, _I32P,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_double,                        # min bbox area
        ctypes.c_longlong]),                    # max traced index
    "ocr_min_area_rect": (None, [
        _F32P, ctypes.c_int,
        _F32P]),                                # out: cx, cy, w, h, angle
    "ocr_offset_polygon": (ctypes.c_int, [
        _F64P, ctypes.c_int, ctypes.c_double, _F64P, ctypes.c_int]),
    "ocr_box_score": (ctypes.c_double, [
        _F32P, ctypes.c_int, ctypes.c_int,      # prob map, h, w
        _F64P, ctypes.c_int]),                  # poly (x, y)*, n vertices
}


def target(source: Path = SOURCE, stem: str = "libocrhost") -> Path:
    # the headers beside a source (the shared font reader) are part of it
    headers = b"".join(h.read_bytes()
                       for h in sorted(source.parent.glob("*.h")))
    digest = hashlib.sha1(source.read_bytes() + headers +
                          " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{stem}-{digest}.so"


def build(source: Path = SOURCE, stem: str = "libocrhost") -> Path:
    """Build a host library (this module's by default; utils/imcodec.py
    builds its codec here too) unless it is built already; → its path."""
    out = target(source, stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(tmp), str(source), "-lm"],
            capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {source.name} with g++ failed: {e}")
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {source.name} (rc "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            loaded = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = loaded
    return _LIB


class NativeOverflow(RuntimeError):
    """The tracer's output buffers overflowed even at the worst-case
    size."""


def _trace(call, h: int, w: int) -> List[np.ndarray]:
    """Run a tracer entry point, retrying once with worst-case buffers.

    The tracer returns -1 when its buffers overflow. h*w + 8 points is
    usually plenty but is reachable (a 1 px-wide stroke emits its border
    pixels twice); each pixel's border point can be emitted at most 4
    times, so the retry cannot overflow on points, and raises past 2^20
    contours."""
    for mult, max_contours in ((1, 8192), (4, 1 << 20)):
        max_points = mult * h * w + 8
        pts = np.empty((max_points, 2), dtype=np.int32)
        lens = np.empty(max_contours, dtype=np.int32)
        n = call(pts.ctypes.data_as(_I32P), lens.ctypes.data_as(_I32P),
                 max_points, max_contours)
        if n >= 0:
            ends = np.cumsum(lens[:n])
            return [pts[e - k:e].copy() for e, k in zip(ends, lens[:n])]
    raise NativeOverflow(f"contour buffers overflowed (h={h} w={w})")


def find_contours(bitmap_u8: np.ndarray) -> List[np.ndarray]:
    """Every border of the 8-connected foreground (cv2.findContours,
    RETR_LIST + CHAIN_APPROX_SIMPLE semantics) in raster order → list of
    (K, 2) int32 (x, y) arrays."""
    bitmap_u8 = np.ascontiguousarray(bitmap_u8, dtype=np.uint8)
    h, w = bitmap_u8.shape
    fn = lib().ocr_find_contours
    return _trace(lambda p, l, mp, mc: fn(
        bitmap_u8.ctypes.data_as(_U8P), h, w, p, l, mp, mc), h, w)


def find_contours_filtered(bitmap_u8: np.ndarray, min_bbox_area: float,
                           max_index: int) -> List[np.ndarray]:
    """Raster-order contours whose bbox area ≥ min_bbox_area, among the
    first max_index traced (the DB `contours[:max_candidates]` slice by
    original index)."""
    bitmap_u8 = np.ascontiguousarray(bitmap_u8, dtype=np.uint8)
    h, w = bitmap_u8.shape
    fn = lib().ocr_find_contours_filtered
    return _trace(lambda p, l, mp, mc: fn(
        bitmap_u8.ctypes.data_as(_U8P), h, w, p, l, mp, mc,
        float(min_bbox_area), int(max_index)), h, w)


def min_area_rect(points: np.ndarray):
    """Rotating calipers in float32 / float64 inside the library →
    ((cx, cy), (w, h), angle), cv2.minAreaRect's convention."""
    pts = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 2))
    res = np.empty(5, dtype=np.float32)
    lib().ocr_min_area_rect(pts.ctypes.data_as(_F32P), len(pts),
                            res.ctypes.data_as(_F32P))
    return (float(res[0]), float(res[1])), (float(res[2]), float(res[3])), \
        float(res[4])


def offset_polygon(poly: np.ndarray, distance: float) -> np.ndarray:
    """Outward round-join offset (the C++ twin of
    geometry.offset_polygon_round)."""
    pts = np.ascontiguousarray(np.asarray(poly, np.float64).reshape(-1, 2))
    max_out = len(pts) * 64 + 64
    out = np.empty((max_out, 2), dtype=np.float64)
    n = lib().ocr_offset_polygon(pts.ctypes.data_as(_F64P), len(pts),
                                 float(distance), out.ctypes.data_as(_F64P),
                                 max_out)
    if n < 0:
        raise NativeOverflow("offset polygon buffer overflowed")
    return out[:n].copy()


def box_score(prob: np.ndarray, poly: np.ndarray) -> float:
    """Mean of prob inside the polygon (even-odd test at pixel positions,
    vertices truncated to integers after the shift to the bbox corner)."""
    prob = np.ascontiguousarray(prob, dtype=np.float32)
    pts = np.ascontiguousarray(np.asarray(poly, np.float64).reshape(-1, 2))
    return float(lib().ocr_box_score(
        prob.ctypes.data_as(_F32P), prob.shape[0], prob.shape[1],
        pts.ctypes.data_as(_F64P), len(pts)))

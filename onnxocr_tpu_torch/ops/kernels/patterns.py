"""Seeded label and slot grids that reach every branch of the DB-extraction
reduction kernels (csrc/seg_reduce2.cu, csrc/seg_reduce.cu). numpy only: the
CPU tests run them through the plain versions and the JAX kernels, the card
check runs the same grids through the CUDA kernels and the plain versions.

A case with `misaligned` set is to be handed over as a view that starts one
element into its storage, so no 16-byte load applies.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

MAXINT = 2147483647
WINDOW = 512        # slots of the kernels' shared-memory window


def _ids(labels, K: int) -> np.ndarray:
    ids = np.full((K,), MAXINT, np.int32)
    labels = np.unique(np.asarray(labels, np.int32))
    ids[:len(labels)] = labels
    return ids


def _blobs(rng, H: int, W: int, count: int = 40) -> np.ndarray:
    """Raster-local labels as the labelling makes them: rectangles whose
    label is their first raster index + 1; some touch, some overlap."""
    lab = np.zeros((H, W), np.int32)
    for _ in range(count):
        y, x = rng.integers(0, H - 6), rng.integers(0, W - 24)
        h, w = rng.integers(2, 6), rng.integers(4, 24)
        lab[y:y + h, x:x + w] = y * W + x + 1
    return lab


def label_cases(H: int = 20, W: int = 500, K: int = 1024, seed: int = 0
                ) -> Iterator[Dict]:
    """Cases for the label-keyed kernels: dicts of name, lab (H, W) int32,
    prob (H, W) float32, ids (K,) int32 ascending (MAXINT = empty), axes
    (K, 2) float32 unit vectors, sy, sx, misaligned. H·W > 2 K and
    K > WINDOW are expected."""
    assert H * W > 2 * K and K > WINDOW
    rng = np.random.default_rng(seed)
    n = H * W
    i = np.arange(n, dtype=np.int32)
    axes = rng.normal(size=(K, 2)).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)

    def case(name, lab, ids, sy=1, sx=2, misaligned=False, shape=(H, W)):
        lab = np.ascontiguousarray(lab, np.int32).reshape(shape)
        return dict(name=name, lab=lab, ids=ids, axes=axes, sy=sy, sx=sx,
                    prob=rng.random(shape).astype(np.float32),
                    misaligned=misaligned)

    yield case("background", np.zeros(n), _ids([1, 2], K))
    yield case("one_label", np.ones(n), _ids([1, 2], K))
    yield case("alternating", 1 + i % 2, _ids([1, 2], K))
    # K one-cell components in raster order from cell 100 on: a block's
    # slot span exceeds the window, the cells past it go to device memory
    wide = np.where((i >= 100) & (i < 100 + K), i + 1, 0)
    yield case("span_past_window", wide, _ids(wide[wide > 0], K))
    blobs = _blobs(rng, H, W)
    kept = np.unique(blobs[blobs > 0])
    for sy, sx in ((1, 2), (2, 1), (2, 2)):
        yield case(f"blobs_{sy}x{sx}", blobs, _ids(kept, K), sy, sx)
    # every second component is not kept; so are a label below the first id
    # and one above the last
    some = blobs.copy()
    some[0, :7] = 1 if kept[0] > 1 else 0
    some[-1, -9:] = n + 5
    yield case("labels_not_in_ids", some, _ids(kept[1::2], K))
    # a cell count that is no multiple of 4, on storage that is not 16-byte
    # aligned: scalar loads and a ragged last thread
    Hr, Wr = H - 1, W - 3
    ragged = _blobs(rng, Hr, Wr)
    yield case("ragged_misaligned", ragged, _ids(ragged[ragged > 0], K),
               misaligned=True, shape=(Hr, Wr))


def _raster_slots(rng, N: int, K: int, background: float = 0.5) -> np.ndarray:
    """Raster-local slots as the extraction makes them: ascending with
    jitter, a share of no-op cells at slot K."""
    base = np.linspace(0, K - 1, N).astype(np.int32)
    slot = np.clip(base + rng.integers(-3, 4, N), 0, K).astype(np.int32)
    slot[rng.random(N) < background] = K
    return slot


def slot_cases(N: int = 10000, K: int = 1024, seed: int = 0
               ) -> Iterator[Dict]:
    """Cases for the slot-keyed kernels: dicts of name, slot (N,) int32,
    vals (N, C) float32, K, misaligned. The sum takes `vals` as it is; a
    caller of the min masks the no-op cells' values to its sentinel first,
    as the extraction does. N > 2 K and K > WINDOW are expected."""
    assert N > 2 * K and K > WINDOW
    rng = np.random.default_rng(seed)
    i = np.arange(N, dtype=np.int32)

    def case(name, slot, C=7, misaligned=False):
        slot = np.ascontiguousarray(slot, np.int32)
        vals = (rng.normal(size=(len(slot), C)) * 100).astype(np.float32)
        return dict(name=name, slot=slot, vals=vals, K=K,
                    misaligned=misaligned)

    yield case("background", np.full(N, K))
    yield case("one_slot", np.zeros(N))
    yield case("alternating", i % 2)
    # K one-cell runs in raster order from cell 100 on: a block's slot span
    # exceeds the window
    yield case("span_past_window",
               np.where((i >= 100) & (i < 100 + K), i - 100, K))
    for C in (1, 4, 7):
        yield case(f"raster_c{C}", _raster_slots(rng, N, K), C)
    # slots below 0 and above K are no-ops like K itself
    wild = _raster_slots(rng, N, K)
    pick = rng.random(N)
    wild[pick < 0.1] = -1
    wild[(pick >= 0.1) & (pick < 0.2)] = K + 7
    wild[(pick >= 0.2) & (pick < 0.25)] = -MAXINT
    yield case("slots_outside_range", wild)
    yield case("ragged_misaligned", _raster_slots(rng, N - 3, K, 0.3),
               misaligned=True)

"""Crop routing: width buckets + batch-size buckets. Copy of
onnxocr_tpu/pipeline/batching.py (the parts the recognizer reads)."""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

WIDTH_EXTEND_STEP = 320
WIDTH_HARD_CAP = 3200
# crops at or below this desired width share one bucket (the page max)
COLLAPSE_CAP = 960


def pick_width_bucket(desired_w: int, ladder: Sequence[int]) -> int:
    for w in ladder:
        if desired_w <= w:
            return w
    if desired_w >= WIDTH_HARD_CAP:
        return WIDTH_HARD_CAP
    return int(math.ceil(desired_w / WIDTH_EXTEND_STEP) * WIDTH_EXTEND_STEP)


def pick_batch_bucket(n: int, ladder: Sequence[int]) -> int:
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


def chunks_of(indices: List[int], max_batch: int):
    for i in range(0, len(indices), max_batch):
        yield indices[i:i + max_batch]


def group_collapsed(desired_ws: Sequence[int], ladder: Sequence[int]
                    ) -> Dict[int, List[int]]:
    """Single-bucket routing for the width-masked recognizer: all crops ≤
    COLLAPSE_CAP run in one bucket sized for the widest of them; wider
    crops route per bucket. → {bucket_w: [indices in input order]}."""
    lo = [i for i, w in enumerate(desired_ws) if w <= COLLAPSE_CAP]
    hi = [i for i, w in enumerate(desired_ws) if w > COLLAPSE_CAP]
    groups: Dict[int, List[int]] = {}
    if lo:
        groups[pick_width_bucket(max(desired_ws[i] for i in lo),
                                 ladder)] = lo
    for i in hi:
        groups.setdefault(pick_width_bucket(desired_ws[i], ladder),
                          []).append(i)
    return groups


def group_by_bucket(desired_ws: Sequence[int], ladder: Sequence[int]
                    ) -> Dict[int, List[int]]:
    """Per-bucket routing for a recognizer that does not mask width (the
    CRNN): each crop runs in its own width bucket. → {bucket_w: [indices
    in input order]}."""
    groups: Dict[int, List[int]] = {}
    for i, w in enumerate(desired_ws):
        groups.setdefault(pick_width_bucket(w, ladder), []).append(i)
    return groups

"""What decides `correct`: the program's answers in the window, or the
sample of them the seed draws, held against the plain reference
(ocrbench/reference/), which computes them again from the same pages and
checkpoints. The numbers, each against the limit the cell's limits file
gives it:

* det_prob_gap: the widest gap between the program's det map (kept from
  the timed path for each sampled request) and the reference's, over the
  resized page;
* box_gap_px: DB extraction. The reference's boxes (its map, its
  extraction, its recognizer's drop_score) against the program's: each
  box's distance to the nearest box of the other side (the farthest of
  its four corners, px on the page, at most 10 where none is near), the
  mean over the boxes of both sides;
* rec_gap: the recognizer, over every line the program answered: the
  reference reads the line at the program's box; a line whose text
  differs reads 1, one whose text agrees the gap between the two scores;
  the widest over the lines.

A request that failed, or a sampled request that was not answered, makes
the run not correct."""
from __future__ import annotations

import os
import re
from typing import Dict, List

import numpy as np
import torch

from .reference import nets, ocr
from .spec import ROOT

CAP_PX = 10.0


def _text_ids(text: str, n_lines: int):
    """The stand-in dictionary's text ("<12><7> <3>") → class ids: entry k
    is class k + 1, the space the last class."""
    out = []
    for m in re.finditer(r"<(\d+)>| ", text):
        out.append(int(m.group(1)) + 1 if m.group(1) else n_lines + 1)
    return tuple(out)


def _box_gap(a: np.ndarray, b: np.ndarray) -> List[float]:
    """Each box of a: the farthest-corner distance to its nearest box of
    b, capped."""
    if len(a) == 0:
        return []
    if len(b) == 0:
        return [CAP_PX] * len(a)
    d = np.linalg.norm(a[:, None] - b[None], axis=-1).max(-1)  # (A, B)
    return np.minimum(d.min(1), CAP_PX).tolist()


def det_settings(cell) -> dict:
    det = dict(cell.config["det"])
    prog = cell.traffic.get("program", {})
    det["limit_side_len"] = float(prog.get("det_limit_side_len", 960))
    return det


def _params(path: str, device):
    return nets.load(os.path.join(ROOT, path), device)


def judge_pages(cell, traffic, answers, maps, sample, device) -> Dict:
    """The three numbers over the sampled requests."""
    det, rec = det_settings(cell), cell.config["rec"]
    drop = float(cell.config["program"].get("drop_score", 0.5))
    det_p = _params(det["params"], device)
    rec_p = _params(rec["params"], device)
    mask = ocr.support_mask(os.path.join(ROOT, rec["support"]),
                            rec["dict_lines"] + 2, device)
    by_index = {a.index: a for a in answers}
    prob_gap, box_gaps, rec_gap, lines = 0.0, [], 0.0, 0
    ref_cache = {}
    for i in sample:
        ans = by_index.get(i)
        if ans is None or ans.error is not None or i not in maps:
            return {"sampled_requests_answered": 0.0}
        page = traffic.images[i % len(traffic.images)]
        h, w = page.shape[:2]
        if i % len(traffic.images) not in ref_cache:
            ref_map = ocr.det_map(det_p, page, det, device)
            ref_boxes = ocr.db_boxes(ref_map, h, w, det)
            ref_rec = ocr.recognize(rec_p, rec, page, ref_boxes, mask,
                                    device)
            kept = np.asarray([b for b, r in zip(ref_boxes, ref_rec)
                               if r[1] >= drop], np.float32).reshape(-1, 4, 2)
            ref_cache[i % len(traffic.images)] = (ref_map, kept)
        ref_map, ref_kept = ref_cache[i % len(traffic.images)]
        prog_map, (rh, rw) = maps[i]
        prog_map = prog_map[:rh, :rw].float().cpu().numpy()
        prob_gap = max(prob_gap, float(np.abs(prog_map - ref_map).max()))
        lines_out = ans.result[0] if ans.result else []
        prog_boxes = np.asarray([ln[0] for ln in lines_out],
                                np.float32).reshape(-1, 4, 2)
        box_gaps += _box_gap(prog_boxes, ref_kept) + \
            _box_gap(ref_kept, prog_boxes)
        again = ocr.recognize(rec_p, rec, page, prog_boxes, mask, device)
        for ln, (ids, score) in zip(lines_out, again):
            text, p_score = ln[1]
            same = _text_ids(text, rec["dict_lines"]) == ids
            rec_gap = max(rec_gap, abs(float(p_score) - score) if same
                          else 1.0)
            lines += 1
    return {"det_prob_gap": prob_gap,
            "box_gap_px": float(np.mean(box_gaps)) if box_gaps else CAP_PX,
            "rec_gap": rec_gap, "lines_compared": float(lines)}


def judge_lines(cell, traffic, answers, sample, device) -> Dict:
    rec = cell.config["rec"]
    rec_p = _params(rec["params"], device)
    mask = ocr.support_mask(os.path.join(ROOT, rec["support"]),
                            rec["dict_lines"] + 2, device)
    by_index = {a.index: a for a in answers}
    rec_gap, lines = 0.0, 0
    for i in sample:
        ans = by_index.get(i)
        if ans is None or ans.error is not None:
            return {"sampled_requests_answered": 0.0}
        req = traffic.images[i % len(traffic.images)]
        again = ocr.recognize_lines(rec_p, rec, req, mask, device)
        for (text, p_score), (ids, score) in zip(ans.result[0], again):
            same = _text_ids(text, rec["dict_lines"]) == ids
            rec_gap = max(rec_gap, abs(float(p_score) - score) if same
                          else 1.0)
            lines += 1
    return {"rec_gap": rec_gap, "lines_compared": float(lines)}


def verdict(numbers: Dict[str, float], limits: Dict[str, dict]):
    """→ (correct, [(name, number, limit)]) for every limited number; a
    limited number the run could not read fails."""
    rows, ok = [], True
    for name, lim in limits.items():
        if not isinstance(lim, dict) or "limit" not in lim:
            continue
        v = numbers.get(name)
        rows.append((name, v, lim["limit"]))
        if v is None or not np.isfinite(v) or v > lim["limit"]:
            ok = False
    return ok, rows


def free_cuda():
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

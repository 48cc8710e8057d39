"""Device-side DB box extraction: connected components → PCA-oriented quads
→ scores, on the card. Port of onnxocr_tpu/ops/db_device.py
(`device_boxes` / `_device_boxes_impl`). The two per-component reductions
run label-keyed (`tpu_db_reduce='pallas2'`, ops/kernels/seg_reduce2.py) or
slot-keyed (`'pallas'`, ops/kernels/seg_reduce.py; `'scatter'`, plain
index_add_ / scatter_reduce_); on a CUDA tensor the two 'pallas' forms are
the hand-written kernels.

1. binarize the valid region on the working grid (block max-pool of the
   map for the mask, block mean for scores);
2. label 8-connected components: segmented max-scans along rows and
   columns in both directions (3 sweeps), then a 3×3 max-pool to fixpoint,
   capped at 256 iterations;
3. keep ≤ max_k components by raster rank of their representative seed;
4. moment sums → PCA axes → projection extents → unclip (DB d = A·r/P);
5. score each geometric survivor by the mean prob under its pre-unclip quad
   (even-odd raster convention, against a row prefix sum).

PyTorch has no segmented associative scan; the segmented running max is a
plain cummax over the int64 key seg_id·(N+1) + label (seg_id = running
count of resets), with the segment offset subtracted afterwards. Labelling
and the scorer are plain PyTorch (XLA, not Pallas, in the JAX package).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import seg_reduce, seg_reduce2

MAXINT = 2147483647
BIG = 3.4e38
# tpu_db_reduce values: 'scan' and 'dot' are XLA lowerings of the scatter
# sums in the JAX package and compute the scatter form here
REDUCES = ("scatter", "scan", "dot", "pallas", "pallas2")


def parse_extract_scale(val) -> Tuple[int, int]:
    """Config value → (sy, sx): int (isotropic) or 'SYxSX'."""
    if isinstance(val, (tuple, list)):
        return int(val[0]), int(val[1])
    if isinstance(val, str) and "x" in val:
        a, _, b = val.partition("x")
        return int(a), int(b)
    s = int(val)
    return s, s


def _seg_scan(values: torch.Tensor, resets: torch.Tensor, dim: int,
              reverse: bool = False) -> torch.Tensor:
    """Running max of int `values` (0 <= v <= N) since the last True of
    `resets` (inclusive) along `dim`."""
    if reverse:
        return _seg_scan(values.flip(dim), resets.flip(dim), dim).flip(dim)
    n1 = values.numel() + 1
    seg = torch.cumsum(resets.to(torch.int64), dim=dim) * n1
    return (torch.cummax(seg + values, dim=dim).values - seg).to(values.dtype)


def _flood_scans(lab, mask, n_sweeps: int = 3):
    gaps = ~mask
    m = mask.to(lab.dtype)
    for _ in range(n_sweeps):
        lab = _seg_scan(lab, gaps, 1) * m
        lab = _seg_scan(lab, gaps, 1, reverse=True) * m
        lab = _seg_scan(lab, gaps, 0) * m
        lab = _seg_scan(lab, gaps, 0, reverse=True) * m
    return lab


def _dilate_converge(lab, mask, max_iters: int = 256, check_every: int = 4):
    """3×3 max-pool (times mask) until fixpoint, at most max_iters pools.
    Pools past the fixpoint change nothing, so the host checks for change
    only every `check_every` pools. Labels (< 2^24) are exact in float32."""
    m = mask.to(torch.float32)[None, None]
    x = lab.to(torch.float32)[None, None]
    done = 0
    while done < max_iters:
        prev = x
        for _ in range(min(check_every, max_iters - done)):
            x = F.max_pool2d(x, 3, stride=1, padding=1) * m
        done += check_every
        if torch.equal(x, prev):
            break
    return x[0, 0].to(lab.dtype)


def working_grid(prob: torch.Tensor, resize_h: int, resize_w: int,
                 sy: int, sx: int):
    """(H, W) map → (block max-pool for the mask, block mean for scores,
    valid extent on the grid) for the (sy, sx) working grid."""
    if sy == 1 and sx == 1:
        return prob, prob, resize_h, resize_w
    Hp, Wp = prob.shape[0] // sy, prob.shape[1] // sx
    blocks = prob[:Hp * sy, :Wp * sx].reshape(Hp, sy, Wp, sx)
    return (blocks.amax(dim=(1, 3)).contiguous(), blocks.mean(dim=(1, 3)),
            -(-resize_h // sy), -(-resize_w // sx))


def label_components(prob_mask: torch.Tensor, resize_h: int, resize_w: int,
                     max_k: int, thresh: float):
    """Binarize + label the working grid. → (lab (H, W) int32 labels,
    seeds = raster index + 1; ids (max_k,) int32 ascending kept seeds,
    MAXINT for empty slots; in_valid (H, W) bool)."""
    H, W = prob_mask.shape
    dev = prob_mask.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    in_valid = (ys < resize_h) & (xs < resize_w)
    mask = (prob_mask > thresh) & in_valid
    seed = torch.where(mask, (ys * W + xs + 1).to(torch.int32), 0)
    lab = _flood_scans(seed, mask)
    lab = _dilate_converge(lab, mask)
    # representatives (their own seed survived), ranked in raster order;
    # past max_k the raster-first ones are kept
    reps = (mask & (lab == seed)).reshape(-1)
    rank = torch.cumsum(reps.to(torch.int64), 0) - 1
    tgt = torch.where(reps & (rank < max_k), rank, max_k)
    ids = torch.full((max_k + 1,), MAXINT, dtype=torch.int32, device=dev)
    ids.scatter_reduce_(0, tgt, torch.where(reps, seed.reshape(-1), MAXINT),
                        "amin")
    return lab.contiguous(), ids[:max_k].contiguous(), in_valid


def label_slots(lab: torch.Tensor, max_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """lab (H, W) int32 labels → (slot (N,) int32 in [0, max_k], hit (N,)
    bool). Every representative (the cell whose label is its own raster
    index + 1) scatters its raster rank at its label's index of a slot map
    and every cell gathers slot_map[label]; cells of the background and of
    components past the budget get max_k and hit False."""
    flat = lab.reshape(-1).to(torch.int64)
    n = flat.shape[0]
    reps = flat == torch.arange(1, n + 1, device=lab.device)
    rank = torch.cumsum(reps.to(torch.int64), 0) - 1
    slot_map = torch.full((n + 2,), max_k, dtype=torch.int32,
                          device=lab.device)
    # non-representatives write to a dump entry that no label reads
    slot_map.scatter_(0, torch.where(reps, flat, n + 1),
                      torch.clamp(rank, max=max_k).to(torch.int32))
    slot = slot_map[flat]
    return slot, (flat > 0) & (slot < max_k)


def cell_coords(H: int, W: int, sy: int, sx: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,) float32 full-map x and y of the working grid's cell centres."""
    ys = torch.arange(H, device=device, dtype=torch.float32)
    xs = torch.arange(W, device=device, dtype=torch.float32)
    fy = (ys * sy + (sy - 1) * 0.5)[:, None].expand(H, W).reshape(-1)
    fx = (xs * sx + (sx - 1) * 0.5)[None, :].expand(H, W).reshape(-1)
    return fx, fy


def moment_stats(prob: torch.Tensor, hit: torch.Tensor, fx, fy
                 ) -> torch.Tensor:
    """(N, 7) float32 [1, x, y, x², y², xy, p] per cell, 0 where not hit."""
    stats = torch.stack([torch.ones_like(fx), fx, fy, fx * fx, fy * fy,
                         fx * fy, prob.reshape(-1)], -1)
    return torch.where(hit[:, None], stats, 0.0)


def proj_columns(slot: torch.Tensor, hit: torch.Tensor, axes: torch.Tensor,
                 fx, fy) -> torch.Tensor:
    """(N, 4) float32 [pu, pv, −pu, −pv]: each cell projected on its slot's
    axes, 3.4e38 where not hit."""
    a = axes[torch.clamp(slot, max=axes.shape[0] - 1).to(torch.int64)]
    ux, uy = a[:, 0], a[:, 1]
    pu = fx * ux + fy * uy
    pv = fx * (-uy) + fy * ux
    cols = torch.stack([pu, pv, -pu, -pv], -1)
    return torch.where(hit[:, None], cols, BIG)


def pca_axes(acc: torch.Tensor, axis_snap: float = 0.0) -> torch.Tensor:
    """(K, 7) moment sums → (K, 2) unit major axes [ux, uy]. axis_snap > 0
    snaps axes within tan(angle) <= axis_snap of an image axis onto it."""
    n = torch.clamp(acc[:, 0], min=1.0)
    mx, my = acc[:, 1] / n, acc[:, 2] / n
    cxx = acc[:, 3] / n - mx * mx
    cyy = acc[:, 4] / n - my * my
    cxy = acc[:, 5] / n - mx * my
    tr_half = (cxx + cyy) * 0.5
    det = cxx * cyy - cxy * cxy
    l1 = tr_half + torch.sqrt(torch.clamp(tr_half * tr_half - det, min=0.0))
    small = torch.abs(cxy) <= 1e-9
    ex = torch.where(small, (cxx >= cyy).to(acc.dtype), cxy)
    ey = torch.where(small, (cxx < cyy).to(acc.dtype), l1 - cxx)
    norm = torch.sqrt(ex * ex + ey * ey)
    ux, uy = ex / norm, ey / norm
    if axis_snap > 0:
        horiz = torch.abs(uy) <= axis_snap * torch.abs(ux)
        vert = ~horiz & (torch.abs(ux) <= axis_snap * torch.abs(uy))
        sgn_x = torch.where(ux >= 0, 1.0, -1.0)
        sgn_y = torch.where(uy >= 0, 1.0, -1.0)
        ux, uy = (torch.where(horiz, sgn_x, torch.where(vert, 0.0, ux)),
                  torch.where(horiz, 0.0, torch.where(vert, sgn_y, uy)))
    return torch.stack([ux, uy], -1).contiguous()


def quads_vs_csum(csum: torch.Tensor, quads: torch.Tensor,
                  page: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(H, W+1) exclusive row prefix sums + (K, 4, 2) quads → (K,) mean
    over each quad's even-odd raster mask (pixel (x, y) inside iff an odd
    number of edge crossings lie strictly right of x), with the host
    scorer's integer vertex quantization. A stack of pages' sums (B, H,
    W+1) takes `page` (K,), the page each quad is scored against."""
    H = csum.shape[-2]
    W = csum.shape[-1] - 1
    K = quads.shape[0]
    dev = quads.device
    bx = torch.clamp(torch.floor(quads[..., 0].amin(1)), 0, W - 1)
    by = torch.clamp(torch.floor(quads[..., 1].amin(1)), 0, H - 1)
    qx = torch.trunc(quads[..., 0] - bx[:, None]) + bx[:, None]
    qy = torch.trunc(quads[..., 1] - by[:, None]) + by[:, None]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :]
    x_lo = torch.full((K, H), float(W), device=dev)
    x_hi = torch.zeros((K, H), device=dev)
    n_cross = torch.zeros((K, H), dtype=torch.int32, device=dev)
    for i in range(4):
        j = (i + 3) % 4
        yi, yj = qy[:, i:i + 1], qy[:, j:j + 1]
        xi, xj = qx[:, i:i + 1], qx[:, j:j + 1]
        crosses = (yi > ys) != (yj > ys)
        t = (ys - yi) / torch.where(yj == yi, 1.0, yj - yi)
        xint = xi + (xj - xi) * t
        x_lo = torch.where(crosses, torch.minimum(x_lo, xint), x_lo)
        x_hi = torch.where(crosses, torch.maximum(x_hi, xint), x_hi)
        n_cross = n_cross + crosses.to(torch.int32)
    has = n_cross >= 2
    lo = torch.clamp(torch.ceil(x_lo), 0, W).to(torch.int64)
    hi = torch.clamp(torch.ceil(x_hi), 0, W).to(torch.int64)
    lo = torch.minimum(lo, hi)
    if page is None:
        seg_sum = torch.gather(csum.expand(K, H, W + 1), 2,
                               hi[..., None])[..., 0] - \
            torch.gather(csum.expand(K, H, W + 1), 2, lo[..., None])[..., 0]
    else:
        # each quad's rows of its own page, read from the flat stack
        flat = csum.reshape(-1)
        row = (page.to(torch.int64)[:, None] * H +
               torch.arange(H, device=dev)[None, :]) * (W + 1)
        seg_sum = flat[row + hi] - flat[row + lo]
    seg_cnt = (hi - lo).to(torch.float32)
    total = torch.where(has, seg_sum, 0.0).sum(1)
    count = torch.where(has, seg_cnt, 0.0).sum(1)
    return torch.where(count > 0, total / torch.clamp(count, min=1.0), 0.0)


def quad_mask_mean(prob: torch.Tensor, quads: torch.Tensor,
                   in_valid: torch.Tensor) -> torch.Tensor:
    """(H, W) map, (K, 4, 2) quads in map coordinates, (H, W) valid mask →
    (K,) mean of the map inside each quad's even-odd raster mask, the host
    scorer's convention (the bitmap wire's candidate scores; port of
    `_quad_mask_mean`)."""
    masked = torch.where(in_valid, prob, 0.0)
    return quads_vs_csum(F.pad(torch.cumsum(masked, dim=1), (1, 0)), quads)


def quad_mask_mean_multi(probs: torch.Tensor, rhw: torch.Tensor,
                         quads: torch.Tensor, img_idx: torch.Tensor
                         ) -> torch.Tensor:
    """quad_mask_mean over a stack of pages (the cross-request rec
    batcher's scores): probs (B, H, W) with valid extents rhw (B, 2), quads
    (K, 4, 2) each scored against its page img_idx (K,) → (K,). Port of
    `quad_mask_mean_multi`; each quad reads its own page's prefix sums."""
    B, H, W = probs.shape
    dev = probs.device
    row = torch.arange(H, device=dev)[None, :, None] < rhw[:, 0, None, None]
    col = torch.arange(W, device=dev)[None, None, :] < rhw[:, 1, None, None]
    masked = torch.where(row & col, probs, 0.0)
    return quads_vs_csum(F.pad(torch.cumsum(masked, dim=2), (1, 0)), quads,
                         img_idx)


def device_boxes(prob: torch.Tensor, resize_h: int, resize_w: int,
                 max_k: int = 256, thresh: float = 0.3,
                 box_thresh: float = 0.6, unclip_ratio: float = 1.5,
                 min_size: float = 3.0, scale=1, score_scale=1,
                 reduce: str = "scatter", score_k: int = 0,
                 axis_snap: float = 0.0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """prob (H, W) float32 map (padded; valid resize_h × resize_w).
    → (quads (max_k, 4, 2) float32 map coords, unclipped PCA rectangles
    [tl, tr, br, bl]; scores (max_k,); valid (max_k,) bool).

    reduce picks the per-component reductions: 'pallas2' the label-keyed
    kernels, 'pallas' the slot-keyed kernels (both launch on a CUDA tensor
    or raise, and run their plain versions on a CPU tensor), 'scatter'
    plain index_add_ / scatter_reduce_. 'scan' and 'dot' name XLA lowerings
    of the same sums in the JAX package; here they compute the scatter
    form. score_scale pools the score grid further; axis_snap snaps
    near-axis-aligned PCA axes (see pca_axes)."""
    if reduce not in REDUCES:
        raise ValueError(f"tpu_db_reduce must be one of {REDUCES}, got "
                         f"{reduce!r}")
    sy, sx = parse_extract_scale(scale)
    ssy, ssx = parse_extract_scale(score_scale)
    prob_mask, prob_score, resize_h, resize_w = working_grid(
        prob, resize_h, resize_w, sy, sx)
    prob_mask = prob_mask.contiguous()
    lab, ids, in_valid = label_components(prob_mask, resize_h, resize_w,
                                          max_k, thresh)
    present = ids < MAXINT
    H, W = lab.shape

    if reduce == "pallas2":
        acc = seg_reduce2.label_moment_sums(lab, prob_mask, ids, sy, sx)
    else:
        slot, hit = label_slots(lab, max_k)
        fx, fy = cell_coords(H, W, sy, sx, lab.device)
        stats = moment_stats(prob_mask, hit, fx, fy)
        if reduce == "pallas":
            acc = seg_reduce.seg_sum_bands(slot, stats, max_k)
        else:
            acc = seg_reduce.seg_sum_bands_plain(slot, stats, max_k)
    axes = pca_axes(acc, axis_snap)
    ux, uy = axes[:, 0], axes[:, 1]
    vx, vy = -uy, ux
    if reduce == "pallas2":
        ext = seg_reduce2.label_proj_extents(lab, axes, ids, sy, sx)
    else:
        cols = proj_columns(slot, hit, axes, fx, fy)
        if reduce == "pallas":
            ext = seg_reduce.seg_min_bands(slot, cols, max_k, BIG)
        else:
            ext = seg_reduce.seg_min_bands_plain(slot, cols, max_k, BIG)
    mins = ext[:, :2]
    maxs = -ext[:, 2:]

    w_rect = maxs[:, 0] - mins[:, 0]
    h_rect = maxs[:, 1] - mins[:, 1]
    sside = torch.minimum(w_rect, h_rect)
    area = torch.clamp(w_rect * h_rect, min=1e-6)
    perim = torch.clamp(2.0 * (w_rect + h_rect), min=1e-6)
    d = area * unclip_ratio / perim
    w2 = w_rect * 0.5 + d
    h2 = h_rect * 0.5 + d

    cu = (mins[:, 0] + maxs[:, 0]) * 0.5
    cv = (mins[:, 1] + maxs[:, 1]) * 0.5
    c = torch.stack([cu * ux + cv * vx, cu * uy + cv * vy], -1)
    u = torch.stack([ux, uy], -1)
    v = torch.stack([vx, vy], -1)

    def rect(hw, hh):
        du, dv = u * hw[:, None], v * hh[:, None]
        return torch.stack([c - du - dv, c + du - dv, c + du + dv,
                            c - du + dv], 1)

    quads = rect(w2, h2)
    pre_quads = rect(w_rect * 0.5, h_rect * 0.5)

    # scorer on the working grid: full coords → grid coords; score_scale
    # (ssy, ssx) mean-pools the score grid further
    grid_prob, grid_valid, tx, ty = prob_score, in_valid, sx, sy
    if ssy > 1 or ssx > 1:
        Hs, Ws = H // ssy, W // ssx
        grid_prob = prob_score[:Hs * ssy, :Ws * ssx].reshape(
            Hs, ssy, Ws, ssx).mean(dim=(1, 3))
        grid_valid = (torch.arange(Hs, device=prob.device)[:, None]
                      < -(-resize_h // ssy)) & \
            (torch.arange(Ws, device=prob.device)[None, :]
             < -(-resize_w // ssx))
        tx, ty = sx * ssx, sy * ssy
    off = torch.tensor([(tx - 1) * 0.5, (ty - 1) * 0.5], device=prob.device)
    sc = torch.tensor([float(tx), float(ty)], device=prob.device)
    q_grid = (pre_quads - off) / sc
    masked = torch.where(grid_valid, grid_prob, 0.0)
    csum = F.pad(torch.cumsum(masked, dim=1), (1, 0))

    post_sside = torch.minimum(w_rect + 2 * d, h_rect + 2 * d)
    geo = present & (sside >= min_size) & (post_sside >= min_size + 2)
    if 0 < score_k < max_k and int(geo.sum()) <= score_k:
        # score only the geometric survivors (raster order kept); when they
        # overflow the budget every candidate is scored instead
        take = torch.argsort((~geo).to(torch.int32), stable=True)[:score_k]
        score = torch.zeros(max_k, device=prob.device)
        score[take] = quads_vs_csum(csum, q_grid[take])
    else:
        score = quads_vs_csum(csum, q_grid)
    valid = geo & (score >= box_thresh)
    return quads, score, valid


def unpack_boxes(packed: np.ndarray, resize_w: int, resize_h: int,
                 src_w: int, src_h: int) -> np.ndarray:
    """Host side of the device det path: the valid rows of a (K, 10) packed
    array [quad (8), score, valid], rescaled map → source coords with the
    reference's round / clip contract. → (N, 4, 2) int32."""
    rows = packed[packed[:, 9] > 0.5]
    quads = rows[:, :8].reshape(-1, 4, 2).astype(np.float64)
    quads[..., 0] = np.clip(np.round(quads[..., 0] / resize_w * src_w),
                            0, src_w)
    quads[..., 1] = np.clip(np.round(quads[..., 1] / resize_h * src_h),
                            0, src_h)
    return quads.astype(np.int32)

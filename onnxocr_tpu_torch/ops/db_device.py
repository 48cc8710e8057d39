"""Device-side DB box extraction: connected components → PCA-oriented quads
→ scores, on the card. Port of onnxocr_tpu/ops/db_device.py
(`device_boxes` / `_device_boxes_impl`) with the label-keyed reductions
(`tpu_db_reduce='pallas2'`), which are the hand-written kernels of
ops/kernels/seg_reduce2.py on a CUDA tensor.

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

from typing import Tuple

import torch
import torch.nn.functional as F

from .kernels import seg_reduce2

MAXINT = 2147483647
BIG = 3.4e38


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


def pca_axes(acc: torch.Tensor) -> torch.Tensor:
    """(K, 7) moment sums → (K, 2) unit major axes [ux, uy]."""
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
    return torch.stack([ex / norm, ey / norm], -1).contiguous()


def quads_vs_csum(csum: torch.Tensor, quads: torch.Tensor) -> torch.Tensor:
    """(H, W+1) exclusive row prefix sums + (K, 4, 2) quads → (K,) mean
    over each quad's even-odd raster mask (pixel (x, y) inside iff an odd
    number of edge crossings lie strictly right of x), with the host
    scorer's integer vertex quantization."""
    H = csum.shape[0]
    W = csum.shape[1] - 1
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
    seg_sum = torch.gather(csum.expand(K, H, W + 1), 2, hi[..., None])[..., 0] \
        - torch.gather(csum.expand(K, H, W + 1), 2, lo[..., None])[..., 0]
    seg_cnt = (hi - lo).to(torch.float32)
    total = torch.where(has, seg_sum, 0.0).sum(1)
    count = torch.where(has, seg_cnt, 0.0).sum(1)
    return torch.where(count > 0, total / torch.clamp(count, min=1.0), 0.0)


def device_boxes(prob: torch.Tensor, resize_h: int, resize_w: int,
                 max_k: int = 256, thresh: float = 0.3,
                 box_thresh: float = 0.6, unclip_ratio: float = 1.5,
                 min_size: float = 3.0, scale=1, score_k: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """prob (H, W) float32 map (padded; valid resize_h × resize_w).
    → (quads (max_k, 4, 2) float32 map coords, unclipped PCA rectangles
    [tl, tr, br, bl]; scores (max_k,); valid (max_k,) bool)."""
    sy, sx = parse_extract_scale(scale)
    prob_mask, prob_score, resize_h, resize_w = working_grid(
        prob, resize_h, resize_w, sy, sx)
    lab, ids, in_valid = label_components(prob_mask, resize_h, resize_w,
                                          max_k, thresh)
    present = ids < MAXINT

    acc = seg_reduce2.label_moment_sums(lab, prob_mask.contiguous(), ids,
                                        sy, sx)
    axes = pca_axes(acc)
    ux, uy = axes[:, 0], axes[:, 1]
    vx, vy = -uy, ux
    ext = seg_reduce2.label_proj_extents(lab, axes, ids, sy, sx)
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

    # scorer on the working grid: full coords → grid coords
    off = torch.tensor([(sx - 1) * 0.5, (sy - 1) * 0.5], device=prob.device)
    sc = torch.tensor([float(sx), float(sy)], device=prob.device)
    q_grid = (pre_quads - off) / sc
    masked = torch.where(in_valid, prob_score, 0.0)
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

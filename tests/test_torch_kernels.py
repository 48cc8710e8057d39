"""The port's kernel wrappers on the CPU (their plain PyTorch versions) vs
the JAX Pallas kernels in interpret mode, on inputs made with numpy from a
seed. The CUDA kernels themselves are held against these plain versions on
the card by chip_smoke.py. The CTC head's kernel takes its product as three
TF32 passes over split operands: the split, the plain version of that
arithmetic and the operand prepared for the kernel are tested here."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from onnxocr_tpu.ops.pallas import ctc_head as jctc
from onnxocr_tpu.ops.pallas import seg_reduce as jband
from onnxocr_tpu.ops.pallas import seg_reduce2 as jseg

import chip_smoke
from onnxocr_tpu_torch.ops.kernels import build, ctc_head, patterns, \
    seg_reduce, seg_reduce2


CTC_CASES = [
    (100, 192, 5000, False),
    (10, 64, 2049, False),
    (100, 192, 5000, True),    # -1e30 bias outside a trained support
]


def _ctc_case(M, D, V, masked):
    rng = np.random.default_rng(M + V)
    x = rng.normal(size=(M, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.1).astype(np.float32)
    b = rng.normal(size=(V,)).astype(np.float32)
    support = np.sort(rng.choice(V, size=V // 20, replace=False))
    if masked:
        # the masked columns would win without the mask
        b += 5.0
        b[support] -= 5.0
        keep = np.zeros(V, bool)
        keep[support] = True
        b[~keep] -= 1e30
    ref_idx, ref_prob = jctc.ctc_head_reduce(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)
    return x, w, b, support, np.asarray(ref_idx), np.asarray(ref_prob)


@pytest.mark.parametrize("M,D,V,masked", CTC_CASES)
def test_ctc_head_plain_matches_pallas(M, D, V, masked):
    """The float32 plain version, the one the kernel is held against on the
    card."""
    x, w, b, support, ref_idx, ref_prob = _ctc_case(M, D, V, masked)
    idx, prob = ctc_head.ctc_head_reduce_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert idx.dtype == torch.int32 and prob.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_allclose(prob.numpy(), ref_prob, rtol=1e-5, atol=1e-6)
    if masked:
        assert np.isin(idx.numpy(), support).all()


@pytest.mark.parametrize("M,D,V,masked", CTC_CASES)
def test_ctc_head_3xtf32_plain_matches_pallas(M, D, V, masked):
    """The kernel's arithmetic (three TF32 passes over split operands, one
    float32 accumulator) against the float32 Pallas kernel, through the
    wrapper on CPU tensors: the split drops only the x_lo·W_lo term, 2⁻²²
    of each product, so the float32 tolerances hold unchanged."""
    x, w, b, support, ref_idx, ref_prob = _ctc_case(M, D, V, masked)
    X, B = torch.from_numpy(x), torch.from_numpy(b)
    w_split = ctc_head.split_head(torch.from_numpy(w))
    build.LAUNCHES.clear()
    idx, prob = ctc_head.ctc_head_reduce(X, w_split, B)
    assert sum(build.LAUNCHES.values()) == 0
    assert idx.dtype == torch.int32 and prob.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_allclose(prob.numpy(), ref_prob, rtol=1e-5, atol=1e-6)
    if masked:
        assert np.isin(idx.numpy(), support).all()
    # on a CPU tensor the wrapper is the plain version of the kernel
    pidx, pprob = ctc_head.ctc_head_reduce_3xtf32_plain(X, w_split, B)
    assert torch.equal(idx, pidx) and torch.equal(prob, pprob)


def test_ctc_head_first_index_on_ties():
    x = torch.ones((3, 16))
    w = torch.zeros((16, 40))
    w[:, [7, 19, 33]] = 1.0
    idx, prob = ctc_head.ctc_head_reduce(x, ctc_head.split_head(w),
                                         torch.zeros(40))
    assert idx.tolist() == [7, 7, 7]
    s = 3 * np.exp(16.0) + 37
    np.testing.assert_allclose(prob.numpy(), np.exp(16.0) / s, rtol=1e-6)


def _split_inputs(seed):
    """Normal values over many binades, denormals, ±0 and the support
    bias."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=4096) * np.exp2(rng.integers(-100, 100, size=4096))
    den = rng.integers(1, 1 << 23, size=64).astype(np.uint32)
    den[::2] |= np.uint32(1 << 31)
    special = np.array([0.0, -0.0, -1e30, 1e30, 1.0, -1.0, 1 + 2.0 ** -11,
                        -(1 + 2.0 ** -11), 1 + 2.0 ** -12 + 2.0 ** -23])
    return np.concatenate([v, special]).astype(np.float32), \
        den.view(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32(seed):
    """hi and lo are TF32 values (low 13 mantissa bits clear); hi + lo
    reproduces the input to 2⁻²¹ relative, plus 2⁻¹³⁶ (2¹³ units of the
    smallest denormal) where lo itself is denormal; hi is the nearest TF32
    value, ties away from zero; ±0 keep their sign."""
    normal, den = _split_inputs(seed)
    v = np.concatenate([normal, den])
    hi, lo = (t.numpy() for t in ctc_head.split_tf32(torch.from_numpy(v)))
    assert hi.dtype == lo.dtype == np.float32
    assert (hi.view(np.uint32) & 0x1fff == 0).all()
    assert (lo.view(np.uint32) & 0x1fff == 0).all()
    v64 = v.astype(np.float64)
    err = np.abs(hi.astype(np.float64) + lo - v64)
    assert (err <= 2.0 ** -21 * np.abs(v64) + 2.0 ** -136).all()
    big = np.abs(normal) >= 2.0 ** -100
    rel = np.abs(hi[:len(normal)][big].astype(np.float64) - normal[big]) \
        / np.abs(normal[big])
    assert rel.max() <= 2.0 ** -11
    one = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 0.0, -0.0],
                   np.float32)
    h1, _ = ctc_head.split_tf32(torch.from_numpy(one))
    assert h1.tolist()[:2] == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]
    assert np.signbit(h1.numpy()).tolist() == [False, True, False, True]


def test_split_head_operand():
    """The prepared operand: (2, V, D) float32, contiguous, each half (V, D)
    K-major, on the weight's device; hi + lo is w transposed."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(64, 300)).astype(np.float32))
    ws = ctc_head.split_head(w)
    assert ws.shape == (2, 300, 64) and ws.dtype == torch.float32
    assert ws.is_contiguous() and ws.device == w.device
    assert ws[0].is_contiguous() and ws[1].shape == (300, 64)
    np.testing.assert_allclose((ws[0].double() + ws[1].double()).numpy(),
                               w.t().double().numpy(), rtol=2.0 ** -21)
    with pytest.raises(TypeError):
        ctc_head.split_head(w.double())


@pytest.mark.parametrize("M,V,want", [(3840, 18385, 2), (1280, 18385, 6),
                                      (5120, 18385, 8), (1, 100, 1)])
def test_ctc_head_split_count(M, V, want):
    """The vocab split fills the 132 SMs in whole waves of one block each
    at the shapes the paths use, and never exceeds the vocab tiles."""
    assert ctc_head.pick_splits(M, V) == want


def test_ctc_head_near_tie_rows():
    """The rows the card check builds to sit 1e-4 (relative) from a tie:
    their float64 top-2 gap is in [gap / 2, 2 gap], both orders of the
    winner occur, and the kernel's arithmetic in plain PyTorch picks the
    float64 winner with a max-prob within 1e-5 of it."""
    rng = np.random.default_rng(11)
    w = torch.from_numpy((rng.normal(size=(64, 700)) * 0.1)
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(size=700).astype(np.float32))
    b[::3] -= 1e30
    x = chip_smoke.near_tie_rows(w, b, rows=64, seed=0)
    assert x.dtype == torch.float32 and x.shape[0] >= 32
    idx64, prob64, top2 = chip_smoke.float64_head(x, w, b)
    rel = ((top2[:, 0] - top2[:, 1]) / top2[:, 0].abs()).numpy()
    assert (rel >= 0.5e-4).all() and (rel <= 2e-4).all()
    second = torch.topk(x.double() @ w.double() + b.double(), 2, 1).indices[:, 1]
    assert (idx64 < second).any() and (idx64 > second).any()
    idx, prob = ctc_head.ctc_head_reduce(x, ctc_head.split_head(w), b)
    assert torch.equal(idx, idx64)
    assert chip_smoke.max_rel(prob, prob64) <= 1e-5


def _raster_blobs(H, W, K, seed=7):
    """Raster-local labels as the labelling produces them: blobs whose label
    is their first raster index + 1 (the fixture of the Pallas tests)."""
    rng = np.random.default_rng(seed)
    lab = np.zeros((H, W), np.int32)
    for _ in range(40):
        y, x = rng.integers(0, H - 6), rng.integers(0, W - 24)
        h, w = rng.integers(2, 6), rng.integers(4, 24)
        lab[y:y + h, x:x + w] = y * W + x + 1
    prob = rng.random((H, W)).astype(np.float32)
    seeds = np.unique(lab[lab > 0])
    ids = np.full((K,), 2147483647, np.int32)
    ids[:len(seeds)] = np.sort(seeds)
    axes = rng.normal(size=(K, 2)).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return lab, prob, ids, axes, len(seeds)


@pytest.mark.parametrize("sy,sx", [(2, 1), (1, 2)])
def test_seg_reduce2_plain_matches_pallas(sy, sx):
    H, W, K = 48, 512, 256
    lab, prob, ids, axes, n = _raster_blobs(H, W, K)
    ref_sums = np.asarray(jseg.label_moment_sums(
        jnp.asarray(lab), jnp.asarray(prob), jnp.asarray(ids), W=W, sy=sy,
        sx=sx, interpret=True))
    ref_ext = np.asarray(jseg.label_proj_extents(
        jnp.asarray(lab), jnp.asarray(axes), jnp.asarray(ids), W=W, sy=sy,
        sx=sx, interpret=True))
    L, I = torch.from_numpy(lab), torch.from_numpy(ids)
    sums = seg_reduce2.label_moment_sums(L, torch.from_numpy(prob), I, sy, sx)
    ext = seg_reduce2.label_proj_extents(L, torch.from_numpy(axes), I, sy, sx)
    np.testing.assert_allclose(sums.numpy(), ref_sums, rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(ext.numpy()[:n], ref_ext[:n], rtol=1e-5,
                               atol=1e-4)
    assert (sums.numpy()[n:] == 0).all()
    assert (ext.numpy()[n:] >= 3e38).all()


def test_seg_reduce2_ignores_unkept_labels():
    """Labels that are not in ids (components past the budget) and
    background contribute nothing."""
    lab = torch.tensor([[0, 5, 5, 9], [9, 9, 0, 5]], dtype=torch.int32)
    ids = torch.tensor([5, 2147483647], dtype=torch.int32)
    sums = seg_reduce2.label_moment_sums(lab, torch.ones(2, 4), ids)
    np.testing.assert_allclose(sums.numpy()[0],
                               [3, 1 + 2 + 3, 0 + 0 + 1, 1 + 4 + 9, 1, 3, 3])
    assert (sums.numpy()[1] == 0).all()


def _raster_slots(rng, N, K, C, background=0.5):
    """Raster-local slots as the extraction produces them (the fixture of
    the Pallas tests): mostly ascending with jitter, a share of no-op cells
    at slot K; sum values zeroed and min values set to the sentinel there."""
    base = np.linspace(0, K - 1, N).astype(np.int32)
    slot = np.clip(base + rng.integers(-3, 4, N), 0, K).astype(np.int32)
    slot[rng.random(N) < background] = K
    vals = (rng.normal(size=(N, C)) * 100).astype(np.float32)
    hit = (slot < K)[:, None]
    return slot, np.where(hit, vals, 0.0).astype(np.float32), \
        np.where(hit, vals, 3.4e38).astype(np.float32)


@pytest.mark.parametrize("C", [2, 4, 7])
def test_seg_bands_plain_matches_pallas(C):
    """N is not a multiple of the Pallas band (8192), half the cells are
    background. Sums: rtol 1e-5, atol 1e-3 — the Pallas kernel accumulates
    in float32 in band order, the port in float64, so they differ by the
    float32 sum order (the JAX tests' own tolerance). Mins: rtol 1e-6,
    atol 1e-5 — a min is exact, the slack only covers the float32 image."""
    rng = np.random.default_rng(2 + C)
    K, N = 256, 3 * jband.BAND + 1000
    slot, vsum, vmin = _raster_slots(rng, N, K, C)
    ref_sums = np.asarray(jband.seg_sum_bands(
        jnp.asarray(slot), jnp.asarray(vsum), K, interpret=True))
    ref_mins = np.asarray(jband.seg_min_bands(
        jnp.asarray(slot), jnp.asarray(vmin), K, interpret=True))
    S = torch.from_numpy(slot)
    sums = seg_reduce.seg_sum_bands(S, torch.from_numpy(vsum), K)
    mins = seg_reduce.seg_min_bands(S, torch.from_numpy(vmin), K)
    assert sums.shape == mins.shape == (K, C)
    assert sums.dtype == mins.dtype == torch.float32
    np.testing.assert_allclose(sums.numpy(), ref_sums, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(mins.numpy(), ref_mins, rtol=1e-6, atol=1e-5)


def test_seg_bands_all_background_matches_pallas():
    K, N = 128, 4000
    slot = np.full((N,), K, np.int32)
    zeros = np.zeros((N, 2), np.float32)
    bigs = np.full((N, 2), 3.4e38, np.float32)
    ref_sums = np.asarray(jband.seg_sum_bands(
        jnp.asarray(slot), jnp.asarray(zeros), K, interpret=True))
    ref_mins = np.asarray(jband.seg_min_bands(
        jnp.asarray(slot), jnp.asarray(bigs), K, interpret=True))
    S = torch.from_numpy(slot)
    sums = seg_reduce.seg_sum_bands(S, torch.from_numpy(zeros), K).numpy()
    mins = seg_reduce.seg_min_bands(S, torch.from_numpy(bigs), K).numpy()
    np.testing.assert_array_equal(sums, ref_sums)
    np.testing.assert_array_equal(mins, ref_mins)
    assert (sums == 0).all() and (mins >= 3.0e38).all()


def test_seg_min_bands_own_sentinel_matches_pallas():
    """A `big` other than 3.4e38: empty slots, and slots that only saw the
    3.4e38 pre-mask, come back as the caller's `big`."""
    rng = np.random.default_rng(9)
    K, N, big = 128, jband.BAND + 77, 1.0e30
    slot, _, vmin = _raster_slots(rng, N, K, 4)
    slot[slot >= K // 2] = K                  # the upper slots stay empty
    vmin[slot == 5] = 3.4e38                  # a slot that only saw the mask
    ref = np.asarray(jband.seg_min_bands(
        jnp.asarray(slot), jnp.asarray(vmin), K, big, interpret=True))
    got = seg_reduce.seg_min_bands(torch.from_numpy(slot),
                                   torch.from_numpy(vmin), K, big).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
    assert (got[K // 2:] == np.float32(big)).all()
    assert (got[5] == np.float32(big)).all()


def test_seg_bands_ignore_slots_outside_range():
    slot = torch.tensor([0, 1, 3, 7, -1, 1], dtype=torch.int32)
    vals = torch.tensor([[1.], [2.], [4.], [8.], [16.], [32.]])
    sums = seg_reduce.seg_sum_bands(slot, vals, 3)
    mins = seg_reduce.seg_min_bands(slot, vals, 3)
    assert sums[:, 0].tolist() == [1.0, 34.0, 0.0]
    assert mins[:2, 0].tolist() == [1.0, 2.0] and mins[2, 0] >= 3e38


LABEL_CASES = {c["name"]: c for c in patterns.label_cases()}
SLOT_CASES = {c["name"]: c for c in patterns.slot_cases()}


def test_patterns_reach_every_branch():
    """The seeded grids hold what their names promise."""
    lab, slot = LABEL_CASES, SLOT_CASES
    assert set(lab) == {
        "background", "one_label", "alternating", "span_past_window",
        "blobs_1x2", "blobs_2x1", "blobs_2x2", "labels_not_in_ids",
        "ragged_misaligned"}
    assert set(slot) == {
        "background", "one_slot", "alternating", "span_past_window",
        "raster_c1", "raster_c4", "raster_c7", "slots_outside_range",
        "ragged_misaligned"}
    for c in lab.values():
        ids = c["ids"]
        assert c["lab"].dtype == ids.dtype == np.int32
        assert (np.diff(ids.astype(np.int64)) >= 0).all()
        assert c["lab"].max() < 2 ** 24      # exact as float32 on the JAX side
    assert not lab["background"]["lab"].any()
    assert (lab["one_label"]["lab"] == 1).all()
    assert set(lab["alternating"]["lab"].ravel()[:4]) == {1, 2}
    wide = lab["span_past_window"]
    run = wide["lab"].ravel()[:1024]         # the first block's cells
    kept = np.searchsorted(wide["ids"], run[run > 0])
    assert kept.max() - kept.min() >= patterns.WINDOW
    c = lab["labels_not_in_ids"]
    present = np.unique(c["lab"][c["lab"] > 0])
    absent = present[~np.isin(present, c["ids"])]
    assert len(absent) > 2 and absent.max() > c["ids"][c["ids"] <
                                                       patterns.MAXINT].max()
    assert lab["ragged_misaligned"]["lab"].size % 4 != 0
    assert {(c["sy"], c["sx"]) for c in lab.values()} == {(1, 2), (2, 1),
                                                          (2, 2)}
    K = slot["background"]["K"]
    assert (slot["background"]["slot"] == K).all()
    assert not slot["one_slot"]["slot"].any()
    assert slot["alternating"]["slot"][:4].tolist() == [0, 1, 0, 1]
    run = slot["span_past_window"]["slot"][:1024]
    assert run[run < K].max() - run[run < K].min() >= patterns.WINDOW
    wild = slot["slots_outside_range"]["slot"]
    assert (wild < 0).any() and (wild > K).any()
    assert len(slot["ragged_misaligned"]["slot"]) % 4 != 0
    assert [slot[f"raster_c{C}"]["vals"].shape[1] for C in (1, 4, 7)] == \
        [1, 4, 7]
    for cases in (lab, slot):
        assert [n for n, c in cases.items() if c["misaligned"]] == \
            ["ragged_misaligned"]


@pytest.mark.parametrize("name", sorted(LABEL_CASES))
def test_label_patterns_plain_matches_pallas(name):
    """Kernels 2 and 3's wrappers on the CPU (their plain versions) against
    the Pallas kernels in interpret mode on every seeded label grid. Sums:
    rtol 1e-5, atol 1e-2 — the Pallas kernel accumulates in float32 in band
    order, the port in float64. Extents: rtol 1e-5, atol 1e-4 on the kept
    slots (projections of coordinates up to ~1e3 in float32); empty slots
    are the 3.4e38 sentinel on both sides."""
    c = LABEL_CASES[name]
    lab, prob, ids, axes = c["lab"], c["prob"], c["ids"], c["axes"]
    sy, sx, W = c["sy"], c["sx"], c["lab"].shape[1]
    ref_sums = np.asarray(jseg.label_moment_sums(
        jnp.asarray(lab), jnp.asarray(prob), jnp.asarray(ids), W=W, sy=sy,
        sx=sx, interpret=True))
    ref_ext = np.asarray(jseg.label_proj_extents(
        jnp.asarray(lab), jnp.asarray(axes), jnp.asarray(ids), W=W, sy=sy,
        sx=sx, interpret=True))
    L, P = (chip_smoke.on_device(a, "cpu", c["misaligned"])
            for a in (lab, prob))
    assert (L.data_ptr() % 16 != 0) == c["misaligned"]
    I, A = torch.from_numpy(ids), torch.from_numpy(axes)
    sums = seg_reduce2.label_moment_sums(L, P, I, sy, sx).numpy()
    ext = seg_reduce2.label_proj_extents(L, A, I, sy, sx).numpy()
    np.testing.assert_allclose(sums, ref_sums, rtol=1e-5, atol=1e-2)
    hit = sums[:, 0] > 0
    assert hit.sum() == np.isin(ids, lab[lab > 0]).sum()
    np.testing.assert_allclose(ext[hit], ref_ext[hit], rtol=1e-5, atol=1e-4)
    assert (ext[~hit] >= 3e38).all() and (ref_ext[~hit] >= 3e38).all()
    assert (sums[~hit] == 0).all()


@pytest.mark.parametrize("name", sorted(SLOT_CASES))
def test_slot_patterns_plain_matches_pallas(name):
    """Kernels 4 and 5's wrappers on the CPU (their plain versions) against
    the Pallas kernels in interpret mode on every seeded slot grid. Sums:
    rtol 1e-5, atol 1e-3 times the largest count of cells in a slot over
    100 (float32 accumulation in band order against float64; a slot that
    every cell feeds adds up 1e4 values of size 1e2). Mins: rtol 1e-6,
    atol 1e-5 (a min is exact)."""
    c = SLOT_CASES[name]
    slot, vals, K = c["slot"], c["vals"], c["K"]
    hit = ((slot >= 0) & (slot < K))[:, None]
    vmin = np.where(hit, vals, np.float32(3.4e38)).astype(np.float32)
    ref_sums = np.asarray(jband.seg_sum_bands(
        jnp.asarray(slot), jnp.asarray(vals), K, interpret=True))
    ref_mins = np.asarray(jband.seg_min_bands(
        jnp.asarray(slot), jnp.asarray(vmin), K, interpret=True))
    S, V, M = (chip_smoke.on_device(a, "cpu", c["misaligned"])
               for a in (slot, vals, vmin))
    assert (S.data_ptr() % 16 != 0) == c["misaligned"]
    sums = seg_reduce.seg_sum_bands(S, V, K).numpy()
    mins = seg_reduce.seg_min_bands(S, M, K).numpy()
    assert sums.shape == mins.shape == (K, vals.shape[1])
    most = max(np.bincount(slot[hit[:, 0]], minlength=1).max(), 100)
    np.testing.assert_allclose(sums, ref_sums, rtol=1e-5,
                               atol=1e-3 * most / 100)
    np.testing.assert_allclose(mins, ref_mins, rtol=1e-6, atol=1e-5)
    empty = ~np.isin(np.arange(K), slot)
    assert (sums[empty] == 0).all() and (mins[empty] >= 3e38).all()


def test_patterns_card_check_runs_on_the_cpu():
    """The card check's own loop over the patterns, on CPU tensors (where a
    wrapper is its plain version): every kernel sees every case."""
    build.LAUNCHES.clear()
    errs = chip_smoke.check_patterns("cpu")
    assert sum(build.LAUNCHES.values()) == 0
    assert set(errs["label_moment_sums"]) == set(errs["label_proj_extents"]) \
        == set(LABEL_CASES)
    assert set(errs["seg_sum_bands"]) == set(errs["seg_min_bands"]) \
        == set(SLOT_CASES)
    assert all(e == 0.0 for by in errs.values() for e in by.values())


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    build.LAUNCHES.clear()
    x = torch.zeros((4, 16))
    with pytest.raises(TypeError):
        ctc_head.ctc_head_reduce(x.double(), torch.zeros((2, 8, 16)),
                                 torch.zeros(8))
    with pytest.raises(ValueError):
        ctc_head.ctc_head_reduce(x, torch.zeros((2, 16, 8)).transpose(1, 2),
                                 torch.zeros(8))
    with pytest.raises(ValueError):
        ctc_head.ctc_head_reduce(x, torch.zeros((2, 8, 15)), torch.zeros(8))
    with pytest.raises(ValueError):   # the unsplit (D, V) weight
        ctc_head.ctc_head_reduce(x, torch.zeros((16, 8)), torch.zeros(8))
    lab = torch.zeros((4, 6), dtype=torch.int32)
    ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        seg_reduce2.label_moment_sums(lab.long(), torch.zeros(4, 6), ids)
    with pytest.raises(TypeError):
        seg_reduce2.label_proj_extents(lab, torch.zeros(3, 3), ids)
    with pytest.raises(ValueError):
        seg_reduce2.label_moment_sums(lab, torch.zeros(6, 4).t(), ids)
    slot = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(TypeError):
        seg_reduce.seg_sum_bands(slot.long(), torch.zeros(5, 2), 4)
    with pytest.raises(TypeError):
        seg_reduce.seg_min_bands(slot, torch.zeros(6, 2), 4)
    with pytest.raises(ValueError):
        seg_reduce.seg_sum_bands(slot, torch.zeros(5, 8), 4)
    with pytest.raises(ValueError):
        seg_reduce.seg_min_bands(slot, torch.zeros(2, 5).t(), 4)
    with pytest.raises(ValueError):
        seg_reduce.seg_sum_bands(slot, torch.zeros(5, 2), 0)
    ctc_head.ctc_head_reduce(x, torch.zeros((2, 8, 16)), torch.zeros(8))
    seg_reduce2.label_moment_sums(lab, torch.zeros(4, 6), ids)
    seg_reduce.seg_sum_bands(slot, torch.zeros(5, 2), 4)
    seg_reduce.seg_min_bands(slot, torch.zeros(5, 2), 4)
    assert sum(build.LAUNCHES.values()) == 0


def test_all_kernel_sources_are_registered():
    assert set(build.SOURCES) == {p.stem for p in build.CSRC.glob("*.cu")}

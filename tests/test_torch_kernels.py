"""The port's kernel wrappers on the CPU (their plain PyTorch versions) vs
the JAX Pallas kernels in interpret mode, on inputs made with numpy from a
seed. The CUDA kernels themselves are held against these plain versions on
the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from onnxocr_tpu.ops.pallas import ctc_head as jctc
from onnxocr_tpu.ops.pallas import seg_reduce2 as jseg

from onnxocr_tpu_torch.ops.kernels import build, ctc_head, seg_reduce2


@pytest.mark.parametrize("M,D,V,masked", [
    (100, 192, 5000, False),
    (10, 64, 2049, False),
    (100, 192, 5000, True),    # -1e30 bias outside a trained support
])
def test_ctc_head_plain_matches_pallas(M, D, V, masked):
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
    idx, prob = ctc_head.ctc_head_reduce(torch.from_numpy(x),
                                         torch.from_numpy(w),
                                         torch.from_numpy(b))
    assert idx.dtype == torch.int32 and prob.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(prob.numpy(), np.asarray(ref_prob),
                               rtol=1e-5, atol=1e-6)
    if masked:
        assert np.isin(idx.numpy(), support).all()


def test_ctc_head_first_index_on_ties():
    x = torch.ones((3, 16))
    w = torch.zeros((16, 40))
    w[:, [7, 19, 33]] = 1.0
    idx, prob = ctc_head.ctc_head_reduce(x, w, torch.zeros(40))
    assert idx.tolist() == [7, 7, 7]
    s = 3 * np.exp(16.0) + 37
    np.testing.assert_allclose(prob.numpy(), np.exp(16.0) / s, rtol=1e-6)


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


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    build.LAUNCHES.clear()
    x = torch.zeros((4, 16))
    with pytest.raises(TypeError):
        ctc_head.ctc_head_reduce(x.double(), torch.zeros((16, 8)),
                                 torch.zeros(8))
    with pytest.raises(ValueError):
        ctc_head.ctc_head_reduce(x, torch.zeros((8, 16)).t(), torch.zeros(8))
    with pytest.raises(ValueError):
        ctc_head.ctc_head_reduce(x, torch.zeros((15, 8)), torch.zeros(8))
    lab = torch.zeros((4, 6), dtype=torch.int32)
    ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        seg_reduce2.label_moment_sums(lab.long(), torch.zeros(4, 6), ids)
    with pytest.raises(TypeError):
        seg_reduce2.label_proj_extents(lab, torch.zeros(3, 3), ids)
    with pytest.raises(ValueError):
        seg_reduce2.label_moment_sums(lab, torch.zeros(6, 4).t(), ids)
    ctc_head.ctc_head_reduce(x, torch.zeros((16, 8)), torch.zeros(8))
    seg_reduce2.label_moment_sums(lab, torch.zeros(4, 6), ids)
    assert sum(build.LAUNCHES.values()) == 0

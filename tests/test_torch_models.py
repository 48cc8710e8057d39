"""PyTorch port models vs the JAX reference on the CPU: the same parameter
trees (JAX `init()` at small widths, and the committed PP-OCRv5
checkpoints) and the same numpy inputs go through both."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from onnxocr_tpu import config as jcfg
from onnxocr_tpu.models import cls as jcls
from onnxocr_tpu.models import common as jcm
from onnxocr_tpu.models import dbnet as jdbnet
from onnxocr_tpu.models import mobilenetv3 as jmbv3
from onnxocr_tpu.models import svtr as jsvtr
from onnxocr_tpu.utils.params_io import load_tree as jload_tree

from onnxocr_tpu_torch import config as tcfg
from onnxocr_tpu_torch.models import cls, convert
from onnxocr_tpu_torch.models import mobilenetv3 as mbv3
from onnxocr_tpu_torch.ops.kernels import ctc_head
from onnxocr_tpu_torch.utils.params_io import load_tree


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_conv_transpose2x_matches_with_flipped_kernel():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    w = rng.normal(size=(2, 2, 6, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    ref = np.asarray(jcm.conv_transpose2x(jnp.asarray(x),
                                          {"w": jnp.asarray(w),
                                           "b": jnp.asarray(b)}))
    up = torch.nn.ConvTranspose2d(6, 3, 2, stride=2)
    tree = {"up": {"w": w, "b": b}}
    holder = torch.nn.Module()
    holder.up = up
    holder.load_state_dict(convert.state_dict_from_tree(tree, holder))
    got = up(_nchw(x)).detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, ref)
    # the unflipped kernel is NOT the same function
    up.weight.data = torch.from_numpy(
        np.ascontiguousarray(w.transpose(2, 3, 0, 1)))
    bad = up(_nchw(x)).detach().numpy().transpose(0, 2, 3, 1)
    assert np.abs(bad - ref).max() > 0.1


def test_param_trees_round_trip():
    """Every leaf of the JAX trees lands in the torch model and back."""
    det = jdbnet.init(0)
    rec = jsvtr.init(0, 300, dim=64, depth=1)
    for tree, build in ((det, convert.build_dbnet),
                        (rec, convert.build_svtr)):
        model = build(tree)
        flat = convert.flatten(tree)
        assert len(model.state_dict()) == len(flat)


def test_mobilenetv3_small_matches():
    """The small configuration (scale 0.35, height-only strides, 576-wide
    last conv) on the reference's seeded tree: final map within 1e-4."""
    rng = np.random.default_rng(7)
    tree = jmbv3.init(11, "small", 0.35)
    x = rng.uniform(-1, 1, size=(2, 48, 192, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(
        lambda p, v: jmbv3.apply(p, v, "small", 0.35))(tree, x))
    model = mbv3.MobileNetV3("small", 0.35)
    model.load_state_dict(convert.state_dict_from_tree(tree, model))
    with torch.no_grad():
        got = model.eval()(_nchw(x))[-1].numpy().transpose(0, 2, 3, 1)
    assert got.shape == ref.shape == (2, 2, 96, 200)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_cls_init_tree_equals_reference_init():
    """The port's own seeded tree draws the reference's numpy stream: equal
    leaf for leaf, dtype included."""
    for seed in (0, 3):
        a = convert.flatten(jcls.init(seed))
        b = convert.flatten(cls.init_tree(seed))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed,n", [(0, 5), (4, 16)])
def test_cls_forward_matches(seed, n):
    """cls.init(seed) carried across by convert: probabilities within 1e-4
    (float32 convolutions summed in another order)."""
    rng = np.random.default_rng(8 + seed)
    tree = jcls.init(seed)
    x = rng.uniform(-1, 1, size=(n, 48, 192, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jcls.apply)(tree, x))
    model = convert.build_cls(tree)
    assert len(model.state_dict()) == len(convert.flatten(tree))
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    assert got.shape == (n, 2)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_cls_forward_separates_inputs():
    """The untrained classifier is still a function of its input: scaled
    weights give probabilities away from 0.5 that agree with the reference,
    argmax included."""
    rng = np.random.default_rng(12)
    tree = jcls.init(0)
    tree["fc"]["w"] = tree["fc"]["w"] * 40.0
    x = rng.uniform(-1, 1, size=(8, 48, 192, 3)).astype(np.float32)
    x[::2] *= 0.2
    ref = np.asarray(jax.jit(jcls.apply)(tree, x))
    with torch.no_grad():
        got = convert.build_cls(tree)(_nchw(x)).numpy()
    assert np.ptp(ref[:, 0]) > 0.02
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


# jitted: one XLA compile per shape instead of one per op
_jdet = jax.jit(lambda p, x: jdbnet.apply(p, x))
_jdet_valid = jax.jit(lambda p, x, vh, vw: jdbnet.apply(p, x,
                                                      valid_hw=(vh, vw)))
_jrec = jax.jit(lambda p, x: (jsvtr.apply_features(p, x),
                              jsvtr.apply(p, x)))
_jrec_valid = jax.jit(lambda p, x, vt: (jsvtr.apply_features(p, x, vt),
                                        jsvtr.apply(p, x, vt)))


def _det_pair(tree, x, valid_hw=None):
    if valid_hw is None:
        ref = np.asarray(_jdet(tree, x))
    else:
        ref = np.asarray(_jdet_valid(tree, x, jnp.asarray([valid_hw[0]]),
                                     jnp.asarray([valid_hw[1]])))
    model = convert.build_dbnet(tree)
    with torch.no_grad():
        got = model(_nchw(x), valid_hw).numpy()
    return got, ref


def test_dbnet_init_tree_matches():
    rng = np.random.default_rng(1)
    tree = jdbnet.init(3)
    x = rng.normal(size=(1, 64, 96, 3)).astype(np.float32)
    got, ref = _det_pair(tree, x)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_dbnet_valid_hw_canvas_invariance():
    """The padded canvas with valid_hw reproduces the exact canvas over the
    valid region, and matches JAX on the padded canvas."""
    rng = np.random.default_rng(2)
    tree = jdbnet.init(4)
    x = rng.normal(size=(1, 64, 96, 3)).astype(np.float32)
    canvas = np.zeros((1, 128, 160, 3), np.float32)
    canvas[:, :64, :96] = x
    got, ref = _det_pair(tree, canvas, (64, 96))
    np.testing.assert_allclose(got, ref, atol=1e-4)
    exact, _ = _det_pair(tree, x)
    np.testing.assert_allclose(got[:, :64, :96], exact, atol=1e-4)


def _rec_pair(tree, x, valid_t=None):
    if valid_t is None:
        ref_f, ref_l = map(np.asarray, _jrec(tree, x))
    else:
        ref_f, ref_l = map(np.asarray,
                           _jrec_valid(tree, x, jnp.asarray(valid_t)))
    model = convert.build_svtr(tree)
    tt = None if valid_t is None else torch.from_numpy(
        np.asarray(valid_t, np.int64))
    with torch.no_grad():
        got_f = model.features(_nchw(x), tt).numpy()
        got_l = model(_nchw(x), tt).numpy()
    return got_f, ref_f, got_l, ref_l


@pytest.mark.parametrize("valid_t", [None, [40, 13, 1]])
def test_svtr_init_tree_matches(valid_t):
    rng = np.random.default_rng(3)
    tree = jsvtr.init(5, 300, dim=64, depth=1)
    x = rng.uniform(-1, 1, size=(3, 48, 320, 3)).astype(np.float32)
    got_f, ref_f, got_l, ref_l = _rec_pair(tree, x, valid_t)
    np.testing.assert_allclose(got_f, ref_f, atol=1e-4)
    np.testing.assert_allclose(got_l, ref_l, atol=1e-4)


def test_svtr_valid_t_masks_padding():
    """Features over the valid tokens ignore what lies in the padding."""
    rng = np.random.default_rng(4)
    tree = jsvtr.init(6, 300, dim=64, depth=1)
    model = convert.build_svtr(tree)
    x = rng.uniform(-1, 1, size=(1, 48, 320, 3)).astype(np.float32)
    y = x.copy()
    y[:, :, 160:] = rng.uniform(-1, 1, size=(1, 48, 160, 3))
    vt = torch.tensor([20])
    with torch.no_grad():
        a = model.features(_nchw(x), vt)[:, :20]
        b = model.features(_nchw(y), vt)[:, :20]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_svtr_head_operand_is_prepared():
    """build_svtr splits the head's weight once for the fused head kernel:
    (2, V, D) float32, contiguous, each half (V, D), on the head's device,
    outside the state dict; the fused head over it gives the plain head's
    argmax and max-prob."""
    rng = np.random.default_rng(8)
    tree = jsvtr.init(7, 300, dim=64, depth=1)
    model = convert.build_svtr(tree)
    head = model.head
    assert head.w_split.shape == (2, 300, 64)
    assert head.w_split.dtype == torch.float32
    assert head.w_split.is_contiguous() and head.w_split[1].is_contiguous()
    assert head.w_split.device == head.w.device
    assert "head.w_split" not in model.state_dict()
    assert torch.equal(head.w_split, ctc_head.split_head(head.w))
    x = rng.uniform(-1, 1, size=(2, 48, 320, 3)).astype(np.float32)
    with torch.no_grad():
        feats = model.features(_nchw(x))
        logits = model(_nchw(x))
    idx, prob = ctc_head.ctc_head_reduce_batched(feats, head.w_split, head.b)
    assert idx.shape == prob.shape == (2, 40)
    assert torch.equal(idx.long(), logits.argmax(-1))
    np.testing.assert_allclose(
        prob.numpy(), torch.softmax(logits, -1).max(-1).values.numpy(),
        rtol=1e-5)


@pytest.fixture(scope="module")
def v5_trees():
    det = tcfg.find_asset("ppocrv5/det/native_params.npz")
    rec = tcfg.find_asset("ppocrv5/rec/native_params.npz")
    assert det == jcfg.find_asset("ppocrv5/det/native_params.npz")
    return load_tree(det), load_tree(rec), jload_tree(det), jload_tree(rec)


def test_v5_checkpoint_trees_load_identically(v5_trees):
    det, rec, jdet, jrec = v5_trees
    for a, b in ((det, jdet), (rec, jrec)):
        fa, fb = convert.flatten(a), convert.flatten(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
    assert len(rec["mixer"]) == 6 and rec["head"]["w"].shape == (192, 18385)


def test_v5_dbnet_matches_at_320(v5_trees):
    det = v5_trees[0]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 320, 320, 3)).astype(np.float32)
    got, ref = _det_pair(det, x, (288, 320))
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_v5_svtr_matches(v5_trees):
    rec = v5_trees[1]
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, size=(2, 48, 320, 3)).astype(np.float32)
    got_f, ref_f, got_l, ref_l = _rec_pair(rec, x, [40, 17])
    np.testing.assert_allclose(got_f, ref_f, atol=1e-4)
    np.testing.assert_allclose(got_l, ref_l, atol=1e-4)

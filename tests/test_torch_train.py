"""The port's trainers (onnxocr_tpu_torch/train, parallel/mesh.py) against
the JAX package's on the CPU, at small sizes: DBNet at 64² batch 2 on both
backbones, SVTR and CRNN at vocab 64 on 48 × 64 crops, the same seeded
numpy batches and the same init trees on both sides.

Each step is compared on its loss, on every gradient leaf (through
`convert.tree_from_model`, in the JAX layout) and on every parameter after
one and after three AdamW steps, as its update divided by lr. Adam's first
step is ≈ lr·sign(g), so where a gradient is as small as the two
packages' float32 noise its sign, and that element's update, may differ
by up to 2 lr. The update check therefore bounds each element by what the
measured gradient differences can explain: with D the largest gradient
difference so far and r the larger of the two √v̂, Adam's u = m̂/(√v̂+eps)
moves by at most 2·D/(r + eps) (|m̂| ≤ √v̂; m̂ and √v̂ are a weighted mean
and a weighted RMS of the gradients, each moved by at most D), and by at
most 2; plus the float32 spacing of the parameter per step.

The tolerances were measured here (the CPU has no TF32; each step test
prints its figures): loss relative difference ≤ 5.6e-7 (LOSS_RTOL 1e-5);
gradients max |Δg| / max |g| over the tree ≤ 2.6e-5 for the MobileNetV3
DBNet, whose float32 noise grows through its depth at a random init, and
≤ 2.2e-6 for every other step (GRAD_TOL 1e-4); optax's AdamW
and the port's on the same gradients differ by ≤ 6.6e-6 in update / lr
(optax rounds its bias correction 1 − 0.999^t to float32, 1.3e-5 off, and
takes its square root; torch computes it in double) plus the float32
rounding of the parameters (ADAMW_UTOL 1e-5, and 2 spacings a step).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from onnxocr_tpu.models import cls as jcls
from onnxocr_tpu.models import crnn as jcrnn
from onnxocr_tpu.models import dbnet as jdbnet
from onnxocr_tpu.models import mobilenetv3 as jmbv3
from onnxocr_tpu.models import resnet as jresnet
from onnxocr_tpu.models import svtr as jsvtr
from onnxocr_tpu.parallel import mesh as jmesh
from onnxocr_tpu.train import det_trainer as jdet
from onnxocr_tpu.train import rec_trainer as jrec
from onnxocr_tpu.utils import params_io as jparams_io

from onnxocr_tpu_torch.models import convert
from onnxocr_tpu_torch.models import mobilenetv3 as mbv3
from onnxocr_tpu_torch.models import resnet
from onnxocr_tpu_torch.parallel import mesh
from onnxocr_tpu_torch.train import det_trainer, optim, rec_trainer
from onnxocr_tpu_torch.utils import params_io

LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ADAMW_UTOL = 1e-5
VOCAB = 64


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Test processes run side by side on the machine's cores: two torch
    threads keep this module from oversubscribing them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in params_io.flatten(jax.device_get(tree)).items()}


# ------------------------------------------------------------ batches
def det_batch(seed=0, b=2, hw=64):
    """Seeded images and filled-rectangle shrink maps, full masks."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, hw, hw, 3)).astype(np.float32)
    maps = np.zeros((b, hw, hw), np.float32)
    for i in range(b):
        y, x = rng.integers(0, hw // 2, 2)
        maps[i, y:y + hw // 4, x:x + hw // 3] = 1.0
    return images, maps, np.ones((b, hw, hw), np.float32)


def rec_batch(seed=0, b=4, width=64, max_len=4):
    """Seeded crops in [−1, 1], labels 1..VOCAB−1 right-padded with 0
    (at most 4, which fit the 8 steps of a 64-wide SVTR crop whatever their
    repeats), and the valid token counts of crops of random width."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, size=(b, 48, width, 3)).astype(np.float32)
    lens = rng.integers(1, max_len + 1, b)
    labels = np.zeros((b, 8), np.int32)
    for i, n in enumerate(lens):
        labels[i, :n] = rng.integers(1, VOCAB, n)
    pads = (np.arange(8)[None] >= lens[:, None]).astype(np.float32)
    valid_t = rng.integers(max_len + 1, width // 8 + 1, b).astype(np.int32)
    return images, labels, pads, valid_t


# ------------------------------------------------------------ the checks
def _adam_bound(gj, gt, steps):
    """Per element: the most `steps` Adam updates (in units of lr) can move
    apart when fed the gradient sequences gj and gt (module docstring)."""
    b2, eps = 0.999, 1e-8
    total, d, vj, vt = 0.0, 0.0, 0.0, 0.0
    for s in range(steps):
        d = np.maximum(d, np.abs(gj[s] - gt[s]))
        vj = b2 * vj + (1 - b2) * gj[s] ** 2
        vt = b2 * vt + (1 - b2) * gt[s] ** 2
        r = np.sqrt(np.maximum(vj, vt) / (1 - b2 ** (s + 1)))
        total = total + np.minimum(2.0, 2.0 * d / (r + eps))
    return total


def check_run(jr, tr, grad_tol=GRAD_TOL):
    """jr / tr: {"loss": [...], "grads": [tree a step], "params": {0: tree,
    1: tree, 3: tree}} of the JAX step and the port's; jr's "grad_ref", where
    present, is the gradient the port's first one must equal (else its
    "grads"[0])."""
    lj, lt = float(jr["loss"][0]), float(tr["loss"][0])
    assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (lt, lj)
    gj, gt = jr["grads"], tr["grads"]
    ref = jr.get("grad_ref", gj[0])
    assert set(gt[0]) == set(ref)
    gmax = max(np.abs(v).max() for v in ref.values())
    gerr = max(np.abs(gt[0][k] - v).max() for k, v in ref.items())
    print(f"loss rel diff {abs(lt - lj) / abs(lj):.2e}, gradient max |dg| / "
          f"max |g| {gerr / gmax:.2e}")
    assert gerr <= grad_tol * gmax, (gerr, gmax)
    p0 = jr["params"][0]
    assert all(np.array_equal(tr["params"][0][k], v) for k, v in p0.items())
    for n in (1, 3):
        for k, v0 in p0.items():
            du = np.abs((tr["params"][n][k] - v0) - (jr["params"][n][k] - v0))
            bound = _adam_bound([g[k] for g in gj], [g[k] for g in gt], n)
            spacing = np.spacing(np.maximum(np.abs(v0),
                                            np.abs(jr["params"][n][k])))
            excess = du / LR - bound - 4 * n * spacing / LR - 1e-4
            assert excess.max() <= 0, (k, n, du.max() / LR)


def run_jax(step, grad_fn, params, state, batch, steps=3):
    """The JAX package's step, `steps` times, and its gradients at each
    step's parameters."""
    out = {"loss": [], "grads": [], "params": {0: flat(params)}}
    for n in range(1, steps + 1):
        loss, grads = grad_fn(params, *batch)
        out["loss"].append(float(loss))
        out["grads"].append(flat(grads))
        params, state, _ = step(params, state, *batch)
        out["params"][n] = flat(params)
    return out


def run_port(step, model, batch, steps=3, tree=None):
    """The port's step, `steps` times; its gradients are the `.grad` each
    step leaves."""
    tree = tree or (lambda grads=False: convert.tree_from_model(model, grads))
    out = {"loss": [], "grads": [], "params": {0: flat(tree())}}
    for n in range(1, steps + 1):
        out["loss"].append(float(step(model, *batch)))
        out["grads"].append(flat(tree(grads=True)))
        out["params"][n] = flat(tree())
    return out


def _bf16(a):
    """Round float32 to bfloat16 (nearest even) and back."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


def bf16_pair(loss_fn, params, first, batch, step, model):
    """A trainer at dtype=bfloat16 (the images cast, the parameters
    float32), one step of each side. JAX 0.9 cannot differentiate the JAX
    trainers there (the transpose of a conv with preferred_element_type
    float32 meets a float32 cotangent and a bfloat16 operand and raises),
    so JAX gives the bfloat16 loss value, and the gradients of its float32
    loss at the bfloat16-rounded images and first-layer weight `first`:
    what the bfloat16 backward computes, that layer's weight gradient
    rounded to bfloat16 on its way back through the cast."""
    value = jax.jit(lambda p, *b: loss_fn(p, b, jnp.bfloat16))(params,
                                                                *batch)
    rounded = jax.tree_util.tree_map(lambda a: a, params)
    node = rounded
    *path, leaf = first.split("/")
    for key in path:
        node = node[int(key[1:])] if key.startswith("#") else node[key]
    node[leaf] = _bf16(node[leaf])
    rbatch = (_bf16(batch[0]),) + tuple(batch[1:])
    grads = jax.jit(jax.grad(lambda p, *b: loss_fn(p, b, jnp.float32)))(
        rounded, *rbatch)
    jr = {"loss": [float(value)], "grads": [flat(grads)], "first": first}
    return jr, run_port(step, model, batch, steps=1)


def check_bf16(jr, tr, f32_runs):
    """The port's bfloat16 step against bf16_pair's JAX figures: the loss at
    LOSS_RTOL, every gradient leaf at GRAD_TOL but the first layer's
    weight, which may be off by one bfloat16 rounding more; and it is not
    the float32 step."""
    lj, lt = jr["loss"][0], tr["loss"][0]
    assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (lt, lj)
    assert lt != f32_runs[1]["loss"][0]
    gj, gt = jr["grads"][0], tr["grads"][0]
    assert set(gt) == set(gj)
    gmax = max(np.abs(v).max() for v in gj.values())
    for k, v in gj.items():
        slack = GRAD_TOL * gmax
        if k == jr["first"]:
            np.testing.assert_array_equal(gt[k], _bf16(gt[k]))
            slack = slack + np.abs(v) * 2.0 ** -8
        assert np.all(np.abs(gt[k] - v) <= slack), k


# ------------------------------------------------------------ trees
@pytest.mark.parametrize("kind,arch", [("det", "mbv3"), ("det", "resnet18"),
                                       ("rec", "svtr")])
def test_init_training_equals_jax(kind, arch):
    """init_training(seed) builds JAX's init_training(PRNGKey(seed)) tree,
    leaf for leaf, in training mode with every leaf trainable."""
    if kind == "det":
        want, _, _ = jdet.init_training(jax.random.PRNGKey(3), LR, arch)
        model, opt = det_trainer.init_training(3, LR, arch, device="cpu")
    else:
        want, _, _ = jrec.init_training(jax.random.PRNGKey(3), VOCAB, LR)
        model, opt = rec_trainer.init_training(3, VOCAB, LR, device="cpu")
    got = flat(convert.tree_from_model(model))
    want = flat(want)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert model.training
    n_opt = sum(len(g["params"]) for g in opt.param_groups)
    assert n_opt == len(want) == len(list(model.parameters()))


def _module(net, tree):
    net.load_state_dict(convert.state_dict_from_tree(tree, net))
    return net


@pytest.mark.parametrize("arch", ["mobilenetv3", "resnet", "dbnet", "svtr",
                                  "crnn", "cls"])
def test_tree_from_model_inverts_the_build(arch):
    """tree_from_model ∘ build is the identity on all six architectures
    (the transposed conv's flip, the linears, the LSTM stacks included)."""
    tree, model = {
        "mobilenetv3": lambda: (t := jmbv3.init(1, "large", 0.5),
                                _module(mbv3.MobileNetV3("large", 0.5), t)),
        "resnet": lambda: (t := jresnet.init(1, 18),
                           _module(resnet.ResNet18vd(), t)),
        "dbnet": lambda: (t := jdbnet.init(1),
                          convert.build_dbnet(t)),
        "svtr": lambda: (t := jsvtr.init(1, VOCAB), convert.build_svtr(t)),
        "crnn": lambda: (t := jcrnn.init(1, VOCAB), convert.build_crnn(t)),
        "cls": lambda: (t := jcls.init(1), convert.build_cls(t)),
    }[arch]()
    want, got = flat(tree), flat(convert.tree_from_model(model))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_save_tree_loads_in_both_packages(tmp_path):
    """A checkpoint the port writes (float16 leaves, as the JAX package's
    save_tree) loads in the JAX package's load_tree and in the port's,
    equal to the float16-rounded tree, and builds the same model."""
    tree = jsvtr.init(2, VOCAB)
    model = convert.build_svtr(tree)
    path = str(tmp_path / "rec" / "native_params.npz")
    params_io.save_tree(path, convert.tree_from_model(model))
    want = {k: v.astype(np.float16).astype(np.float32)
            for k, v in flat(tree).items()}
    for got in (flat(jparams_io.load_tree(path)),
                flat(params_io.load_tree(path))):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # and the JAX package's checkpoint of the same tree is the same file
    jpath = str(tmp_path / "jax.npz")
    jparams_io.save_tree(jpath, tree)
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------ optimizer, CTC
def test_adamw_matches_optax():
    """The port's AdamW and optax.adamw(lr, weight_decay=1e-5) fed the same
    three gradients give the same parameters: every leaf decays, BN `var`
    included."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(size=(5, 7)).astype(np.float32),
          "var": rng.uniform(0.5, 2, 7).astype(np.float32),
          "b": np.zeros(7, np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-6, 1))
              .astype(np.float32) for k, v in p0.items()} for _ in range(3)]
    tx = optax.adamw(LR, weight_decay=1e-5)
    pj, st = dict(p0), tx.init(p0)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    opt = optim.adamw(tp.values(), LR, weight_decay=1e-5)
    for n, g in enumerate(grads, 1):
        upd, st = tx.update(g, st, pj)
        pj = optax.apply_updates(pj, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        opt.step()
        for k in p0:
            want = np.asarray(pj[k])
            diff = np.abs(tp[k].detach().numpy() - want)
            assert np.all(diff <= n * (ADAMW_UTOL * LR + 2 * np.spacing(
                np.abs(want)))), (k, diff.max() / LR)
            assert np.abs(want - p0[k]).min() > 0   # every leaf moved


def test_ctc_loss_matches_optax_feasible_and_not():
    """optax.ctc_loss's value and gradients on feasible rows, on a repeated
    label, and on labels that need more steps than T = 4 ('1 1 1 2 3':
    optax's finite ~1e5 where F.ctc_loss gives inf). On an infeasible row
    the log-probabilities sit near −1e5, where float32 resolves 2^-7, so
    its gradients hold only to 1e-2 of their largest."""
    rng = np.random.default_rng(0)
    B, T, V = 4, 4, 7
    logits = (rng.normal(size=(B, T, V)) * 3).astype(np.float32)
    labels = np.array([[1, 1, 1, 2, 3], [1, 2, 0, 0, 0], [3, 3, 0, 0, 0],
                       [1, 2, 3, 4, 5]], np.int32)
    pads = (labels == 0).astype(np.float32)

    def jloss(lg):
        return optax.ctc_loss(lg, jnp.zeros((B, T)), labels, pads,
                              blank_id=0)

    want = np.asarray(jloss(logits))
    gwant = np.asarray(jax.grad(lambda lg: jloss(lg).mean())(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = rec_trainer.ctc_loss(x, torch.tensor(labels), torch.tensor(pads))
    got.mean().backward()
    assert want[0] > 1e5 and want[3] > 1e5 and np.all(np.isfinite(want))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6)
    g = x.grad.numpy()
    assert np.all(np.isfinite(g))
    for row, tol in ((0, 1e-2), (1, 1e-5), (2, 1e-5), (3, 1e-2)):
        err = np.abs(g[row] - gwant[row]).max()
        assert err <= tol * np.abs(gwant[row]).max(), (row, err)


# ------------------------------------------------------------ DB steps
@pytest.fixture(scope="module")
def det_runs():
    """Both packages' DB steps on both backbones and the distillation step
    (ResNet18-vd student, MobileNetV3 teacher), float32 and bfloat16
    images."""
    batch = det_batch()
    runs = {}
    for arch in ("mbv3", "resnet18"):
        params, tx, st = jdet.init_training(jax.random.PRNGKey(0), LR, arch)
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, *b: jdet.db_loss_fn(p, *b, backbone_arch=arch)))
        jr = run_jax(jdet.make_train_step(tx, backbone_arch=arch), grad_fn,
                     params, st, batch)
        model, opt = det_trainer.init_training(0, LR, arch, device="cpu")
        tr = run_port(det_trainer.make_train_step(opt, device="cpu"), model,
                      batch)
        runs[arch, "float32"] = jr, tr
    params, _, _ = jdet.init_training(jax.random.PRNGKey(0), LR, "mbv3")
    model, opt = det_trainer.init_training(0, LR, "mbv3", device="cpu")
    runs["mbv3", "bfloat16"] = bf16_pair(
        lambda p, b, dt, **kw: jdet.db_loss_fn(p, *b, dt, **kw), params,
        "backbone/stem/conv/w", batch,
        det_trainer.make_train_step(opt, torch.bfloat16, device="cpu"),
        model)
    teacher_tree = jdbnet.init(7)
    params, tx, st = jdet.init_training(jax.random.PRNGKey(1), LR,
                                        "resnet18")
    jstep = jdet.make_distill_step(tx)

    def grad_fn(p, *b):
        t_probs = jdbnet.apply(teacher_tree, b[0], backbone_arch="mbv3")
        return jax.value_and_grad(jdet.distill_loss_fn)(
            p, *b, t_probs, 0.7, backbone_arch="resnet18")

    def step(p, s, *b):
        return jstep(p, teacher_tree, s, *b)

    jr = run_jax(step, jax.jit(grad_fn), params, st, batch)
    model, opt = det_trainer.init_training(1, LR, "resnet18", device="cpu")
    teacher = convert.build_dbnet(teacher_tree)
    tstep = det_trainer.make_distill_step(opt, device="cpu")
    tr = run_port(lambda m, *b: tstep(m, teacher, *b), model, batch)
    runs["distill", "float32"] = jr, tr
    return runs


@pytest.mark.parametrize("arch", ["mbv3", "resnet18"])
def test_db_step_matches_jax(det_runs, arch):
    check_run(*det_runs[arch, "float32"])


def test_distill_step_matches_jax(det_runs):
    """The teacher runs without gradient on its own parameters: only the
    student's leaves have gradients and move."""
    check_run(*det_runs["distill", "float32"])


def test_db_step_bfloat16_images_matches_jax(det_runs):
    check_bf16(*det_runs["mbv3", "bfloat16"], det_runs["mbv3", "float32"])


def test_db_negative_weights_are_differentiated(monkeypatch):
    """The loss-weighted negatives carry gradient, as in JAX (no
    stop_gradient): the port's gradient w.r.t. the probabilities equals
    the JAX loss's (its model replaced by the identity) and differs from
    the one with the weights detached."""
    rng = np.random.default_rng(1)
    probs = rng.uniform(0.01, 0.99, (2, 8, 8)).astype(np.float32)
    maps = rng.integers(0, 2, (2, 8, 8)).astype(np.float32)
    masks = np.ones((2, 8, 8), np.float32)
    monkeypatch.setattr(jdet.dbnet, "apply", lambda p, x, **kw: x)
    want = np.asarray(jax.grad(
        lambda x: jdet.db_loss_fn(None, x, maps, masks))(probs))
    x = torch.tensor(probs, requires_grad=True)
    got = torch.autograd.grad(det_trainer._db_loss(
        x, torch.tensor(maps), torch.tensor(masks)), x)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # the same loss with its negative weights detached has another gradient
    xd = torch.tensor(probs, requires_grad=True)
    eps = 1e-6
    p = torch.clamp(xd, eps, 1 - eps)
    m = torch.tensor(maps)
    bce = -(m * torch.log(p) + (1 - m) * torch.log(1 - p))
    n_pos = m.sum()
    neg_w = ((1 - m) * bce).detach()
    neg_w = neg_w / neg_w.sum() * (3.0 * n_pos)
    loss = (bce * m).sum() / n_pos + (bce * neg_w).sum() / n_pos + 1.0 - \
        2.0 * (p * m).sum() / (p.sum() + m.sum() + eps)
    detached = torch.autograd.grad(loss, xd)[0].numpy()
    assert np.abs(detached - want).max() > 1e-3


# ------------------------------------------------------------ CTC steps
@pytest.fixture(scope="module")
def rec_runs():
    """Both packages' CTC steps: SVTR with and without valid_t, SVTR on
    bfloat16 crops, the CRNN."""
    images, labels, pads, valid_t = rec_batch()
    runs = {}
    for name, vt in (("svtr_valid_t", valid_t), ("svtr", None)):
        params, tx, st = jrec.init_training(jax.random.PRNGKey(0), VOCAB, LR)
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, *b: jrec.ctc_loss_fn(p, *b[:3], valid_t=b[3])))
        batch = (images, labels, pads, vt)
        jr = run_jax(jrec.make_train_step(tx), grad_fn, params, st, batch)
        model, opt = rec_trainer.init_training(0, VOCAB, LR, device="cpu")
        tr = run_port(rec_trainer.make_train_step(opt, device="cpu"), model,
                      batch)
        runs[name] = jr, tr
    params, _, _ = jrec.init_training(jax.random.PRNGKey(0), VOCAB, LR)
    model, opt = rec_trainer.init_training(0, VOCAB, LR, device="cpu")
    runs["svtr_bf16"] = bf16_pair(
        lambda p, b, dt: jrec.ctc_loss_fn(p, *b[:3], dt, valid_t=b[3]),
        params, "stem/conv/w", (images, labels, pads, valid_t),
        rec_trainer.make_train_step(opt, torch.bfloat16, device="cpu"),
        model)
    tree = jcrnn.init(0, VOCAB)
    tx = optax.adamw(LR, weight_decay=1e-5)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, *b: jrec.ctc_loss_fn(p, *b, model_mod=jcrnn)))
    jr = run_jax(jrec.make_train_step(tx, model_mod=jcrnn), grad_fn, tree,
                 tx.init(tree), (images, labels, pads))
    model = convert.build_crnn(tree)
    opt = optim.adamw(optim.trainable(model), LR, weight_decay=1e-5)
    tr = run_port(rec_trainer.make_train_step(opt, device="cpu"), model,
                  (images, labels, pads))
    runs["crnn"] = jr, tr
    return runs


@pytest.mark.parametrize("name", ["svtr_valid_t", "svtr", "crnn"])
def test_ctc_step_matches_jax(rec_runs, name):
    check_run(*rec_runs[name])


def test_ctc_step_bfloat16_crops_matches_jax(rec_runs):
    check_bf16(*rec_runs["svtr_bf16"], rec_runs["svtr_valid_t"])


def test_crnn_bias_hh_stays_zero(rec_runs):
    """The CRNN's bias_hh takes no gradient and no decay: the JAX BiLSTM's
    single bias is bias_ih (tree_from_model's b) and moves as JAX's b."""
    _, tr = rec_runs["crnn"]
    model = convert.build_crnn(jcrnn.init(0, VOCAB))
    params = optim.trainable(model)
    names = {id(p): n for n, p in model.named_parameters()}
    assert not any("bias_hh" in names[id(p)] for p in params)
    assert all(not p.requires_grad for n, p in model.named_parameters()
               if "bias_hh" in n)
    assert np.abs(tr["params"][3]["lstm1/b"] -
                  tr["params"][0]["lstm1/b"]).max() > 0


def test_train_mode_changes_no_forward():
    """trainable() puts a model in training mode (cuDNN's LSTM backward
    needs it): no module of the port has dropout or batch statistics, so
    the forward of every architecture is the same in both modes."""
    rng = np.random.default_rng(2)
    crop = torch.tensor(rng.uniform(-1, 1, (2, 3, 48, 64)),
                        dtype=torch.float32)
    page = torch.tensor(rng.normal(size=(1, 3, 64, 64)), dtype=torch.float32)
    for model, x in ((convert.build_dbnet(jdbnet.init(0)), page),
                     (convert.build_dbnet(jdbnet.init(0, backbone_arch=
                                                      "resnet18"),
                                          arch="resnet18"), page),
                     (convert.build_svtr(jsvtr.init(0, VOCAB)), crop),
                     (convert.build_crnn(jcrnn.init(0, VOCAB)), crop),
                     (convert.build_cls(jcls.init(0)),
                      torch.nn.functional.pad(crop, (0, 128)))):
        with torch.no_grad():
            ref = model.eval()(x)
            assert torch.equal(model.train()(x), ref)
        assert not any(isinstance(m, (torch.nn.Dropout,
                                      torch.nn.modules.batchnorm._NormBase))
                       for m in model.modules())


# ------------------------------------------------------------ the mesh
@pytest.fixture(scope="module")
def sharded_runs():
    """The dp × tp step on a 4 × 2 mesh: JAX on conftest's 8 virtual CPU
    devices, the port on a grid of 'cpu' ×8; B = 8. The port's gradient is
    held against JAX's gradient of the same loss unsharded ("grad_ref"):
    JAX's 4 × 2 program gives every depthwise conv kernel exactly twice
    that (checked in test_sharded_step_matches_jax; its 8 × 1 mesh does
    not), and its step applies what that program gives, which the update
    bound takes ("grads")."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    images, labels, pads, _ = rec_batch(seed=5, b=8)
    jm = jmesh.make_mesh(8, model_parallel=2)
    params, tx, _ = jrec.init_training(jax.random.PRNGKey(0), VOCAB, LR)
    params = jmesh.shard_rec_params(params, jm)
    grad_fn = jax.jit(jax.value_and_grad(jrec.ctc_loss_fn))
    jbatch = jmesh.shard_batch({"i": images, "l": labels, "p": pads}, jm)
    jr = run_jax(jrec.make_sharded_train_step(jm, tx), grad_fn, params,
                 tx.init(params), (jbatch["i"], jbatch["l"], jbatch["p"]))
    jr["grad_ref"] = flat(grad_fn(jax.device_get(params), images, labels,
                                  pads)[1])
    tm = mesh.make_mesh(8, model_parallel=2, devices=["cpu"] * 8)
    model, _ = rec_trainer.init_training(0, VOCAB, LR, device="cpu")
    placed = mesh.shard_rec_params(model, tm)
    opt = optim.adamw(placed.parameters(), LR, weight_decay=1e-5)
    step = rec_trainer.make_sharded_train_step(tm, opt)
    tbatch = mesh.shard_batch({"i": images, "l": labels, "p": pads}, tm)
    tr = run_port(step, placed, (tbatch["i"], tbatch["l"], tbatch["p"]),
                  tree=_sharded_tree(placed))
    return jr, tr, placed, tm


def _sharded_tree(placed):
    """tree_from_model's counterpart for a ShardedRec: the master leaves or
    their reduced gradients."""
    def tree(grads=False):
        if not grads:
            return placed.tree()
        out = convert.tree_from_model(placed.body[0], grads=True)
        out["head"] = {
            "w": torch.cat([p.grad for p in placed.head_w.shards[0]], 1),
            "b": torch.cat([p.grad for p in placed.head_b.shards[0]])}
        return out
    return tree


def test_mesh_axes_and_placement(sharded_runs):
    _, _, placed, tm = sharded_runs
    assert tm.shape == {"data": 4, "model": 2}
    assert placed.head_w.sharding.spec == (None, "model")
    assert placed.head_b.sharding.spec == ("model",)
    assert placed.body_sharding.spec == ()
    assert placed.head_w.shards.shape == (4, 2)
    assert placed.head_w.shards[1, 1].shape == (192, VOCAB // 2)


def test_sharded_step_matches_jax(sharded_runs):
    """The port's 4 × 2 step against the JAX package's on 8 devices: loss,
    the reduced gradient of every leaf, and the parameters after 1 and 3
    steps; every data row's copy equals the master after each step, and
    the head shards stay where shard_rec_params put them. JAX's own 4 × 2
    gradient is its unsharded one but for the depthwise conv kernels,
    which it doubles (a fault of its partitioned program, not of the
    loss: the port's sums the 4 data rows' gradients, as the 8 × 1 mesh's
    does)."""
    jr, tr, placed, tm = sharded_runs
    check_run(jr, tr)
    gmax = max(np.abs(v).max() for v in jr["grad_ref"].values())
    for k, v in jr["grad_ref"].items():
        ratio = 2.0 if "/dw/conv/w" in k else 1.0
        err = np.abs(jr["grads"][0][k] - ratio * v).max()
        assert err <= GRAD_TOL * gmax, (k, err)
    rows = placed._rows()
    for row in rows[1:]:
        for a, b in zip(rows[0], row):
            assert torch.equal(a, b)
    for (i, j), t in np.ndenumerate(placed.head_w.shards):
        assert t.device == tm.devices[i, j]


def test_sharded_step_equals_unsharded():
    """Sharded over 2 × 2 or not, the port's steps agree as the two
    packages' do (loss, gradients, updates; the mean of the rows' means is
    the batch mean, the rows' gradients sum to the batch's)."""
    images, labels, pads, _ = rec_batch(seed=6, b=4)
    batch = (images, labels, pads)
    model, opt = rec_trainer.init_training(0, VOCAB, LR, device="cpu")
    tm = mesh.make_mesh(4, model_parallel=2, devices=["cpu"] * 4)
    placed = mesh.shard_rec_params(model, tm)
    sopt = optim.adamw(placed.parameters(), LR, weight_decay=1e-5)
    sharded = run_port(rec_trainer.make_sharded_train_step(tm, sopt),
                       placed, batch, tree=_sharded_tree(placed))
    whole = run_port(rec_trainer.make_train_step(opt, device="cpu"), model,
                     batch)
    check_run(whole, sharded)


def test_mesh_needs_an_even_split():
    tm = mesh.make_mesh(4, model_parallel=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="split"):
        mesh.data_sharding(tm, 2).place(torch.zeros(3, 2))
    with pytest.raises(ValueError):
        mesh.make_mesh(3, model_parallel=2, devices=["cpu"] * 4)


# ------------------------------------------------------------ devices
def test_entry_points_default_to_cuda_and_refuse_without_it():
    """Without CUDA every new entry point raises unless asked for the CPU:
    no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the defaults run on it")
    opt = optim.adamw([torch.nn.Parameter(torch.zeros(1))], LR)
    for call in (lambda: det_trainer.init_training(0),
                 lambda: rec_trainer.init_training(0, VOCAB),
                 lambda: det_trainer.make_train_step(opt),
                 lambda: det_trainer.make_distill_step(opt),
                 lambda: rec_trainer.make_train_step(opt),
                 lambda: mesh.make_mesh()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()

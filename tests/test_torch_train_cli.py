"""The port's training CLI (onnxocr_tpu_torch/tools/train_synthetic.py)
against the JAX package's tools/train_synthetic.py, imported by path, on
the CPU at a small size, with the same stand-in dictionary and pinned
lexicon on both sides.

* rec: 3 steps, batch 4, width 64, an SVTR of dim 32 and depth 1 at the
  dictionary's vocabulary, structured_frac 0.5, at the default max_len 14
  and at 3. Both renderers draw the same batches (tests/test_torch_synth.py
  holds them equal). Each step's loss agrees within 1e-4 relative, and the
  tree each tool hands to `save_tree` within 1e-4 of its largest leaf,
  but where the reference's own float32 rounding can move a result past
  that: the rounding of JAX's gradient (its CTC gradient less its float64
  value, carried back through the model, plus the port's CTC rounding
  measured the same way; residue gradients below 8 ulps of their leaf's
  largest, such as the attention's key bias, whose gradient is zero) is
  run through Adam with every sign, and an element it moves past the
  tolerance is held to that move instead; a later loss gets, to first
  order, what those moves change it by. At max_len 14 most labels do not
  fit the 8 frames of a 64-wide crop and the CTC loss sits on optax's
  log-epsilon floor (1e5 a sequence), where both tools' gradients lie
  about 1 % from float64 (measured: JAX 0.77 %, the port 0.53 %): 191
  of 765,905 elements are held to their bounds there, and step 2's loss
  (|Δ| 0.017 of 79.45) to 0.095; at max_len 3, 47 elements (the key bias
  and 15 head weights with residue gradients) and 1e-4 for every loss.
  With the update of one bias vector skipped in the port, the rec and
  det cases fail.
* det: 2 steps, batch 2, 64² pages; `TextRenderer.det_batch` is patched
  on both sides to return one fixed seeded half-batch, because two
  producers share one queue in both tools and which renderer's half comes
  first depends on thread timing. Once warm-started with `--init-from` a
  donor tree, once with `--distill-from` a teacher.
* `warmup_cosine_decay` equals optax's schedule at every step.
* Without `--device cpu` on a machine without CUDA the module exits
  non-zero, and the default `--out` lies under build/, not under the JAX
  package's committed checkpoints.
"""
import importlib.util
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import optax
from onnxocr_tpu import config as jconfig
from onnxocr_tpu.train import det_trainer as jdet
from onnxocr_tpu.train import rec_trainer as jrec
from onnxocr_tpu.train import synth as jsynth
from onnxocr_tpu.utils import params_io as jparams_io

from onnxocr_tpu_torch.tools import train_synthetic as cli
from onnxocr_tpu_torch.train import det_trainer, optim, rec_trainer
from onnxocr_tpu_torch.train import synth
from onnxocr_tpu_torch.utils import params_io

from test_torch_synth import standin_dict

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
TREE_TOL = 1e-4
NOISE_FRAC = 1e-3
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)     # optax.adamw's defaults


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_train_synthetic", REPO / "tools" / "train_synthetic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """An asset root holding the stand-in ppocrv5/ppocrv5_dict.txt."""
    root = tmp_path_factory.mktemp("assets")
    (root / "ppocrv5").mkdir()
    standin_dict(root / "ppocrv5" / "ppocrv5_dict.txt")
    return root


@pytest.fixture()
def both(assets, monkeypatch):
    """Both tools pointed at the stand-in, one lexicon, and recorders of
    each step's loss and of each tree handed to save_tree."""
    monkeypatch.setenv("ONNXOCR_TPU_ASSETS", str(assets))
    monkeypatch.setattr(jconfig, "_ASSET_SEARCH_PATHS",
                        [str(assets)] + list(jconfig._ASSET_SEARCH_PATHS))
    lexicon = jsynth._lexicon()
    monkeypatch.setattr(jsynth, "_LEXICON_CACHE", list(lexicon))
    monkeypatch.setattr(synth, "_LEXICON_CACHE", list(lexicon))
    rec = {"jax": {"loss": [], "tree": [], "grad": [], "args": []},
           "port": {"loss": [], "tree": []}}

    def losses(module, name, side):
        make = getattr(module, name)

        def wrapped(*a, **k):
            step = make(*a, **k)

            def run(*args):
                out = step(*args)
                loss = out[-1] if isinstance(out, tuple) else out
                rec[side]["loss"].append(float(loss))
                if side == "jax":
                    rec["jax"]["grad"].append(_adam_grad(args, out))
                    rec["jax"]["args"].append(args)
                return out
            return run
        monkeypatch.setattr(module, name, wrapped)

    for name in ("make_train_step", "make_distill_step"):
        if hasattr(jrec, name):
            losses(jrec, name, "jax")
        losses(jdet, name, "jax")
        if hasattr(rec_trainer, name):
            losses(rec_trainer, name, "port")
        losses(det_trainer, name, "port")

    def trees(module, side):
        save = module.save_tree

        def wrapped(path, tree):
            rec[side]["tree"].append(
                {k: np.asarray(v) for k, v in params_io.flatten(tree).items()})
            save(path, tree)
        monkeypatch.setattr(module, "save_tree", wrapped)

    trees(jparams_io, "jax")
    trees(params_io, "port")
    return rec


def _adam_grad(args, out):
    """The gradient a JAX train step applied, by leaf name: optax's Adam
    state holds mu_t = b1 · mu_(t-1) + (1 - b1) · g_t, before (an argument
    of the step) and after (its second output)."""
    before = next(a for a in args if isinstance(a, tuple) and
                  hasattr(a[0], "mu"))[0].mu
    after = out[1][0].mu
    mb, ma = params_io.flatten(before), params_io.flatten(after)
    return {k: (np.asarray(ma[k], np.float64) -
                ADAM["b1"] * np.asarray(mb[k], np.float64)) / (1 - ADAM["b1"])
            for k in ma}


# a gradient below 8 ulps of its leaf's largest is rounding residue: the
# attention's key bias, whose gradient is zero (softmax ignores a shift of
# every score), comes out at 4.5e-8 of its leaf's largest
NOISE = 8 * float(np.finfo(np.float32).eps)


def _ctc_rounding(rec):
    """The float32 rounding of the reference's CTC gradient at each rec
    step, by leaf: optax's CTC gradient with respect to the logits in
    float32 less the same in float64, carried back through the SVTR's
    backward (its vjp), plus the same for the port's CTC (float32 less
    float64 of its own recursion), since the two tools' roundings add up.
    Where labels outgrow the frames the loss sits on optax's log-epsilon
    floor (1e5 a sequence); float32 holds a log likelihood that large to
    0.008, and the gradient there lies some 1 % from its float64 value in
    both tools."""
    import jax
    import jax.numpy as jnp
    from onnxocr_tpu.models import svtr as jsvtr
    out = []
    for params, _, images, labels, pads, valid_t in rec["jax"]["args"]:
        logits, vjp = jax.vjp(
            lambda p: jsvtr.apply(p, jnp.asarray(images), valid_t), params)
        logits = np.asarray(logits)
        b, t, _ = logits.shape

        def dz(z):
            return np.asarray(jax.grad(lambda z: jnp.mean(optax.ctc_loss(
                z, jnp.zeros((b, t), z.dtype), jnp.asarray(labels),
                jnp.asarray(pads, z.dtype), blank_id=0)))(z), np.float64)
        d32 = dz(jnp.asarray(logits))
        jax.config.update("jax_enable_x64", True)
        try:
            d64 = dz(jnp.asarray(logits, jnp.float64))
        finally:
            jax.config.update("jax_enable_x64", False)
        p32, p64 = (_port_dz(logits.astype(dt), labels, pads)
                    for dt in (np.float32, np.float64))
        errs = [params_io.flatten(vjp(jnp.asarray(d, jnp.float32))[0])
                for d in (d32 - d64, p32 - p64)]
        out.append({k: sum(np.abs(np.asarray(e[k], np.float64)).ravel()
                           for e in errs) for k in errs[0]})
    return out


def _port_dz(logits, labels, pads):
    """The port's CTC gradient with respect to the logits, at their dtype."""
    z = torch.tensor(logits, requires_grad=True)
    rec_trainer.ctc_loss(z, torch.tensor(labels), torch.tensor(
        pads, dtype=z.dtype)).mean().backward()
    return z.grad.numpy().astype(np.float64)


def _adam_moves(g, lrs):
    """Adam's displacement of each element after each step, from its
    gradients g (steps, n) at the learning rates lrs (no weight decay)."""
    mu = nu = 0.0
    moved, out = 0.0, []
    for t, lr in enumerate(lrs):
        mu = ADAM["b1"] * mu + (1 - ADAM["b1"]) * g[t]
        nu = ADAM["b2"] * nu + (1 - ADAM["b2"]) * g[t] ** 2
        m = mu / (1 - ADAM["b1"] ** (t + 1))
        v = nu / (1 - ADAM["b2"] ** (t + 1))
        moved = moved - lr * m / (np.sqrt(v) + ADAM["eps"])
        out.append(moved)
    return np.stack(out)


def _reference_rounding(rec, lrs, ctc):
    """How far the reference's own float32 rounding can move each element:
    leaf → (steps, n) bound after each step. Step t's gradient is known to
    ± its CTC rounding (`_ctc_rounding`, rec only) and, where every step's
    gradient is rounding residue (non-zero, below NOISE of its leaf's
    largest), to ± NOISE of the leaf's largest. Every sign of those
    errors is run through Adam; the bound is the largest move away from
    the unperturbed run."""
    grads = rec["jax"]["grad"]
    steps = len(grads)
    out = {}
    for k in grads[0]:
        g = np.stack([gr[k].ravel() for gr in grads])
        top = np.abs(g).max(axis=1, keepdims=True)
        err = np.stack([c[k] for c in ctc]) if ctc else np.zeros_like(g)
        residue = (np.abs(g).max(axis=0) > 0) & \
            (np.abs(g) <= NOISE * top).all(axis=0)
        err[:, residue] += np.broadcast_to(NOISE * top, err[:, residue].shape)
        base = _adam_moves(g, lrs)
        worst = np.zeros_like(base)
        for signs in itertools.product((-1.0, 1.0), repeat=steps):
            moved = _adam_moves(g + np.asarray(signs)[:, None] * err, lrs)
            worst = np.maximum(worst, np.abs(moved - base))
        out[k] = worst
    return out


def _hold(rec, steps, lr, ctc=None):
    """The port against the reference, to the tools' float32 rounding:
    each step's loss within LOSS_RTOL relative plus, to first order, what
    that rounding can move it by (Σ |g_t| · bound of the parameters
    entering step t: 0 for steps 0 and 1, which run on equal parameters
    since step 0's learning rate is 0); the last tree handed to save_tree
    within TREE_TOL of its largest leaf, but for the elements the rounding
    can move past that (their reference gradients are printed), each held
    within its bound plus TREE_TOL of the largest leaf, and no more than
    NOISE_FRAC of the tree."""
    lj, lp = np.array(rec["jax"]["loss"]), np.array(rec["port"]["loss"])
    assert lj.size == steps and lj.shape == lp.shape
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, lr, min(100, max(1, steps // 10)),
        max(steps, min(100, max(1, steps // 10)) + 1), lr * 0.05)
    lrs = [float(schedule(i)) for i in range(steps)]
    bound = _reference_rounding(rec, lrs, ctc)
    grads = rec["jax"]["grad"]
    slack = np.array([0.0] + [
        sum(float(np.abs(grads[t][k].ravel()) @ bound[k][t - 1])
            for k in bound) for t in range(1, steps)])
    tol = LOSS_RTOL * np.abs(lj) + slack
    print(f"losses {lj.tolist()} / {lp.tolist()}; |Δ| "
          f"{np.abs(lp - lj).tolist()} within {tol.tolist()}")
    assert (np.abs(lp - lj) <= tol).all(), (lj, lp, tol)
    tj, tp = rec["jax"]["tree"][-1], rec["port"]["tree"][-1]
    assert sorted(tj) == sorted(tp)
    top = max(float(np.abs(np.asarray(v)).max()) for v in tj.values())
    held = exempt = 0
    for k in tj:
        d = np.abs(np.asarray(tj[k], np.float64) -
                   np.asarray(tp[k], np.float64)).ravel()
        free = bound[k][-1] > TREE_TOL * top
        held += int((~free).sum())
        exempt += int(free.sum())
        assert (d[~free] <= TREE_TOL * top).all(), (
            k, d[~free].max(), TREE_TOL * top)
        assert (d[free] <= bound[k][-1][free] + TREE_TOL * top).all(), k
        if free.any():
            g = np.abs(np.stack([gr[k].ravel()[free] for gr in grads]))
            print(f"  {k}: {int(free.sum())} elements held to the "
                  f"tools' rounding, reference |g| per step "
                  f"{np.round(g.max(axis=1), 12).tolist()} (leaf's "
                  f"largest {[float(np.abs(gr[k]).max()) for gr in grads]})"
                  f", |Δ| ≤ {d[free].max():.3g}")
    print(f"tree: {held} elements within {TREE_TOL} of the largest leaf "
          f"{top:.3g}, {exempt} held to their rounding bounds")
    assert exempt <= NOISE_FRAC * (held + exempt)


@pytest.mark.parametrize("max_len", [14, 3])
def test_rec_cli_matches_jax(jax_cli, both, tmp_path, max_len):
    """max_len 14 (the tool's default) makes most labels longer than the 8
    frames of a 64-wide crop: the CTC loss then sits on optax's
    log-epsilon floor, where `_hold` holds step 2's loss and the floor's
    elements to the tools' measured rounding. max_len 3 fits every
    label."""
    kw = dict(rec_dim=32, rec_depth=1, structured_frac=0.5, max_len=max_len)
    jax_cli.train_rec(3, 4, 64, 1e-3, str(tmp_path / "jax.npz"), **kw)
    cli.train_rec(3, 4, 64, 1e-3, str(tmp_path / "port.npz"),
                  device="cpu", **kw)
    assert len(both["jax"]["loss"]) == 3
    _hold(both, 3, 1e-3, _ctc_rounding(both))
    assert (tmp_path / "port.npz").exists()


@pytest.fixture()
def fixed_det_batch(monkeypatch):
    """det_batch of both renderers → one seeded half-batch of 64² pages."""
    rng = np.random.default_rng(3)
    imgs = rng.normal(0, 1, (1, 64, 64, 3)).astype(np.float32)
    maps = np.zeros((1, 64, 64), np.float32)
    maps[0, 20:30, 8:50] = 1.0
    masks = np.ones((1, 64, 64), np.float32)

    def det_batch(self, batch, size=320, hard_frac=0.0, table_frac=0.0):
        assert (batch, size) == (1, 64)
        return imgs.copy(), maps.copy(), masks.copy()
    monkeypatch.setattr(jsynth.TextRenderer, "det_batch", det_batch)
    monkeypatch.setattr(synth.TextRenderer, "det_batch", det_batch)


DONOR = str(REPO / "onnxocr_tpu" / "assets" / "ppocrv5" / "det" /
            "native_params.npz")


@pytest.mark.parametrize("mode", ["init_from", "distill_from"])
def test_det_cli_matches_jax(jax_cli, both, fixed_det_batch, tmp_path, mode):
    kw = {mode: DONOR}
    jax_cli.train_det(2, 2, 64, 1e-3, str(tmp_path / "jax.npz"), **kw)
    cli.train_det(2, 2, 64, 1e-3, str(tmp_path / "port.npz"), device="cpu",
                  **kw)
    assert len(both["jax"]["loss"]) == 2
    _hold(both, 2, 1e-3)


@pytest.mark.parametrize("steps,lr", [(40, 1e-3), (1000, 3e-4), (7, 2e-3)])
def test_schedule_equals_optax(steps, lr):
    warmup = min(100, max(1, steps // 10))
    decay = max(steps, warmup + 1)
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, decay,
                                              lr * 0.05)
    got = optim.warmup_cosine_decay(0.0, lr, warmup, decay, lr * 0.05)
    for count in range(steps + 3):
        assert got(count) == np.float32(want(count)), count


def test_cli_needs_cuda_or_device_cpu_and_writes_under_build():
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "onnxocr_tpu_torch.tools.train_synthetic",
         "rec", "--steps", "1"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    for which in ("rec", "det"):
        out = Path(cli.default_out(which)).resolve()
        assert out.is_relative_to(REPO / "build")
        assert not out.is_relative_to(REPO / "onnxocr_tpu")
    args = cli.parser().parse_args(["det"])
    assert args.device == "cuda" and args.out is None

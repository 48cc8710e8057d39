"""CTC training for the native recognizers (SVTR, and the CRNN of the
server family). Counterpart of onnxocr_tpu/train/rec_trainer.py.

Loss: optax.ctc_loss (blank 0, log_epsilon −1e5, the logits unpadded),
averaged over the batch. `ctc_loss` below is a port of optax's forward
recursion, not F.ctc_loss: the two agree on a feasible label, but where a
label needs more steps than the logits have, optax's −1e5 in place of
log 0 gives a finite loss near 1e5·k with finite gradients, and F.ctc_loss
gives inf (or 0 under zero_infinity). Porting the recursion keeps optax's
value on every row without a host-side feasibility check; it costs T small
steps of (B, L + 1) tensors forward and back.

A step takes the model and the batch and updates the model in place (see
train/det_trainer.py). Images are (B, 48, W, 3) in [−1, 1], as in JAX;
labels (B, L) int (0 = blank / pad); label_paddings (B, L) 1.0 where padded.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import convert, svtr
from ..parallel import mesh as mesh_lib
from ..pipeline.system import resolve_device
from .optim import adamw, trainable


def ctc_loss(logits, labels, label_paddings,
             log_epsilon: float = -1e5) -> torch.Tensor:
    """optax.ctc_loss(logits, zeros (B, T), labels, label_paddings,
    blank_id=0) → (B,) per-sequence losses, by optax's recursion over the
    blank states phi (B, L + 1) and the label states emit (B, L)."""
    B, T, _ = logits.shape
    L = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    labellens = L - label_paddings.sum(1).long()
    # repeat[b, n] = 1 where label n + 1 repeats label n
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype),
                   (0, 1))
    emit = logprobs.gather(2, labels[:, None, :].expand(B, T, L))
    blank = logprobs[:, :, :1]
    phi = torch.full((B, L + 1), log_epsilon, dtype=logprobs.dtype,
                     device=logprobs.device)
    phi[:, 0] = 0.0
    em = torch.full((B, L), log_epsilon, dtype=logprobs.dtype,
                    device=logprobs.device)

    def add_phi(p, score):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)], 1)

    for t in range(T):
        # emit → phi epsilon move, except onto a repeated label
        prev = add_phi(phi, em + log_epsilon * repeat)
        next_em = torch.logaddexp(prev[:, :-1] + emit[:, t], em + emit[:, t])
        # blank self-loop; emit → phi blank move only before a repeat
        next_phi = add_phi(prev + blank[:, t],
                           em + blank[:, t] + log_epsilon * (1.0 - repeat))
        phi, em = next_phi, next_em
    last = add_phi(phi, em)
    return -last.gather(1, labellens[:, None])[:, 0]


def _logits(model, images, dtype, valid_t=None) -> torch.Tensor:
    x = images.to(dtype).permute(0, 3, 1, 2)
    if isinstance(model, svtr.SVTR):
        return model(x, valid_t).float()
    return model(x).float()


def ctc_loss_fn(model, images, labels, label_paddings, dtype=torch.float32,
                valid_t=None) -> torch.Tensor:
    """The mean CTC loss of the batch. valid_t (B,) masks an SVTR's width
    beyond each row's valid token count, as the inference forward does; the
    CRNN takes no mask (JAX's `model_mod` choice is the model's class)."""
    return ctc_loss(_logits(model, images, dtype, valid_t), labels,
                    label_paddings).mean()


def make_train_step(optimizer: torch.optim.Optimizer, dtype=torch.float32,
                    device="cuda"):
    """step(model, images, labels, label_paddings, valid_t=None) → the loss
    before the update (a device scalar; nothing waits for it)."""
    dev = resolve_device(device)

    def step(model, images, labels, label_paddings, valid_t=None):
        images, labels, label_paddings = (
            torch.as_tensor(a, device=dev)
            for a in (images, labels, label_paddings))
        if valid_t is not None:
            valid_t = torch.as_tensor(valid_t, device=dev)
        optimizer.zero_grad(set_to_none=True)
        loss = ctc_loss_fn(model, images, labels, label_paddings, dtype,
                           valid_t)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def make_sharded_train_step(mesh: mesh_lib.Mesh,
                            optimizer: torch.optim.Optimizer,
                            dtype=torch.float32):
    """The dp × tp step over `mesh`: step(placed, images, labels,
    label_paddings) → loss, `placed` from mesh.shard_rec_params and the
    optimizer over `placed.parameters()`. The batch splits over `data` (B
    must divide evenly; arrays not yet sharded are placed here); row i's
    body runs on its first device, each head shard (i, j) computes its
    vocab slice of the logits where it lives, and the slices meet on the
    row's first device for the full-vocabulary CTC loss. The loss is the
    mean of the rows' means (the batch mean); its backward gives each
    row's gradients, which are summed into the master leaves (the
    data-axis psum of the replicated leaves and of each head shard's
    column) before one AdamW update, copied back to every row after it.
    Like JAX's sharded step, it passes no valid_t."""
    grid = mesh.devices

    def placed(a, ndim):
        if isinstance(a, mesh_lib.Sharded):
            return a
        return mesh_lib.data_sharding(mesh, ndim).place(torch.as_tensor(a))

    def step(params: mesh_lib.ShardedRec, images, labels, label_paddings):
        images = placed(images, 4)
        labels, label_paddings = placed(labels, 2), placed(label_paddings, 2)
        optimizer.zero_grad(set_to_none=True)
        losses = []
        for i, body in enumerate(params.body):
            x = images.shards[i, 0].to(dtype).permute(0, 3, 1, 2)
            feats = body.features(x)
            logits = torch.cat([
                (feats.to(grid[i, j]) @ params.head_w.shards[i, j]
                 + params.head_b.shards[i, j]).to(grid[i, 0])
                for j in range(grid.shape[1])], -1)
            losses.append(ctc_loss(logits, labels.shards[i, 0],
                                   label_paddings.shards[i, 0])
                          .mean().to(grid[0, 0]))
        loss = torch.stack(losses).mean()
        loss.backward()
        params.reduce_grads()
        optimizer.step()
        params.sync()
        return loss.detach()
    return step


def init_training(seed: int, vocab_size: int, lr: float = 1e-3,
                  device="cuda"):
    """→ (model, optimizer): the SVTR of JAX's `init_training(
    PRNGKey(seed), vocab_size, lr)` (its tree leaf for leaf) in training
    mode on `device`, and its AdamW (weight decay 1e-5)."""
    dev = resolve_device(device)
    model = convert.build_svtr(svtr.init(seed, vocab_size), dev)
    return model, adamw(trainable(model), lr, weight_decay=1e-5)

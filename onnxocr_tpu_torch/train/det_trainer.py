"""DBNet detector training: shrink-map BCE + dice loss. Counterpart of
onnxocr_tpu/train/det_trainer.py.

The simplified DB objective of the JAX package (arXiv:1911.08947 §3.4,
binarize branch only): balanced BCE whose negatives are weighted by their
own loss (3:1 against the positives, without a dynamic top-k), plus dice.
The negative weights are not detached: JAX differentiates through them.

A step takes the model and the batch and updates the model in place
through the optimizer the factory was given (JAX's step returns the new
params and optimizer state). Images are (B, H, W, 3) ImageNet-normalized,
as in JAX; numpy arrays are uploaded to the step's device. `dtype` is the
images' compute dtype: with bfloat16 only the images are cast, the
parameters stay float32 (the first conv then rounds its weight, as JAX's
does).
"""
from __future__ import annotations

import torch

from ..models import convert, dbnet
from ..models.common import clip
from ..pipeline.system import resolve_device
from .optim import adamw, trainable


def _probs(model, images, dtype) -> torch.Tensor:
    """(B, H, W, 3) → (B, H, W) float32 shrink-prob map."""
    return model(images.to(dtype).permute(0, 3, 1, 2)).float()


def _db_loss(probs, shrink_maps, shrink_masks) -> torch.Tensor:
    eps = 1e-6
    probs = clip(probs, eps, 1 - eps)
    bce = -(shrink_maps * torch.log(probs) +
            (1 - shrink_maps) * torch.log(1 - probs))
    pos = shrink_maps * shrink_masks
    neg = (1 - shrink_maps) * shrink_masks
    n_pos = clip(pos.sum(), 1.0)
    # negatives weighted by their loss, to ~3:1 against the positives
    neg_w = neg * bce
    neg_w = neg_w / clip(neg_w.sum(), eps) * (3.0 * n_pos)
    bce_loss = (bce * pos).sum() / n_pos + \
        (bce * neg_w).sum() / clip(3.0 * n_pos, 1.0) * 3.0
    inter = (probs * pos).sum()
    union = (probs * shrink_masks).sum() + pos.sum() + eps
    dice = 1.0 - 2.0 * inter / union
    return bce_loss + dice


def db_loss_fn(model, images, shrink_maps, shrink_masks,
               dtype=torch.float32) -> torch.Tensor:
    """images (B, H, W, 3); shrink_maps (B, H, W) ∈ {0, 1}; shrink_masks
    (B, H, W) valid-pixel mask → the scalar loss."""
    return _db_loss(_probs(model, images, dtype), shrink_maps, shrink_masks)


def distill_loss_fn(model, images, shrink_maps, shrink_masks,
                    teacher_probs, w: float,
                    dtype=torch.float32) -> torch.Tensor:
    """The GT loss blended with a soft-target BCE against a teacher's prob
    map; w weighs the distill term. One student forward serves both terms
    (JAX writes two, which XLA merges)."""
    probs = _probs(model, images, dtype)
    gt = _db_loss(probs, shrink_maps, shrink_masks)
    eps = 1e-6
    probs = clip(probs, eps, 1 - eps)
    t = clip(teacher_probs, 0.0, 1.0)
    soft = -(t * torch.log(probs) + (1 - t) * torch.log(1 - probs))
    soft = (soft * shrink_masks).sum() / clip(shrink_masks.sum(), 1.0)
    return (1.0 - w) * gt + w * soft


def _update(optimizer, loss) -> torch.Tensor:
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def make_train_step(optimizer: torch.optim.Optimizer, dtype=torch.float32,
                    device="cuda"):
    """step(model, images, shrink_maps, shrink_masks) → the loss before the
    update (a device scalar; nothing waits for it). The gradients stay in
    the parameters' `.grad` until the next step."""
    dev = resolve_device(device)

    def step(model, images, shrink_maps, shrink_masks):
        images, shrink_maps, shrink_masks = (
            torch.as_tensor(a, device=dev)
            for a in (images, shrink_maps, shrink_masks))
        return _update(optimizer, db_loss_fn(model, images, shrink_maps,
                                             shrink_masks, dtype))
    return step


def make_distill_step(optimizer: torch.optim.Optimizer, w: float = 0.7,
                      dtype=torch.float32, device="cuda"):
    """step(model, teacher, images, shrink_maps, shrink_masks) → loss: the
    teacher (its own model, JAX's teacher params; a MobileNetV3 DBNet for a
    ResNet18-vd student) runs without gradient on the same batch, then the
    student takes one distillation update."""
    dev = resolve_device(device)

    def step(model, teacher, images, shrink_maps, shrink_masks):
        images, shrink_maps, shrink_masks = (
            torch.as_tensor(a, device=dev)
            for a in (images, shrink_maps, shrink_masks))
        with torch.no_grad():
            t_probs = _probs(teacher, images, dtype)
        return _update(optimizer, distill_loss_fn(
            model, images, shrink_maps, shrink_masks, t_probs, w, dtype))
    return step


def init_training(seed: int, lr: float = 1e-3, backbone_arch: str = "mbv3",
                  device="cuda"):
    """→ (model, optimizer): the DBNet of JAX's `init_training(
    PRNGKey(seed), lr, backbone_arch)` (its tree leaf for leaf: JAX seeds
    numpy from the key's last word) in training mode on `device`, and its
    AdamW (weight decay 1e-5)."""
    dev = resolve_device(device)
    model = convert.build_dbnet(dbnet.init(seed, backbone_arch=backbone_arch),
                                dev, backbone_arch)
    return model, adamw(trainable(model), lr, weight_decay=1e-5)

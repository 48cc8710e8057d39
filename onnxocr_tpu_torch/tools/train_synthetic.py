"""Train the native det / rec models on synthetic rendered text and save
their checkpoints. Counterpart of the JAX package's
tools/train_synthetic.py: the same flags and defaults, the same renderer
(train/synth.py) on the host, the training steps (train/det_trainer.py,
train/rec_trainer.py) on the card.

Usage:
  python -m onnxocr_tpu_torch.tools.train_synthetic rec --steps 3000 --batch 64
  python -m onnxocr_tpu_torch.tools.train_synthetic det --steps 1500 --batch 8
  (add --device cpu to run on the CPU)

Differences from the JAX tool: `--device` (default cuda; without CUDA the
tool exits unless --device cpu is given), and the default `--out`, which is
build/train/ppocrv5/{rec,det}/native_params.npz and never the committed
checkpoints under onnxocr_tpu/assets/ that the JAX tool overwrites.
Batches are rendered as numpy on the host by two producer threads and
copied to the card from pinned memory without blocking the step.
"""
from __future__ import annotations

import argparse
import gc
import os
import queue
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .. import config as cfg
from ..models import convert, crnn, svtr
from ..ops import ctc as ctc_ops
from ..ops.ctc import CTCLabelDecode
from ..pipeline.system import resolve_device
from ..train import det_trainer, optim, rec_trainer, synth
from ..utils import params_io

BUILD_TRAIN = Path(__file__).resolve().parents[2] / "build" / "train"


def default_out(which: str, family: str = "ppocrv5") -> str:
    """build/train/<family>/<which>/native_params.npz of the checkout."""
    return str(BUILD_TRAIN / family / which / "native_params.npz")


def _schedule(steps: int, lr: float):
    """The JAX tool's optax.warmup_cosine_decay_schedule."""
    warmup = min(100, max(1, steps // 10))
    return optim.warmup_cosine_decay(0.0, lr, warmup,
                                     max(steps, warmup + 1), lr * 0.05)


def _to_device(arrays, dev: torch.device):
    """numpy arrays → tensors on `dev`: pinned host memory copied without
    blocking on CUDA, plain tensors on the CPU (None passes through)."""
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out.append(t)
    return out


def _set_lr(optimizer, lr) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def train_rec(steps: int, batch: int, width: int, lr: float, out: str,
              arch: str = "svtr", dict_rel: str = "ppocrv5/ppocrv5_dict.txt",
              use_space: bool = True, init_from: str = "",
              widths: tuple = (), charset: str = "full", seed: int = 0,
              max_len: int = 14, structured_frac: float = 0.0,
              lowres_frac: float = 0.0, photo_frac: float = 0.0,
              dotmatrix_frac: float = 0.0, rec_dim: int = 0,
              rec_depth: int = 0, rec_width_mult: float = 1.0,
              replay: int = 1, device: str = "cuda"):
    dev = resolve_device(device)
    dict_path = cfg.find_asset(dict_rel)
    dec = CTCLabelDecode(dict_path, use_space_char=use_space)
    vocab = len(dec.character)
    c2i = synth.charset_from_dict(
        dict_path,
        charset=None if charset == "full" else synth.DEFAULT_CHARSET)
    renderer = synth.TextRenderer(char_to_idx=c2i, seed=seed,
                                  structured_frac=structured_frac,
                                  lowres_frac=lowres_frac,
                                  photo_frac=photo_frac,
                                  dotmatrix_frac=dotmatrix_frac)
    renderer2 = synth.TextRenderer(char_to_idx=c2i, seed=seed + 1000,
                                   structured_frac=structured_frac,
                                   lowres_frac=lowres_frac,
                                   photo_frac=photo_frac,
                                   dotmatrix_frac=dotmatrix_frac)
    print(f"arch={arch} vocab={vocab} dict-mapped={len(c2i)} "
          f"renderable={len(renderer.charset)}")

    is_svtr = arch != "crnn"
    if is_svtr:
        init_kw = {}
        if rec_dim:
            init_kw["dim"] = rec_dim
        if rec_depth:
            init_kw["depth"] = rec_depth
        if rec_width_mult != 1.0:
            init_kw["width_mult"] = rec_width_mult
        tree = svtr.init(seed, vocab, **init_kw)
    else:
        tree = crnn.init(seed, vocab)
    if init_from and os.path.exists(init_from):
        tree = params_io.load_tree(init_from)
        print(f"fine-tuning from {init_from}")
    model = (convert.build_svtr if is_svtr else convert.build_crnn)(tree,
                                                                    dev)
    schedule = _schedule(steps, lr)
    optimizer = optim.adamw(optim.trainable(model), float(schedule(0)),
                            weight_decay=1e-5)
    step_fn = rec_trainer.make_train_step(optimizer, device=dev)

    # fixed label length; optional width mixing cycles through a small
    # ladder. Each producer thread renders with its own renderer (numpy's
    # generator is not thread-safe) into its own queue.
    width_cycle = list(widths) or [width]
    # the SVTR trains with the attention width mask on (valid_t from the
    # true rendered widths), as the inference forward runs; the CRNN has
    # no mask
    mask_widths = is_svtr

    def gen_batch(r, step):
        w_cur = width_cycle[step % len(width_cycle)]
        imgs, labels, pads, ws = r.rec_batch(batch, w_cur, max_len,
                                             return_widths=True)
        if labels.shape[1] < max_len:
            pad_n = max_len - labels.shape[1]
            labels = np.pad(labels, ((0, 0), (0, pad_n)))
            pads = np.pad(pads, ((0, 0), (0, pad_n)), constant_values=1.0)
        vt = ((ws + 7) // 8).astype(np.int32) if mask_widths else None
        return imgs, labels[:, :max_len], pads[:, :max_len], vt

    # two producers, striped by step parity so every width in the cycle
    # keeps appearing
    queues = [queue.Queue(maxsize=3), queue.Queue(maxsize=3)]

    # --replay k: feed each freshly rendered batch k times (rendering is
    # host work; fresh data still arrives every k steps)
    def producer(r, qi):
        b = None
        for s in range(qi, steps, 2):
            if b is None or (s // 2) % max(replay, 1) == 0:
                b = gen_batch(r, s)
            queues[qi].put(b)

    threading.Thread(target=producer, args=(renderer, 0), daemon=True).start()
    threading.Thread(target=producer, args=(renderer2, 1),
                     daemon=True).start()

    t0 = time.time()
    for step in range(steps):
        imgs, labels, pads, vt = _to_device(queues[step % 2].get(), dev)
        _set_lr(optimizer, schedule(step))
        loss = step_fn(model, imgs, labels, pads, vt)
        if step % 50 == 0 or step == steps - 1:
            print(f"rec step {step} loss {float(loss):.4f} "
                  f"({time.time()-t0:.1f}s)", flush=True)
        if step and step % 150 == 0:
            params_io.save_tree(out, convert.tree_from_model(model))
            gc.collect()
    params_io.save_tree(out, convert.tree_from_model(model))
    print("saved", out)

    # quick eval: greedy-decode a fresh batch
    imgs, labels, pads, ws = renderer.rec_batch(8, width, max_len,
                                                return_widths=True)
    x, vt = _to_device((imgs, ((ws + 7) // 8).astype(np.int32)), dev)
    with torch.no_grad():
        x = x.permute(0, 3, 1, 2)
        logits = model(x, vt) if mask_widths else model(x)
        idx, prob = ctc_ops.ctc_reduce_logits(logits.float())
    res = dec.decode_indices(idx.cpu().numpy(), prob.cpu().numpy(),
                             is_remove_duplicate=True)
    for i, (text, score) in enumerate(res):
        truth = "".join(dec.character[j] for j, p in
                        zip(labels[i], pads[i]) if p == 0.0)
        print(f"  pred={text!r} truth={truth!r} score={score:.2f}")


def _graft_matching(dst, src):
    """Copy leaves from src into dst wherever the tree paths exist in both
    and the shapes match (warm-starting a different backbone keeps the FPN
    smooth convs + head). Returns (tree, n_copied)."""
    copied = 0

    def rec(d, s):
        nonlocal copied
        if isinstance(d, dict) and isinstance(s, dict):
            return {k: rec(v, s[k]) if k in s else v for k, v in d.items()}
        if isinstance(d, list) and isinstance(s, list):
            return [rec(dv, sv) for dv, sv in zip(d, s)] + d[len(s):]
        if hasattr(d, "shape") and hasattr(s, "shape") and d.shape == s.shape:
            copied += 1
            return np.asarray(s, dtype=d.dtype)
        return d

    return rec(dst, src), copied


def train_det(steps: int, batch: int, size: int, lr: float, out: str,
              arch: str = "mbv3", seed: int = 0, init_from: str = "",
              hard_frac: float = 0.0, table_frac: float = 0.0,
              structured_frac: float = 0.0, replay: int = 1,
              distill_from: str = "", distill_w: float = 0.7,
              device: str = "cuda"):
    dev = resolve_device(device)
    dict_path = cfg.find_asset("ppocrv5/ppocrv5_dict.txt")
    c2i = synth.charset_from_dict(dict_path, charset=None)
    renderer = synth.TextRenderer(char_to_idx=c2i, seed=seed + 1,
                                  structured_frac=structured_frac)
    renderer2 = synth.TextRenderer(char_to_idx=c2i, seed=seed + 1001,
                                   structured_frac=structured_frac)

    model, _ = det_trainer.init_training(seed, lr, backbone_arch=arch,
                                         device=dev)
    if init_from and os.path.exists(init_from):
        donor = params_io.load_tree(init_from)
        tree, n = _graft_matching(convert.tree_from_model(model), donor)
        model = convert.build_dbnet(tree, dev, arch)
        print(f"warm-started {n} matching tensors from {init_from}")
    schedule = _schedule(steps, lr)
    optimizer = optim.adamw(optim.trainable(model), float(schedule(0)),
                            weight_decay=1e-5)
    teacher = None
    if distill_from:
        teacher = convert.build_dbnet(params_io.load_tree(distill_from), dev,
                                      "mbv3")
        print(f"distilling from teacher {distill_from} (w={distill_w})")
        step_fn = det_trainer.make_distill_step(optimizer, w=distill_w,
                                                device=dev)
    else:
        step_fn = det_trainer.make_train_step(optimizer, device=dev)

    q = queue.Queue(maxsize=4)
    half = (batch + 1) // 2  # 2*half >= batch; consumer trims to batch

    # --replay: as the rec trainer's
    def producer(r, n_items):
        b = None
        for i in range(n_items):
            if b is None or i % max(replay, 1) == 0:
                b = r.det_batch(half, size, hard_frac=hard_frac,
                                table_frac=table_frac)
            q.put(b)

    # two half-batch producers; the consumer stitches pairs
    threading.Thread(target=producer, args=(renderer, steps),
                     daemon=True).start()
    threading.Thread(target=producer, args=(renderer2, steps),
                     daemon=True).start()

    t0 = time.time()
    for step in range(steps):
        a = q.get()
        b = q.get()
        imgs, maps, masks = _to_device(
            [np.concatenate([a[i], b[i]])[:batch] for i in range(3)], dev)
        _set_lr(optimizer, schedule(step))
        if teacher is not None:
            loss = step_fn(model, teacher, imgs, maps, masks)
        else:
            loss = step_fn(model, imgs, maps, masks)
        if step % 25 == 0 or step == steps - 1:
            print(f"det step {step} loss {float(loss):.4f} "
                  f"({time.time()-t0:.1f}s)", flush=True)
        if step and step % 150 == 0:
            params_io.save_tree(out, convert.tree_from_model(model))
            gc.collect()
    params_io.save_tree(out, convert.tree_from_model(model))
    print("saved", out)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m onnxocr_tpu_torch.tools.train_synthetic")
    ap.add_argument("which", choices=["rec", "det"])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", type=str, default=None,
                    help="checkpoint path (default build/train/ppocrv5/"
                         "<rec|det>/native_params.npz)")
    ap.add_argument("--arch", type=str, default="svtr",
                    choices=["svtr", "crnn"])
    ap.add_argument("--dict", type=str, dest="dict_rel",
                    default="ppocrv5/ppocrv5_dict.txt")
    ap.add_argument("--no-space", action="store_true")
    ap.add_argument("--det-arch", type=str, default="mbv3",
                    choices=["mbv3", "resnet18"])
    ap.add_argument("--init-from", type=str, default="")
    ap.add_argument("--widths", type=str, default="",
                    help="comma list for width-mixed training, e.g. 320,640")
    ap.add_argument("--charset", type=str, default="full",
                    choices=["full", "ascii"],
                    help="full = every dict char the fonts can render")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-len", type=int, default=14)
    ap.add_argument("--hard-frac", type=float, default=0.0,
                    help="fraction of det pages drawn from the photo-ish "
                         "hard renderer (textured bg, clutter, jitter)")
    ap.add_argument("--table-frac", type=float, default=0.0,
                    help="fraction of det pages drawn as ruled tables "
                         "with aligned numeric cells")
    ap.add_argument("--structured-frac", type=float, default=0.0,
                    help="probability a sampled line is words/numbers "
                         "structured text instead of uniform glyph soup")
    ap.add_argument("--lowres-frac", type=float, default=0.0,
                    help="probability a rec line gets the low-res "
                         "degradation (downscale to 8-22 px + optional "
                         "JPEG roundtrip + upscale)")
    ap.add_argument("--photo-frac", type=float, default=0.0,
                    help="probability a rec line renders as scene-photo "
                         "text (textured background, alpha-composited "
                         "ink, photometric jitter)")
    ap.add_argument("--dotmatrix-frac", type=float, default=0.0,
                    help="probability a rec line renders as dot-matrix "
                         "print (boarding passes, receipt printers)")
    ap.add_argument("--rec-dim", type=int, default=0,
                    help="mixer dim for a from-scratch svtr (0 = default "
                         "192); heads derive as dim//32")
    ap.add_argument("--rec-depth", type=int, default=0,
                    help="mixer depth for a from-scratch svtr (0 = 2)")
    ap.add_argument("--rec-width-mult", type=float, default=1.0,
                    help="conv-backbone channel multiplier (from-scratch)")
    ap.add_argument("--replay", type=int, default=1,
                    help="feed each rendered batch N times")
    ap.add_argument("--distill-from", type=str, default="",
                    help="det only: mbv3 teacher checkpoint whose prob "
                         "maps the student trains against (soft-BCE blend)")
    ap.add_argument("--distill-w", type=float, default=0.7,
                    help="weight on the distillation term (det)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    if args.which == "rec":
        out = args.out or default_out("rec")
        widths = tuple(int(w) for w in args.widths.split(",") if w)
        train_rec(args.steps, args.batch, args.width, args.lr, out,
                  arch=args.arch, dict_rel=args.dict_rel,
                  use_space=not args.no_space, init_from=args.init_from,
                  widths=widths, charset=args.charset, seed=args.seed,
                  max_len=args.max_len,
                  structured_frac=args.structured_frac,
                  lowres_frac=args.lowres_frac,
                  photo_frac=args.photo_frac,
                  dotmatrix_frac=args.dotmatrix_frac,
                  rec_dim=args.rec_dim, rec_depth=args.rec_depth,
                  rec_width_mult=args.rec_width_mult, replay=args.replay,
                  device=args.device)
    else:
        out = args.out or default_out("det")
        train_det(args.steps, args.batch, args.size, args.lr, out,
                  arch=args.det_arch, seed=args.seed,
                  init_from=args.init_from, hard_frac=args.hard_frac,
                  table_frac=args.table_frac,
                  structured_frac=args.structured_frac,
                  replay=args.replay, distill_from=args.distill_from,
                  distill_w=args.distill_w, device=args.device)


if __name__ == "__main__":
    main()

"""Net2net depth growth of the SVTR recogniser, as the JAX package's
tools/grow_rec.py grows it: mixer blocks are appended whose out-projections
(proj.w, fc2.w) are zero, so both residual branches add exactly 0 and the
grown net computes the donor's function at step 0.

    python -m onnxocr_tpu_torch.tools.grow_rec \\
        --src onnxocr_tpu/assets/ppocrv5/rec/native_params.npz \\
        --out build/grow_rec/rec_grown.npz --add-depth 4 [--device cuda|cpu]

The new blocks' random leaves (qkv.w, fc1.w, times --init-scale) come from
models/common.split_rng(--seed, 2 · add-depth) and linear_init, the JAX
tool's draws: its jax.random.PRNGKey(seed) maps to default_rng(seed), so
an int seed gives the JAX tool's tree. It saves with utils/params_io (the
float16 npz of the JAX package), then holds the grown SVTR's logits to the
donor's on a seeded (2, 48, 64, 3) input on --device (default cuda; without
CUDA and without --device cpu it exits): max |Δlogits| below 2e-2.
"""
import argparse

import numpy as np


def grow(tree, add_depth: int, seed: int, init_scale: float = 1.0):
    """The tree with `add_depth` zero-output mixer blocks appended (in
    place) → (tree, dim, mlp ratio, donor depth)."""
    from ..models import common as cm
    blocks = tree["mixer"]
    donor_depth = len(blocks)
    dim = int(np.asarray(blocks[0]["ln1"]["scale"]).shape[0])
    mlp = int(np.asarray(blocks[0]["fc1"]["w"]).shape[1]) // dim
    keys = cm.split_rng(seed, 2 * add_depth)
    ki = iter(range(len(keys)))
    f32 = np.float32
    for _ in range(add_depth):
        qkv = cm.linear_init(keys[next(ki)], dim, 3 * dim)
        fc1 = cm.linear_init(keys[next(ki)], dim, mlp * dim)
        blocks.append({
            "ln1": {"scale": np.ones((dim,), f32),
                    "bias": np.zeros((dim,), f32)},
            "qkv": {"w": np.asarray(qkv["w"], f32) * init_scale,
                    "b": np.asarray(qkv["b"], f32)},
            # zero out-projections: the grown net equals the donor
            "proj": {"w": np.zeros((dim, dim), f32),
                     "b": np.zeros((dim,), f32)},
            "ln2": {"scale": np.ones((dim,), f32),
                    "bias": np.zeros((dim,), f32)},
            "fc1": {"w": np.asarray(fc1["w"], f32) * init_scale,
                    "b": np.asarray(fc1["b"], f32)},
            "fc2": {"w": np.zeros((mlp * dim, dim), f32),
                    "b": np.zeros((dim,), f32)},
        })
    tree["mixer"] = blocks
    return tree, dim, mlp, donor_depth


def logits(tree, x: np.ndarray, device: str) -> np.ndarray:
    """The SVTR's logits of NHWC `x` on `device`, in float32."""
    import torch
    from ..models import convert
    model = convert.build_svtr(tree, device=device)
    with torch.inference_mode():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2).to(device))
    return out.float().cpu().numpy()


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--add-depth", type=int, default=4)
    ap.add_argument("--seed", type=int, default=5001)
    ap.add_argument("--init-scale", type=float, default=1.0,
                    help="scale on the random (non-zeroed) inits of the "
                         "new blocks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from .eval_heldout import check_device
    check_device("grow_rec", args.device)
    from ..utils import params_io

    tree = params_io.load_tree(args.src)
    tree, dim, mlp, depth = grow(tree, args.add_depth, args.seed,
                                 args.init_scale)
    print(f"donor: depth={depth} dim={dim} mlp_ratio={mlp}")
    params_io.save_tree(args.out, tree)
    print(f"wrote {args.out}: depth={len(tree['mixer'])}")

    # the grown forward equals the donor's on a seeded input
    donor = params_io.load_tree(args.src)
    grown = params_io.load_tree(args.out)
    x = np.random.default_rng(0).normal(size=(2, 48, 64, 3)).astype(
        np.float32)
    err = float(np.max(np.abs(logits(donor, x, args.device) -
                              logits(grown, x, args.device))))
    print(f"function preservation max|Δlogits| = {err:.3e}")
    if not err < 2e-2:
        raise AssertionError("growth is not function-preserving")
    return err


if __name__ == "__main__":
    main()

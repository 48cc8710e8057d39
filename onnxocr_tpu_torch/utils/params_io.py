"""Native checkpoints: .npz files whose keys are '/'-joined parameter tree
paths ('#i' = list index). float32 leaves are stored as float16 and read
back as float32.

Copy of onnxocr_tpu/utils/params_io.py's `save_tree` and `load_tree` (the
port reads and writes the checkpoints without importing the JAX package),
so a checkpoint either package writes loads in both.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict/list tree → {'/'-joined path: leaf}."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _insert(tree, parts, value):
    head = parts[0]
    if head.startswith("#"):
        idx = int(head[1:])
        while len(tree) <= idx:
            tree.append(None)
        if len(parts) == 1:
            tree[idx] = value
        else:
            if tree[idx] is None:
                tree[idx] = [] if parts[1].startswith("#") else {}
            _insert(tree[idx], parts[1:], value)
    else:
        if len(parts) == 1:
            tree[head] = value
        else:
            if head not in tree:
                tree[head] = [] if parts[1].startswith("#") else {}
            _insert(tree[head], parts[1:], value)


def unflatten(flat: Dict[str, Any]):
    """{'/'-joined path: leaf} → nested dict/list tree (`flatten`'s
    inverse)."""
    root: Any = None
    for k, v in flat.items():
        parts = k.split("/")
        if root is None:
            root = [] if parts[0].startswith("#") else {}
        _insert(root, parts, v)
    return root


def save_tree(path: str, tree) -> None:
    """Nested dict/list tree of numpy arrays → .npz checkpoint, float32
    leaves stored as float16 (the JAX package's default)."""
    store = {}
    for k, v in flatten(tree).items():
        v = np.asarray(v)
        store[k] = v.astype(np.float16) if v.dtype == np.float32 else v
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **store)


def load_tree(path: str, dtype=np.float32):
    """.npz checkpoint → nested dict/list tree of numpy arrays."""
    with np.load(path) as data:
        return unflatten({k: data[k].astype(dtype)
                          if data[k].dtype == np.float16 else data[k]
                          for k in data.files})

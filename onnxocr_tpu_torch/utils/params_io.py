"""Native checkpoint reader: .npz files whose keys are '/'-joined parameter
tree paths ('#i' = list index), float16 leaves cast to float32.

Copy of onnxocr_tpu/utils/params_io.load_tree (the port reads the committed
checkpoints without importing the JAX package).
"""
from __future__ import annotations

from typing import Any

import numpy as np


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


def load_tree(path: str, dtype=np.float32):
    """.npz checkpoint → nested dict/list tree of numpy arrays."""
    root: Any = None
    with np.load(path) as data:
        for k in data.files:
            parts = k.split("/")
            if root is None:
                root = [] if parts[0].startswith("#") else {}
            v = data[k]
            if v.dtype == np.float16:
                v = v.astype(dtype)
            _insert(root, parts, v)
    return root

"""Graph optimization passes over the parsed ONNX IR. The port's own copy
of onnxocr_tpu/onnx/passes.py (numpy only).

Run by GraphExecutor at load time (optimize=True). The BatchNorm that
follows a Conv is folded into the conv's weights once, on host numpy, so
each call runs one convolution where the graph has two ops:

    conv(x, W) * k + t   ≡   conv(x, W·k) + t        k = γ/√(σ²+ε)
                                                      t = β − μ·k

Also: dead-node elimination (nodes whose outputs feed nothing).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from . import ir


def fold_batchnorm(nodes: List[ir.Node], weights: Dict[str, np.ndarray],
                   output_names: List[str]) -> Tuple[List[ir.Node], int]:
    """Fold BatchNormalization into a preceding Conv when the conv's weights
    are graph constants and the conv output has no other consumer."""
    consumers: Dict[str, int] = {}
    for n in nodes:
        for i in n.inputs:
            consumers[i] = consumers.get(i, 0) + 1
    for o in output_names:
        consumers[o] = consumers.get(o, 0) + 1

    producer: Dict[str, ir.Node] = {}
    for n in nodes:
        for o in n.outputs:
            producer[o] = n

    folded = 0
    remove_ids = set()
    rename: Dict[str, str] = {}
    for n in nodes:
        if n.op_type != "BatchNormalization":
            continue
        if n.outputs[0] in output_names:
            # the rename map only rewrites node *inputs*; a BN that feeds a
            # graph output directly must stay, or the executor would look up
            # a name nothing produces
            continue
        conv = producer.get(n.inputs[0])
        if conv is None or conv.op_type != "Conv":
            continue
        if consumers.get(conv.outputs[0], 0) != 1:
            continue
        w_name = conv.inputs[1]
        if w_name not in weights:
            continue
        if not all(i in weights for i in n.inputs[1:5]):
            continue
        W = weights[w_name].astype(np.float64)
        scale, beta, mean, var = (weights[n.inputs[i]].astype(np.float64)
                                  for i in range(1, 5))
        eps = n.attrs.get("epsilon", 1e-5)
        k = scale / np.sqrt(var + eps)
        W_new = W * k.reshape((-1,) + (1,) * (W.ndim - 1))
        b_old = (weights[conv.inputs[2]].astype(np.float64)
                 if len(conv.inputs) > 2 and conv.inputs[2] in weights
                 else np.zeros(W.shape[0]))
        b_new = (b_old - mean) * k + beta

        weights[w_name + "/bnfold"] = W_new.astype(np.float32)
        weights[w_name + "/bnfold_bias"] = b_new.astype(np.float32)
        conv.inputs = [conv.inputs[0], w_name + "/bnfold",
                       w_name + "/bnfold_bias"]
        # BN's output becomes an alias of the conv output
        rename[n.outputs[0]] = conv.outputs[0]
        remove_ids.add(id(n))
        folded += 1

    out_nodes = []
    for n in nodes:
        if id(n) in remove_ids:
            continue
        n.inputs = [rename.get(i, i) for i in n.inputs]
        out_nodes.append(n)
    return out_nodes, folded


def eliminate_dead_nodes(nodes: List[ir.Node], output_names: List[str]
                         ) -> List[ir.Node]:
    """Drop nodes whose outputs are never consumed (reverse liveness)."""
    live = set(output_names)
    keep_rev: List[ir.Node] = []
    for n in reversed(nodes):
        if any(o in live for o in n.outputs):
            live.update(i for i in n.inputs if i)
            keep_rev.append(n)
    return list(reversed(keep_rev))

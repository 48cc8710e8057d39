"""Weight lifting: ONNX graphs → the port's numpy parameter trees.
Counterpart of onnxocr_tpu/models/lift.py.

The lift is *structural*: graph nodes are scanned in topological order and
conv / BN / fc weights are assigned positionally into the native model's
tree, whose block layout mirrors the exporter's. The tree is in the JAX
layout that models/convert.py reads: ONNX OIHW conv kernels become HWIO
(depthwise (C, 1, k, k) → (k, k, 1, C)), once, here.

`lift_cls` raises ValueError on a graph that is not a MobileNetV3-small-0.35
angle classifier; backend resolution then runs the graph itself
(pipeline/backends.resolve_backend).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..onnx import ir
from . import mobilenetv3 as mbv3


class ConvRecord:
    __slots__ = ("w", "b", "bn")

    def __init__(self, w, b=None, bn=None):
        self.w = w      # OIHW numpy
        self.b = b      # (O,) or None
        self.bn = bn    # dict(scale, bias, mean, var) or None


def _graph_weights(graph: ir.Graph) -> Dict[str, np.ndarray]:
    weights = dict(graph.initializers)
    for n in graph.nodes:
        if n.op_type == "Constant":
            weights[n.outputs[0]] = np.asarray(n.attrs["value"])
    return weights


def collect_conv_records(graph: ir.Graph) -> List[ConvRecord]:
    """Ordered (conv [+ bias] [+ following BN]) records from the graph."""
    weights = _graph_weights(graph)
    nodes = [n for n in graph.nodes if n.op_type != "Constant"]
    bn_by_input = {n.inputs[0]: n for n in nodes
                   if n.op_type == "BatchNormalization"}
    records: List[ConvRecord] = []
    for n in nodes:
        if n.op_type != "Conv":
            continue
        w = weights[n.inputs[1]]
        b = weights[n.inputs[2]] if len(n.inputs) > 2 else None
        bn = None
        bn_node = bn_by_input.get(n.outputs[0])
        if bn_node is not None:
            bn = {"scale": weights[bn_node.inputs[1]],
                  "bias": weights[bn_node.inputs[2]],
                  "mean": weights[bn_node.inputs[3]],
                  "var": weights[bn_node.inputs[4]]}
        records.append(ConvRecord(w, b, bn))
    return records


def collect_fc_records(graph: ir.Graph) -> List[Dict[str, np.ndarray]]:
    """Ordered MatMul / Gemm (+ Add bias) records."""
    weights = _graph_weights(graph)
    nodes = [n for n in graph.nodes if n.op_type != "Constant"]
    add_by_input = {n.inputs[0]: weights[n.inputs[1]] for n in nodes
                    if n.op_type == "Add" and len(n.inputs) == 2 and
                    n.inputs[1] in weights}
    return [{"w": weights[n.inputs[1]], "b": add_by_input.get(n.outputs[0])}
            for n in nodes
            if n.op_type in ("MatMul", "Gemm") and n.inputs[1] in weights]


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _conv_params(rec: ConvRecord) -> Dict[str, Any]:
    p: Dict[str, Any] = {"w": _oihw_to_hwio(rec.w)}
    if rec.b is not None:
        p["b"] = np.asarray(rec.b)
    return p


def _convbn_params(rec: ConvRecord) -> Dict[str, Any]:
    p: Dict[str, Any] = {"conv": _conv_params(rec)}
    if rec.bn is not None:
        p["bn"] = {k: np.asarray(v) for k, v in rec.bn.items()}
    return p


def lift_cls(model: ir.Model) -> Dict[str, Any]:
    """The angle classifier's tree (models/cls.py) from a PaddleOCR angle
    classifier export (MobileNetV3-small 0.35)."""
    graph = model.graph
    recs = collect_conv_records(graph)
    fcs = collect_fc_records(graph)
    if not fcs:
        raise ValueError("cls graph has no final fc")
    cfg = mbv3.scaled_cfg(mbv3.SMALL_CFG, 0.35)
    expected = 1 + sum(3 + (2 if se else 0) for _, _, _, se, _, _ in cfg) + 1
    if len(recs) != expected:
        raise ValueError(
            f"cls graph has {len(recs)} convs, expected {expected} "
            "(not a MobileNetV3-small-0.35 export?)")
    it = iter(recs)
    backbone: Dict[str, Any] = {"stem": _convbn_params(next(it)),
                                "blocks": []}
    for _k, _exp, _cout, se, _act, _s in cfg:
        blk = {"expand": _convbn_params(next(it)),
               "dw": _convbn_params(next(it))}
        if se:
            blk["se"] = {"reduce": _conv_params(next(it)),
                         "expand": _conv_params(next(it))}
        blk["project"] = _convbn_params(next(it))
        backbone["blocks"].append(blk)
    backbone["last"] = _convbn_params(next(it))
    fc = fcs[-1]
    b = fc["b"] if fc["b"] is not None else \
        np.zeros(fc["w"].shape[1], np.float32)
    return {"backbone": backbone,
            "fc": {"w": np.asarray(fc["w"]), "b": np.asarray(b)}}

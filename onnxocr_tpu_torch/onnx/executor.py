"""PyTorch graph executor: runs an ONNX inference graph op by op, eagerly,
on the executor's device. Counterpart of onnxocr_tpu/onnx/executor.py.

This is the compatibility backend replacing the reference's onnxruntime
`InferenceSession` (reference: onnxocr/predict_base.py:7-17). Constant
nodes are folded into the weights and each Conv's BatchNormalization is
folded into it (onnx/passes.py) at load. Small or integer weights stay
host numpy, so that shape arithmetic (Shape → Slice → Concat → Reshape,
Resize scales) runs on the host; every other weight is uploaded to the
device once, at load. A call runs under `torch.inference_mode()` and reads
nothing back from the device: a graph's outputs stay there.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from . import ir, ops

# Weights at or below this element count, and integer weights, stay static
# numpy constants so that shape arithmetic (Reshape targets, Slice bounds,
# Resize scales) stays on the host; bigger ones are uploaded to the device
# once.
_STATIC_SIZE_LIMIT = 64


def _device(device) -> torch.device:
    """CUDA unless the caller asks for the CPU; an error, not a CPU run,
    when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the graph on the CPU")
    return dev


class GraphExecutor:
    def __init__(self, model: Union[str, ir.Model], name: str = "",
                 optimize: bool = True, device: Optional[Any] = None):
        if isinstance(model, str):
            model = ir.load_model(model)
        self.model = model
        self.name = name or model.graph.name
        self.opset = model.opset or 11
        self.device = _device(device)
        g = model.graph

        # Fold weights: initializers plus paddle2onnx-style Constant nodes.
        weights: Dict[str, np.ndarray] = dict(g.initializers)
        self.nodes: List[ir.Node] = []
        for node in g.nodes:
            if node.op_type == "Constant":
                val = node.attrs.get("value")
                if val is None:  # value_float / value_int variants
                    for k in ("value_float", "value_int"):
                        if k in node.attrs:
                            val = np.asarray(node.attrs[k])
                if val is None:
                    raise ValueError(f"Constant {node.name} without value")
                weights[node.outputs[0]] = np.asarray(val)
            else:
                self.nodes.append(node)

        self.folded_bn = 0
        if optimize:
            from . import passes
            out_names = [vi.name for vi in g.outputs]
            self.nodes, self.folded_bn = passes.fold_batchnorm(
                self.nodes, weights, out_names)
            self.nodes = passes.eliminate_dead_nodes(self.nodes, out_names)

        self.static_weights: Dict[str, np.ndarray] = {}
        self.device_weights: Dict[str, torch.Tensor] = {}
        for k, v in weights.items():
            if v.size <= _STATIC_SIZE_LIMIT or np.issubdtype(v.dtype,
                                                             np.integer):
                self.static_weights[k] = v
            else:
                self.device_weights[k] = ops.device_array(v, self.device)

        self.input_names = [vi.name for vi in g.inputs]
        self.output_names = [vi.name for vi in g.outputs]
        # static weights uploaded where a device op takes one, and Resize's
        # index tables, each uploaded once (ops._Ctx)
        self._uploads: Dict[Any, torch.Tensor] = {}
        self._static_ids = {id(v) for v in self.static_weights.values()}

    def to(self, device) -> "GraphExecutor":
        """A copy of this executor whose uploaded weights live on `device`
        (a mesh row's replica); the graph and the host constants are
        shared."""
        out = copy.copy(self)
        out.device = _device(device)
        out.device_weights = {k: v.to(out.device)
                              for k, v in self.device_weights.items()}
        out._uploads = {}
        return out

    # -- graph interpretation ----------------------------------------------
    def _interpret(self, weights: Dict[str, Any], feeds: Dict[str, Any]):
        env: Dict[str, Any] = {}
        env.update(self.static_weights)
        env.update(weights)
        env.update(feeds)
        ctx = ops._Ctx(self.opset, self.device, self._uploads,
                       self._static_ids)
        for node in self.nodes:
            vals = [env[n] if n else None for n in node.inputs]
            try:
                outs = ops.get_op(node.op_type)(node, vals, ctx)
            except Exception as e:
                raise RuntimeError(
                    f"while executing {node.op_type} node {node.name!r} "
                    f"in graph {self.name!r}: {e}") from e
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val
        return tuple(ctx.tensor(env[n]) for n in self.output_names)

    # -- public API ---------------------------------------------------------
    def _normalize_feeds(self, feeds) -> Dict[str, Any]:
        if isinstance(feeds, dict):
            pass
        elif isinstance(feeds, (list, tuple)):
            feeds = dict(zip(self.input_names, feeds))
        else:
            feeds = {self.input_names[0]: feeds}
        return {k: v if isinstance(v, torch.Tensor)
                else ops.device_array(v, self.device)
                for k, v in feeds.items()}

    @torch.inference_mode()
    def __call__(self, feeds) -> List[torch.Tensor]:
        """Feeds (a dict by input name, a list in input order, or the one
        input; numpy arrays are uploaded) → the outputs as tensors on the
        device."""
        return list(self._interpret(self.device_weights,
                                    self._normalize_feeds(feeds)))

    # onnxruntime-session-compatible surface: numpy in, numpy out (the one
    # place the executor copies to the host, because the caller asks for
    # host arrays)
    def run(self, output_names=None, input_feed=None) -> List[np.ndarray]:
        arrs = [o.to("cpu").numpy() for o in self.__call__(input_feed)]
        if output_names is None:
            return arrs
        idx = {n: i for i, n in enumerate(self.output_names)}
        return [arrs[idx[n]] for n in output_names]

    def get_inputs(self):
        return [_IoInfo(vi) for vi in self.model.graph.inputs]

    def get_outputs(self):
        return [_IoInfo(vi) for vi in self.model.graph.outputs]


class _IoInfo:
    def __init__(self, vi: ir.ValueInfo):
        self.name = vi.name
        self.shape = vi.shape

"""PyTorch implementations of the ONNX opset-11/13 subset used by the
PaddleOCR model family (DBNet det, MobileNetV3 cls, SVTR/CRNN rec) plus
general glue. Counterpart of onnxocr_tpu/onnx/ops.py, op for op, under the
same registry (`register`, `get_op`).

Design notes
------------
* Values flowing through the executor are either **static** host values
  (numpy arrays / python scalars, used for shape arithmetic so that
  `Reshape` / `Slice` / `Resize` sizes are known on the host) or **device**
  values (torch tensors on the executor's device). An op whose inputs are
  all static runs in numpy, as the JAX module's does; anything touching a
  tensor runs in torch. Nothing here reads a tensor back to the host.
* A static operand of a device op enters as a python scalar where it has
  one element (no upload), else as a tensor uploaded once and cached by the
  executor (`_Ctx.tensor`): a graph's weights and the index tables of
  `Resize` are on the device after the first call, so a steady-state call
  makes no host↔device copy.
* The JAX semantics are kept where they depart from the ONNX spec:
  `Resize` builds its source coordinates with float32 arithmetic and runs
  'cubic' as linear; integer `Div` is true division; `LSTM` ignores
  `seq_lens`; `Cast` to int64 / float64 on the device gives int32 /
  float32; `ConvTranspose` with groups raises.
* Tensors keep ONNX's NCHW layout.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import ir

_REGISTRY: Dict[str, Any] = {}
INT64_MAX = 2 ** 63 - 1

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.bool_): torch.bool,
}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_op(name):
    fn = _REGISTRY.get(name)
    if fn is None:
        raise NotImplementedError(f"ONNX op not implemented: {name}")
    return fn


def is_static(*vals) -> bool:
    return all(
        v is None or isinstance(v, (np.ndarray, np.generic, int, float, bool,
                                    list, tuple))
        for v in vals)


def _np_int_list(v) -> List[int]:
    if v is None:
        return []
    return [int(x) for x in np.asarray(v).reshape(-1)]


def device_array(a: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`, float64 as float32 and the unsigned wide
    integers as int64 (the JAX package's device values are 32-bit floats)."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype not in _TORCH_DTYPES:
        a = a.astype(np.int64)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()   # (np.ascontiguousarray would make a 0-d array 1-d)
    return torch.from_numpy(a).to(device)


class _Ctx:
    """One interpretation: the opset, the device, and the executor's caches
    of uploaded static operands."""

    def __init__(self, opset: int, device, uploads: dict, static_ids: set):
        self.opset = opset
        self.device = device
        self._uploads = uploads
        self._static_ids = static_ids

    def tensor(self, v) -> torch.Tensor:
        """A value as a tensor on the device. A static weight of the graph
        is uploaded once; any other host value is uploaded for this call."""
        if isinstance(v, torch.Tensor):
            return v
        if id(v) in self._static_ids:
            t = self._uploads.get(id(v))
            if t is None:
                t = device_array(v, self.device)
                self._uploads[id(v)] = t
            return t
        return device_array(v, self.device)

    def cached(self, key, build) -> torch.Tensor:
        """A host-built table (numpy) on the device, built and uploaded once
        per key."""
        t = self._uploads.get(key)
        if t is None:
            t = device_array(build(), self.device)
            self._uploads[key] = t
        return t

    def operands(self, vals) -> list:
        """The operands of an elementwise device op: tensors as they are,
        one-element host values as python scalars (which broadcast as the
        array would where the result has at least its rank), other host
        values as device tensors."""
        rank = max(v.dim() for v in vals if isinstance(v, torch.Tensor))
        out = []
        for v in vals:
            if isinstance(v, torch.Tensor):
                out.append(v)
                continue
            a = np.asarray(v)
            if a.size == 1 and a.ndim <= rank and a.dtype != np.float16:
                out.append(a.reshape(()).item())
            else:
                out.append(self.tensor(v))
        return out


def _elemwise(np_fn, torch_fn):
    def impl(node, vals, ctx):
        if is_static(*vals):
            return [np_fn(*[np.asarray(v) for v in vals])]
        return [torch_fn(*ctx.operands(vals))]
    return impl


def _unary(np_fn, torch_fn):
    def impl(node, vals, ctx):
        (x,) = vals
        if is_static(x):
            return [np_fn(np.asarray(x))]
        return [torch_fn(x)]
    return impl


def _logical(np_fn, torch_fn):
    def impl(node, vals, ctx):
        if is_static(*vals):
            return [np_fn(*[np.asarray(v) for v in vals])]
        return [torch_fn(*[ctx.tensor(v).to(torch.bool) for v in vals])]
    return impl


def _minmax(torch_fn, clamp_key):
    def impl(a, b):
        if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
            return torch_fn(a, b)
        t, s = (a, b) if isinstance(a, torch.Tensor) else (b, a)
        if isinstance(s, float) and not t.is_floating_point():
            t = t.to(torch.float32)
        return torch.clamp(t, **{clamp_key: s})
    return impl


# ---------------------------------------------------------------- arithmetic
register("Add")(_elemwise(np.add, lambda a, b: a + b))
register("Sub")(_elemwise(np.subtract, lambda a, b: a - b))
register("Mul")(_elemwise(np.multiply, lambda a, b: a * b))
register("Div")(_elemwise(np.divide, lambda a, b: a / b))
register("Pow")(_elemwise(np.power, lambda a, b: a ** b))
register("Min")(_elemwise(np.minimum, _minmax(torch.minimum, "max")))
register("Max")(_elemwise(np.maximum, _minmax(torch.maximum, "min")))
register("Mod")(_elemwise(np.mod, lambda a, b: a % b))
register("Sqrt")(_unary(np.sqrt, torch.sqrt))
register("Exp")(_unary(np.exp, torch.exp))
register("Log")(_unary(np.log, torch.log))
register("Neg")(_unary(np.negative, torch.neg))
register("Abs")(_unary(np.abs, torch.abs))
register("Floor")(_unary(np.floor, torch.floor))
register("Ceil")(_unary(np.ceil, torch.ceil))
register("Tanh")(_unary(np.tanh, torch.tanh))
register("Sin")(_unary(np.sin, torch.sin))
register("Cos")(_unary(np.cos, torch.cos))
register("Reciprocal")(_unary(np.reciprocal, lambda x: 1.0 / x))
register("Equal")(_elemwise(np.equal, lambda a, b: a == b))
register("Greater")(_elemwise(np.greater, lambda a, b: a > b))
register("GreaterOrEqual")(_elemwise(np.greater_equal, lambda a, b: a >= b))
register("Less")(_elemwise(np.less, lambda a, b: a < b))
register("LessOrEqual")(_elemwise(np.less_equal, lambda a, b: a <= b))
register("Not")(_unary(np.logical_not, torch.logical_not))
register("And")(_logical(np.logical_and, torch.logical_and))
register("Or")(_logical(np.logical_or, torch.logical_or))


@register("Round")
def op_round(node, vals, ctx):
    # ONNX Round is round-half-to-even, as numpy's and torch's are.
    (x,) = vals
    return [np.round(x) if is_static(x) else torch.round(x)]


@register("Erf")
def op_erf(node, vals, ctx):
    (x,) = vals
    return [torch.erf(ctx.tensor(x))]


@register("Sum")
def op_sum(node, vals, ctx):
    if is_static(*vals):
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return [out]
    ops_ = ctx.operands(vals)
    out = ops_[0]
    for v in ops_[1:]:
        out = out + v
    return [out]


@register("Where")
def op_where(node, vals, ctx):
    c, a, b = vals
    if is_static(c, a, b):
        return [np.where(c, a, b)]
    a, b = ctx.operands([a, b]) if not is_static(a, b) else \
        [ctx.tensor(a), ctx.tensor(b)]
    return [torch.where(ctx.tensor(c).to(torch.bool), a, b)]


# ---------------------------------------------------------------- activations
@register("Relu")
def op_relu(node, vals, ctx):
    (x,) = vals
    return [torch.relu(ctx.tensor(x))]


@register("LeakyRelu")
def op_leaky_relu(node, vals, ctx):
    x = ctx.tensor(vals[0])
    alpha = node.attrs.get("alpha", 0.01)
    return [torch.where(x >= 0, x, alpha * x)]


@register("PRelu")
def op_prelu(node, vals, ctx):
    x = ctx.tensor(vals[0])
    slope = ctx.tensor(vals[1])
    # ONNX PRelu broadcasts slope (often shape (C,) or (C,1,1)) against NCHW x.
    if slope.dim() == 1 and x.dim() == 4 and slope.shape[0] == x.shape[1]:
        slope = slope.reshape(1, -1, 1, 1)
    return [torch.where(x >= 0, x, slope * x)]


@register("Sigmoid")
def op_sigmoid(node, vals, ctx):
    return [torch.sigmoid(ctx.tensor(vals[0]))]


@register("HardSigmoid")
def op_hard_sigmoid(node, vals, ctx):
    x = ctx.tensor(vals[0])
    alpha = node.attrs.get("alpha", 0.2)
    beta = node.attrs.get("beta", 0.5)
    return [torch.clamp(alpha * x + beta, 0.0, 1.0)]


@register("HardSwish")
def op_hard_swish(node, vals, ctx):
    x = ctx.tensor(vals[0])
    return [x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)]


@register("Softplus")
def op_softplus(node, vals, ctx):
    x = ctx.tensor(vals[0])
    # jax.nn.softplus is logaddexp(x, 0), without torch's linear threshold
    return [torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                           device=x.device))]


def _bound(v):
    """A Clip bound: a python float for a host value, else the tensor."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v
    return float(np.asarray(v).reshape(-1)[0])


@register("Clip")
def op_clip(node, vals, ctx):
    x = ctx.tensor(vals[0])
    if ctx.opset < 11:
        lo = node.attrs.get("min", -np.inf)
        hi = node.attrs.get("max", np.inf)
    else:
        lo = vals[1] if len(vals) > 1 and vals[1] is not None else -np.inf
        hi = vals[2] if len(vals) > 2 and vals[2] is not None else np.inf
    lo, hi = _bound(lo), _bound(hi)
    if isinstance(lo, torch.Tensor) or lo != -np.inf:
        x = torch.maximum(x, lo) if isinstance(lo, torch.Tensor) \
            else torch.clamp(x, min=lo)
    if isinstance(hi, torch.Tensor) or hi != np.inf:
        x = torch.minimum(x, hi) if isinstance(hi, torch.Tensor) \
            else torch.clamp(x, max=hi)
    return [x]


@register("Softmax")
def op_softmax(node, vals, ctx):
    x = ctx.tensor(vals[0])
    axis = node.attrs.get("axis", 1 if ctx.opset < 13 else -1)
    if ctx.opset < 13:
        # Legacy semantics: flatten to 2D at `axis`, softmax over dim 1.
        shape = x.shape
        ax = axis % x.dim()
        x2 = x.reshape(int(np.prod(shape[:ax]) or 1), -1)
        return [torch.softmax(x2, dim=1).reshape(shape)]
    return [torch.softmax(x, dim=axis)]


@register("LogSoftmax")
def op_log_softmax(node, vals, ctx):
    axis = node.attrs.get("axis", -1)
    return [torch.log_softmax(ctx.tensor(vals[0]), dim=axis)]


@register("Gelu")
def op_gelu(node, vals, ctx):
    approx = node.attrs.get("approximate", "none") == "tanh"
    return [F.gelu(ctx.tensor(vals[0]),
                   approximate="tanh" if approx else "none")]


# ---------------------------------------------------------------- shape glue
@register("Identity")
def op_identity(node, vals, ctx):
    return [vals[0]]


@register("Dropout")
def op_dropout(node, vals, ctx):
    return [vals[0]]


@register("Cast")
def op_cast(node, vals, ctx):
    (x,) = vals
    dt = ir.DTYPE_MAP[node.attrs["to"]]
    if is_static(x):
        return [np.asarray(x).astype(dt)]
    # 64-bit casts stay 32-bit on the device, as the JAX package's do
    if dt == np.int64:
        dt = np.int32
    elif dt == np.float64:
        dt = np.float32
    tdt = _TORCH_DTYPES.get(np.dtype(dt), torch.int64)
    return [x.to(tdt)]


def _shape(x):
    return tuple(np.shape(x)) if is_static(x) else tuple(x.shape)


@register("Shape")
def op_shape(node, vals, ctx):
    (x,) = vals
    # a tensor's shape is host data: no device read
    shape = np.asarray(_shape(x), dtype=np.int64)
    start = node.attrs.get("start", 0)
    end = node.attrs.get("end")
    return [shape[start:end]]


@register("Reshape")
def op_reshape(node, vals, ctx):
    x = vals[0]
    if len(vals) > 1:
        target = _np_int_list(vals[1])
    else:
        target = _np_int_list(node.attrs["shape"])
    in_shape = list(_shape(x))
    out = []
    for i, d in enumerate(target):
        if d == 0 and node.attrs.get("allowzero", 0) == 0:
            out.append(in_shape[i])
        else:
            out.append(d)
    if is_static(x):
        return [np.reshape(np.asarray(x), out)]
    return [torch.reshape(x, out)]


@register("Flatten")
def op_flatten(node, vals, ctx):
    (x,) = vals
    shape = _shape(x)
    axis = node.attrs.get("axis", 1) % (len(shape) + 1)
    lead = int(np.prod(shape[:axis]) or 1)
    if is_static(x):
        return [np.reshape(np.asarray(x), (lead, -1))]
    return [torch.reshape(x, (lead, -1))]


@register("Transpose")
def op_transpose(node, vals, ctx):
    (x,) = vals
    perm = node.attrs.get("perm")
    if is_static(x):
        return [np.transpose(np.asarray(x), perm)]
    if perm is None:
        perm = list(range(x.dim()))[::-1]
    return [x.permute(*perm)]


@register("Squeeze")
def op_squeeze(node, vals, ctx):
    x = vals[0]
    axes = (_np_int_list(vals[1]) if len(vals) > 1 and vals[1] is not None
            else _np_int_list(node.attrs.get("axes")))
    ndim = len(_shape(x))
    if is_static(x):
        if not axes:
            return [np.squeeze(np.asarray(x))]
        return [np.squeeze(np.asarray(x), axis=tuple(a % ndim
                                                     for a in axes))]
    if not axes:
        return [torch.squeeze(x)]
    return [torch.squeeze(x, dim=tuple(a % ndim for a in axes))]


@register("Unsqueeze")
def op_unsqueeze(node, vals, ctx):
    x = vals[0]
    axes = (_np_int_list(vals[1]) if len(vals) > 1 and vals[1] is not None
            else _np_int_list(node.attrs.get("axes")))
    ndim_out = len(_shape(x)) + len(axes)
    out = np.asarray(x) if is_static(x) else x
    for ax in sorted(a % ndim_out for a in axes):
        out = np.expand_dims(out, ax) if is_static(x) else out.unsqueeze(ax)
    return [out]


@register("Concat")
def op_concat(node, vals, ctx):
    axis = node.attrs["axis"]
    if is_static(*vals):
        return [np.concatenate([np.asarray(v) for v in vals], axis=axis)]
    return [torch.cat([ctx.tensor(v) for v in vals], dim=axis)]


@register("Split")
def op_split(node, vals, ctx):
    x = vals[0]
    axis = node.attrs.get("axis", 0)
    if len(vals) > 1 and vals[1] is not None:
        sizes = _np_int_list(vals[1])
    else:
        sizes = _np_int_list(node.attrs.get("split"))
    n_out = len(node.outputs)
    dim = _shape(x)[axis]
    if not sizes:
        sizes = [dim // n_out] * n_out
    offsets = np.cumsum([0] + sizes)
    if is_static(x):
        arr = np.asarray(x)
        return [np.take(arr, range(int(offsets[i]), int(offsets[i + 1])),
                        axis=axis) for i in range(n_out)]
    return [x.narrow(axis, int(offsets[i]), int(sizes[i]))
            for i in range(n_out)]


@register("Gather")
def op_gather(node, vals, ctx):
    x, idx = vals
    axis = node.attrs.get("axis", 0)
    if is_static(x, idx):
        return [np.take(np.asarray(x), np.asarray(idx).astype(np.int64),
                        axis=axis)]
    x = ctx.tensor(x)
    axis %= x.dim()
    idx = ctx.tensor(idx).to(torch.int64)
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return [out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])]


@register("GatherND")
def op_gather_nd(node, vals, ctx):
    x = ctx.tensor(vals[0])
    idx = ctx.tensor(vals[1]).to(torch.int64)
    if node.attrs.get("batch_dims", 0):
        raise NotImplementedError("GatherND batch_dims > 0")
    return [x[tuple(torch.movedim(idx, -1, 0))]]


def _slice_axis(x: torch.Tensor, ax: int, sl: slice) -> torch.Tensor:
    """x[..., sl, ...] on axis `ax`, negative steps included (torch views
    take only positive steps: a negative one slices the flipped axis)."""
    dim = x.shape[ax]
    start, stop, step = sl.indices(dim)
    if step > 0:
        idx = [slice(None)] * x.dim()
        idx[ax] = slice(start, stop, step)
        return x[tuple(idx)]
    idx = [slice(None)] * x.dim()
    idx[ax] = slice(dim - 1 - start, dim - 1 - stop, -step)
    return torch.flip(x, (ax,))[tuple(idx)]


@register("Slice")
def op_slice(node, vals, ctx):
    x = vals[0]
    if ctx.opset < 10:
        starts = _np_int_list(node.attrs["starts"])
        ends = _np_int_list(node.attrs["ends"])
        axes = _np_int_list(node.attrs.get("axes")) or list(range(len(starts)))
        steps = [1] * len(starts)
    else:
        starts = _np_int_list(vals[1])
        ends = _np_int_list(vals[2])
        axes = (_np_int_list(vals[3]) if len(vals) > 3 and vals[3] is not None
                else list(range(len(starts))))
        steps = (_np_int_list(vals[4]) if len(vals) > 4 and vals[4] is not None
                 else [1] * len(starts))
    ndim = len(_shape(x))
    slicers = [slice(None)] * ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        en = None if en >= INT64_MAX else en
        st = None if (sp < 0 and st >= INT64_MAX - 1) else st
        slicers[ax % ndim] = slice(st, en, sp)
    if is_static(x):
        return [np.asarray(x)[tuple(slicers)]]
    for ax, sl in enumerate(slicers):
        if sl != slice(None):
            x = _slice_axis(x, ax, sl)
    return [x]


@register("Expand")
def op_expand(node, vals, ctx):
    x, shape = vals
    target = _np_int_list(shape)
    in_shape = list(_shape(x))
    # ONNX Expand uses numpy broadcasting with dim=1 expansion; target dims
    # may be 1 where input is larger (keep input dim).
    ndim = max(len(target), len(in_shape))
    in_shape = [1] * (ndim - len(in_shape)) + in_shape
    target = [1] * (ndim - len(target)) + target
    out = [max(a, b) for a, b in zip(in_shape, target)]
    if is_static(x):
        return [np.broadcast_to(np.asarray(x).reshape(in_shape), out)]
    return [x.reshape(in_shape).expand(out)]


@register("Tile")
def op_tile(node, vals, ctx):
    x, reps = vals
    reps = _np_int_list(reps)
    if is_static(x):
        return [np.tile(np.asarray(x), reps)]
    return [torch.tile(x, reps)]


@register("ConstantOfShape")
def op_constant_of_shape(node, vals, ctx):
    shape = _np_int_list(vals[0])
    value = node.attrs.get("value")
    if value is None:
        value = np.zeros(1, np.float32)
    value = np.asarray(value).reshape(-1)[0]
    return [np.full(shape, value)]


@register("Range")
def op_range(node, vals, ctx):
    start, limit, delta = [np.asarray(v).reshape(()) for v in vals]
    return [np.arange(start, limit, delta)]


@register("Pad")
def op_pad(node, vals, ctx):
    x = vals[0]
    if ctx.opset < 11:
        pads = _np_int_list(node.attrs["pads"])
        cval = node.attrs.get("value", 0.0)
    else:
        pads = _np_int_list(vals[1])
        cval = (np.asarray(vals[2]).reshape(-1)[0]
                if len(vals) > 2 and vals[2] is not None else 0.0)
    mode = node.attrs.get("mode", "constant")
    ndim = len(_shape(x))
    pad_width = [(int(pads[i]), int(pads[i + ndim])) for i in range(ndim)]
    if is_static(x):
        if mode == "constant":
            return [np.pad(np.asarray(x), pad_width, constant_values=cval)]
        return [np.pad(np.asarray(x), pad_width, mode={
            "reflect": "reflect", "edge": "edge", "wrap": "wrap"}[mode])]
    flat = [p for pair in reversed(pad_width) for p in pair]
    if mode == "constant":
        return [F.pad(x, flat, value=float(cval))]
    tmode = {"reflect": "reflect", "edge": "replicate",
             "wrap": "circular"}[mode]
    # torch pads only the trailing axes in these modes: drop the leading
    # axes' zero pads
    while len(flat) > 2 and flat[-2:] == [0, 0]:
        flat = flat[:-2]
    return [F.pad(x, flat, mode=tmode)]


# ---------------------------------------------------------------- reductions
def _reduce(np_fn, torch_fn):
    def impl(node, vals, ctx):
        x = vals[0]
        if len(vals) > 1 and vals[1] is not None:  # opset 18 axes input
            axes = _np_int_list(vals[1])
        else:
            axes = _np_int_list(node.attrs.get("axes"))
        keepdims = bool(node.attrs.get("keepdims", 1))
        axes_t = tuple(axes) if axes else None
        if is_static(x):
            return [np_fn(np.asarray(x), axis=axes_t, keepdims=keepdims)]
        x = ctx.tensor(x)
        dims = axes_t if axes_t is not None else tuple(range(x.dim()))
        return [torch_fn(x, dims, keepdims)]
    return impl


def _mean(x, dims, keep):
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=dims, keepdim=keep)


def _prod(x, dims, keep):
    for d in sorted((d % x.dim() for d in dims), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keep)
    return x


register("ReduceMean")(_reduce(np.mean, _mean))
register("ReduceSum")(_reduce(
    np.sum, lambda x, d, k: torch.sum(x, dim=d, keepdim=k)))
register("ReduceMax")(_reduce(
    np.max, lambda x, d, k: torch.amax(x, dim=d, keepdim=k)))
register("ReduceMin")(_reduce(
    np.min, lambda x, d, k: torch.amin(x, dim=d, keepdim=k)))
register("ReduceProd")(_reduce(np.prod, _prod))


@register("ReduceL2")
def op_reduce_l2(node, vals, ctx):
    x = ctx.tensor(vals[0])
    axes = tuple(_np_int_list(node.attrs.get("axes"))) or \
        tuple(range(x.dim()))
    keepdims = bool(node.attrs.get("keepdims", 1))
    return [torch.sqrt(torch.sum(x * x, dim=axes, keepdim=keepdims))]


@register("ArgMax")
def op_argmax(node, vals, ctx):
    axis = node.attrs.get("axis", 0)
    keepdims = bool(node.attrs.get("keepdims", 1))
    return [torch.argmax(ctx.tensor(vals[0]), dim=axis,
                         keepdim=keepdims).to(torch.int32)]


@register("ArgMin")
def op_argmin(node, vals, ctx):
    axis = node.attrs.get("axis", 0)
    keepdims = bool(node.attrs.get("keepdims", 1))
    return [torch.argmin(ctx.tensor(vals[0]), dim=axis,
                         keepdim=keepdims).to(torch.int32)]


@register("TopK")
def op_topk(node, vals, ctx):
    x = ctx.tensor(vals[0])
    k = int(np.asarray(vals[1]).reshape(-1)[0])
    axis = node.attrs.get("axis", -1)
    largest = bool(node.attrs.get("largest", 1))
    v, i = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
    return [v, i.to(torch.int32)]


# ---------------------------------------------------------------- matmul
@register("MatMul")
def op_matmul(node, vals, ctx):
    return [torch.matmul(ctx.tensor(vals[0]), ctx.tensor(vals[1]))]


@register("Gemm")
def op_gemm(node, vals, ctx):
    a = ctx.tensor(vals[0])
    b = ctx.tensor(vals[1])
    alpha = node.attrs.get("alpha", 1.0)
    beta = node.attrs.get("beta", 1.0)
    if node.attrs.get("transA", 0):
        a = a.T
    if node.attrs.get("transB", 0):
        b = b.T
    out = alpha * torch.matmul(a, b)
    if len(vals) > 2 and vals[2] is not None:
        out = out + beta * ctx.tensor(vals[2])
    return [out]


@register("Einsum")
def op_einsum(node, vals, ctx):
    return [torch.einsum(node.attrs["equation"],
                         *[ctx.tensor(v) for v in vals])]


# ---------------------------------------------------------------- conv/pool
def _conv_padding(node, spatial: int, in_shape, k_shape, strides, dilations):
    auto_pad = node.attrs.get("auto_pad", "NOTSET")
    if isinstance(auto_pad, bytes):
        auto_pad = auto_pad.decode()
    pads = _np_int_list(node.attrs.get("pads")) or [0] * (2 * spatial)
    if auto_pad in ("NOTSET", "", "VALID"):
        if auto_pad == "VALID":
            return [(0, 0)] * spatial
        return [(pads[i], pads[i + spatial]) for i in range(spatial)]
    # SAME_UPPER / SAME_LOWER
    out = []
    for i in range(spatial):
        eff_k = (k_shape[i] - 1) * dilations[i] + 1
        out_dim = -(-in_shape[i] // strides[i])
        total = max(0, (out_dim - 1) * strides[i] + eff_k - in_shape[i])
        lo = total // 2
        hi = total - lo
        if auto_pad == "SAME_LOWER":
            lo, hi = hi, lo
        out.append((lo, hi))
    return out


def _pad_flat(padding) -> list:
    """[(lo, hi)] per spatial axis → F.pad's flat list, last axis first."""
    return [p for pair in reversed(padding) for p in pair]


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Conv")
def op_conv(node, vals, ctx):
    x = ctx.tensor(vals[0])
    w = ctx.tensor(vals[1])
    spatial = x.dim() - 2
    strides = _np_int_list(node.attrs.get("strides")) or [1] * spatial
    dilations = _np_int_list(node.attrs.get("dilations")) or [1] * spatial
    groups = node.attrs.get("group", 1)
    padding = _conv_padding(node, spatial, x.shape[2:], w.shape[2:], strides,
                            dilations)
    b = ctx.tensor(vals[2]) if len(vals) > 2 and vals[2] is not None \
        else None
    if all(lo == hi for lo, hi in padding):
        pad = [lo for lo, _ in padding]
    else:
        # asymmetric pads: pad first, then a convolution without padding
        x = F.pad(x, _pad_flat(padding))
        pad = [0] * spatial
    return [_CONV[spatial](x, w, b, stride=strides, padding=pad,
                           dilation=dilations, groups=groups)]


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("ConvTranspose")
def op_conv_transpose(node, vals, ctx):
    x = ctx.tensor(vals[0])
    w = ctx.tensor(vals[1])  # ONNX: (C_in, C_out/groups, kH, kW), as torch
    spatial = x.dim() - 2
    strides = _np_int_list(node.attrs.get("strides")) or [1] * spatial
    dilations = _np_int_list(node.attrs.get("dilations")) or [1] * spatial
    groups = node.attrs.get("group", 1)
    pads = _np_int_list(node.attrs.get("pads")) or [0] * (2 * spatial)
    out_pads = _np_int_list(node.attrs.get("output_padding")) or [0] * spatial
    if groups != 1:
        raise NotImplementedError("grouped ConvTranspose")
    # the full transposed convolution, then output_padding as zero rows at
    # each axis' end, then the pads cropped off both ends
    out = _CONV_T[spatial](x, w, None, stride=strides, dilation=dilations)
    if any(out_pads):
        out = F.pad(out, _pad_flat([(0, p) for p in out_pads]))
    for i in range(spatial):
        lo, hi = pads[i], pads[i + spatial]
        if lo or hi:
            out = out.narrow(2 + i, lo, out.shape[2 + i] - lo - hi)
    if len(vals) > 2 and vals[2] is not None:
        out = out + ctx.tensor(vals[2]).reshape((1, -1) + (1,) * spatial)
    return [out]


def _pool_window(node, x, spatial):
    """→ (padding [(lo, hi)] with ceil_mode's extension, kernel, strides,
    dilations), as the JAX package's `_pool` pads its reduce_window."""
    kernel = _np_int_list(node.attrs["kernel_shape"])
    strides = _np_int_list(node.attrs.get("strides")) or [1] * spatial
    dilations = _np_int_list(node.attrs.get("dilations")) or [1] * spatial
    padding = _conv_padding(node, spatial, x.shape[2:], kernel, strides,
                            dilations)
    if node.attrs.get("ceil_mode", 0):
        # Extend hi-padding so the last (partial) window is included.
        padding = list(padding)
        for i in range(spatial):
            eff_k = (kernel[i] - 1) * dilations[i] + 1
            size = x.shape[2 + i] + padding[i][0] + padding[i][1]
            rem = (size - eff_k) % strides[i]
            if rem:
                padding[i] = (padding[i][0],
                              padding[i][1] + strides[i] - rem)
    return padding, kernel, strides, dilations


def _sum_pool(x, kernel, strides, dilations):
    """Window sums of an already padded x."""
    spatial = x.dim() - 2
    if any(d != 1 for d in dilations):
        c = x.shape[1]
        ones = torch.ones((c, 1) + tuple(kernel), dtype=x.dtype,
                          device=x.device)
        return _CONV[spatial](x, ones, None, stride=strides,
                              dilation=dilations, groups=c)
    if spatial == 1:
        return F.avg_pool2d(x[:, :, None], (1, kernel[0]), (1, strides[0]),
                            divisor_override=1)[:, :, 0]
    pool = F.avg_pool2d if spatial == 2 else F.avg_pool3d
    return pool(x, kernel, strides, divisor_override=1)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@register("MaxPool")
def op_max_pool(node, vals, ctx):
    x = ctx.tensor(vals[0])
    spatial = x.dim() - 2
    padding, kernel, strides, dilations = _pool_window(node, x, spatial)
    if any(p for pair in padding for p in pair):
        x = F.pad(x, _pad_flat(padding), value=-float("inf"))
    return [_MAX_POOL[spatial](x, kernel, strides, dilation=dilations)]


@register("AveragePool")
def op_average_pool(node, vals, ctx):
    x = ctx.tensor(vals[0])
    spatial = x.dim() - 2
    padding, kernel, strides, dilations = _pool_window(node, x, spatial)
    flat = _pad_flat(padding)
    summed = _sum_pool(F.pad(x, flat), kernel, strides, dilations)
    if node.attrs.get("count_include_pad", 0):
        return [summed / float(np.prod(kernel))]
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    counts = _sum_pool(F.pad(ones, flat), kernel, strides, dilations)
    return [summed / counts]


@register("GlobalAveragePool")
def op_global_average_pool(node, vals, ctx):
    x = ctx.tensor(vals[0])
    return [torch.mean(x, dim=tuple(range(2, x.dim())), keepdim=True)]


@register("GlobalMaxPool")
def op_global_max_pool(node, vals, ctx):
    x = ctx.tensor(vals[0])
    return [torch.amax(x, dim=tuple(range(2, x.dim())), keepdim=True)]


# ---------------------------------------------------------------- normalization
@register("BatchNormalization")
def op_batch_norm(node, vals, ctx):
    x = ctx.tensor(vals[0])
    eps = node.attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    scale, bias, mean, var = (ctx.tensor(v).reshape(shape)
                              for v in vals[1:5])
    inv = scale * torch.rsqrt(var + eps)
    return [x * inv + (bias - mean * inv)]


@register("LayerNormalization")
def op_layer_norm(node, vals, ctx):
    x = ctx.tensor(vals[0])
    scale = ctx.tensor(vals[1])
    axis = node.attrs.get("axis", -1)
    eps = node.attrs.get("epsilon", 1e-5)
    mean = torch.mean(x, dim=axis, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axis, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps) * scale
    if len(vals) > 2 and vals[2] is not None:
        out = out + ctx.tensor(vals[2])
    return [out]


@register("InstanceNormalization")
def op_instance_norm(node, vals, ctx):
    x = ctx.tensor(vals[0])
    eps = node.attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    scale = ctx.tensor(vals[1]).reshape(shape)
    bias = ctx.tensor(vals[2]).reshape(shape)
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
    return [(x - mean) * torch.rsqrt(var + eps) * scale + bias]


# ---------------------------------------------------------------- resize
def _attr_str(node, name, default):
    v = node.attrs.get(name, default)
    return v.decode() if isinstance(v, bytes) else v


def _src_coords(coord_mode: str, d_out: int, d_in: int) -> np.ndarray:
    """Per-axis source coordinates in float32 arithmetic, as the JAX
    package computes them (a float32 arange against the python-float
    scale, which is taken to float32)."""
    f32 = np.float32
    i = np.arange(d_out, dtype=f32)
    scale = f32(d_out / d_in)
    if coord_mode == "half_pixel":
        return (i + f32(0.5)) / scale - f32(0.5)
    if coord_mode == "pytorch_half_pixel":
        return (i + f32(0.5)) / scale - f32(0.5) if d_out > 1 \
            else np.zeros_like(i)
    if coord_mode == "align_corners":
        if d_out == 1:
            return np.zeros_like(i)
        return i * f32(d_in - 1) / f32(d_out - 1)
    if coord_mode == "asymmetric":
        return i / scale
    raise NotImplementedError(f"coord mode {coord_mode}")


def _nearest_index(coord_mode, nearest_mode, d_out, d_in) -> np.ndarray:
    coords = _src_coords(coord_mode, d_out, d_in)
    if nearest_mode == "floor":
        idx = np.floor(coords)
    elif nearest_mode == "ceil":
        idx = np.ceil(coords)
    elif nearest_mode == "round_prefer_ceil":
        idx = np.floor(coords + np.float32(0.5))
    else:  # round_prefer_floor
        idx = np.ceil(coords - np.float32(0.5))
    return np.clip(idx, 0, d_in - 1).astype(np.int64)


def _linear_table(coord_mode, d_out, d_in) -> np.ndarray:
    """(4, d_out) float32 rows: low index, high index, 1 − frac, frac."""
    c = np.clip(_src_coords(coord_mode, d_out, d_in), 0, d_in - 1)
    lo = np.floor(c)
    hi = np.minimum(lo + 1, d_in - 1)
    frac = (c - lo).astype(np.float32)
    return np.stack([lo, hi, np.float32(1) - frac, frac]).astype(np.float32)


@register("Resize")
def op_resize(node, vals, ctx):
    x = ctx.tensor(vals[0])
    mode = _attr_str(node, "mode", "nearest")
    coord_mode = _attr_str(node, "coordinate_transformation_mode",
                           "half_pixel")
    nearest_mode = _attr_str(node, "nearest_mode", "round_prefer_floor")

    sizes = None
    if len(vals) > 3 and vals[3] is not None and np.size(vals[3]):
        sizes = _np_int_list(vals[3])
    elif len(vals) > 2 and vals[2] is not None and np.size(vals[2]):
        scales = np.asarray(vals[2]).reshape(-1).astype(np.float64)
        sizes = [int(np.floor(d * s)) for d, s in zip(x.shape, scales)]
    elif len(vals) > 1 and vals[1] is not None and np.size(vals[1]) == x.dim():
        # opset-10 style: second input is scales
        scales = np.asarray(vals[1]).reshape(-1).astype(np.float64)
        sizes = [int(np.floor(d * s)) for d, s in zip(x.shape, scales)]
    if sizes is None:
        raise ValueError("Resize without scales or sizes")

    in_sp = tuple(x.shape[2:])
    out_sp = tuple(sizes[2:])
    if out_sp == in_sp:
        return [x]
    out = x
    for ax_off, (d_in, d_out) in enumerate(zip(in_sp, out_sp)):
        axis = 2 + ax_off
        if d_in == d_out:
            continue
        if mode == "nearest":
            idx = ctx.cached(
                ("resize_nearest", coord_mode, nearest_mode, d_out, d_in),
                lambda: _nearest_index(coord_mode, nearest_mode, d_out,
                                       d_in))
            out = torch.index_select(out, axis, idx)
        elif mode in ("linear", "cubic"):
            # cubic runs as linear, as in the JAX package
            tab = ctx.cached(("resize_linear", coord_mode, d_out, d_in),
                             lambda: _linear_table(coord_mode, d_out, d_in))
            bshape = (1,) * axis + (-1,) + (1,) * (x.dim() - axis - 1)
            lo = tab[0].to(torch.int64)
            hi = tab[1].to(torch.int64)
            out = (torch.index_select(out, axis, lo) * tab[2].reshape(bshape)
                   + torch.index_select(out, axis, hi) *
                   tab[3].reshape(bshape))
        else:
            raise NotImplementedError(f"Resize mode {mode}")
    return [out]


@register("Upsample")
def op_upsample(node, vals, ctx):
    return op_resize(node, vals, ctx)


@register("DepthToSpace")
def op_depth_to_space(node, vals, ctx):
    x = ctx.tensor(vals[0])
    bs = node.attrs["blocksize"]
    mode = node.attrs.get("mode", "DCR")
    n, c, h, w = x.shape
    if mode == "DCR":
        x = x.reshape(n, bs, bs, c // (bs * bs), h, w)
        x = x.permute(0, 3, 4, 1, 5, 2)
    else:
        x = x.reshape(n, c // (bs * bs), bs, bs, h, w)
        x = x.permute(0, 1, 4, 2, 5, 3)
    return [x.reshape(n, c // (bs * bs), h * bs, w * bs)]


# ---------------------------------------------------------------- recurrent
@register("LSTM")
def op_lstm(node, vals, ctx):
    """Opset-11 LSTM, used by the server-v2.0 CRNN recognizer head.

    Inputs: X(T,N,I), W(D,4H,I), R(D,4H,H), B(D,8H), seq_lens (ignored),
    init_h, init_c. ONNX gate order is iofc; both biases are summed.
    Returns (Y(T,D,N,H), Y_h, Y_c).
    """
    X = ctx.tensor(vals[0])
    W = ctx.tensor(vals[1])
    R = ctx.tensor(vals[2])
    B = (ctx.tensor(vals[3]) if len(vals) > 3 and vals[3] is not None
         else None)
    init_h = ctx.tensor(vals[5]) if len(vals) > 5 and vals[5] is not None \
        else None
    init_c = ctx.tensor(vals[6]) if len(vals) > 6 and vals[6] is not None \
        else None
    direction = _attr_str(node, "direction", "forward")
    hidden = node.attrs.get("hidden_size", R.shape[-1])
    T, N, _ = X.shape

    def run_dir(d, reverse):
        Wd, Rd = W[d], R[d]
        if B is not None:
            bd = B[d][:4 * hidden] + B[d][4 * hidden:]
        else:
            bd = X.new_zeros((4 * hidden,))
        h = init_h[d] if init_h is not None else X.new_zeros((N, hidden))
        c = init_c[d] if init_c is not None else X.new_zeros((N, hidden))
        xs = torch.flip(X, (0,)) if reverse else X
        # the input projections of the whole sequence as one matmul
        x_proj = torch.einsum("tni,gi->tng", xs, Wd) + bd
        ys = []
        for t in range(T):
            gates = x_proj[t] + h @ Rd.T
            i, o, f, g = torch.split(gates, hidden, dim=-1)
            i = torch.sigmoid(i)
            o = torch.sigmoid(o)
            f = torch.sigmoid(f)
            g = torch.tanh(g)
            c = f * c + i * g
            h = o * torch.tanh(c)
            ys.append(h)
        ys = torch.stack(ys)
        if reverse:
            ys = torch.flip(ys, (0,))
        return ys, h, c

    if direction == "bidirectional":
        y_f, h_f, c_f = run_dir(0, False)
        y_b, h_b, c_b = run_dir(1, True)
        return [torch.stack([y_f, y_b], dim=1), torch.stack([h_f, h_b]),
                torch.stack([c_f, c_b])]
    y, h, c = run_dir(0, direction == "reverse")
    return [y[:, None], h[None], c[None]]

"""Device mesh for the dp × tp recognizer training step and for serving
across cards (parallel/serving.py). Counterpart of
onnxocr_tpu/parallel/mesh.py.

The JAX package runs one SPMD program over a `jax.sharding.Mesh` with axes

  data  — batch sharding (gradient data-parallelism),
  model — tensor parallelism for the CTC head's vocab axis,

and XLA derives the collectives. The port keeps its single-controller form:
one process drives an explicit (data, model) grid of `torch.device`s, places
each shard itself and moves tensors between devices with `.to` (no
torch.distributed, no NCCL). A device may appear in the grid more than once
(the CPU tests build a 4 × 2 grid of 'cpu'); every cell still holds its own
copy.

Serving is data-parallel only: `replicate` holds one copy of a model per
data row, on the row's first device, and `Rows` runs a function on every
row, one worker thread per device, padding the batch to a multiple of the
rows, splitting it evenly and gathering the results in batch order.
"""
from __future__ import annotations

import contextlib
import copy
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import convert
from ..pipeline.system import resolve_device


class Mesh:
    """A (data, model) grid of devices."""

    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """The first `n_devices` of `devices` (default: every CUDA device;
    an error without CUDA) as a (n_devices / model_parallel,
    model_parallel) grid."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % model_parallel or not 0 < n_devices <= len(devices):
        raise ValueError(f"{n_devices} devices of {len(devices)} do not "
                         f"split into a model axis of {model_parallel}")
    grid = np.empty(n_devices, object)
    grid[:] = devices[:n_devices]
    return Mesh(grid.reshape(n_devices // model_parallel, model_parallel))


class Sharded:
    """A tensor placed by a NamedSharding: `shards[i, j]` is the part that
    mesh cell (i, j) holds, on that cell's device."""

    def __init__(self, sharding: "NamedSharding", shards: np.ndarray):
        self.sharding = sharding
        self.shards = shards

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor, on `device` (default: cell (0, 0)'s)."""
        spec = self.sharding.spec
        device = device or self.sharding.mesh.devices[0, 0]
        d, m = self.shards.shape

        def along(axis, parts):
            return torch.cat([p.to(device) for p in parts],
                             spec.index(axis)) if axis in spec else \
                parts[0].to(device)

        return along("data", [along("model", list(self.shards[i]))
                              for i in range(d)])


class NamedSharding:
    """`spec` names, for each leading dimension, the mesh axis it is split
    over, or None (replicated along the unnamed axes)."""

    def __init__(self, mesh: Mesh, spec: Tuple = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def place(self, t: torch.Tensor) -> Sharded:
        """Split t evenly (an error otherwise, as in JAX) and copy each part
        to its cell's device; every cell gets a tensor of its own."""
        grid = self.mesh.devices
        shards = np.empty(grid.shape, object)
        for (i, j), dev in np.ndenumerate(grid):
            part = t
            for dim, axis in enumerate(self.spec):
                if axis is None:
                    continue
                n, k = (grid.shape[0], i) if axis == "data" \
                    else (grid.shape[1], j)
                if part.shape[dim] % n:
                    raise ValueError(f"dimension {dim} of {tuple(t.shape)} "
                                     f"does not split {n} ways")
                size = part.shape[dim] // n
                part = part.narrow(dim, k * size, size)
            shards[i, j] = part.contiguous().to(dev, copy=True)
        return Sharded(self, shards)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def data_sharding(mesh: Mesh, ndim: int = 4) -> NamedSharding:
    return NamedSharding(mesh, ("data",) + (None,) * (ndim - 1))


def row_devices(mesh: Mesh) -> List[torch.device]:
    """The first device of each data row (an error for a CUDA device
    without CUDA)."""
    return [resolve_device(d) for d in mesh.devices[:, 0]]


def replicate(module, mesh: Mesh) -> list:
    """One copy of `module` per data row, on the row's first device. An
    nn.Module is deep-copied and moved with `.to`, which moves its
    non-persistent buffers too (the SVTR head's `w_split`); anything else
    (a graph executor) makes its own copy with `.to(device)`. Along a row's
    model axis the JAX program computes the same thing on every device, so
    the port runs it once per row."""
    if isinstance(module, torch.nn.Module):
        return [copy.deepcopy(module).to(dev) for dev in row_devices(mesh)]
    return [module.to(dev) for dev in row_devices(mesh)]


def _tree_rows(tree, start: int, stop: int):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_rows(t, start, stop) for t in tree)
    return tree[start:stop]


def _gather(outs: list, device):
    """Row outputs (tensors, or tuples of them) → one tree, each leaf the
    rows' leaves concatenated on `device`."""
    if isinstance(outs[0], (tuple, list)):
        return type(outs[0])(_gather([o[k] for o in outs], device)
                             for k in range(len(outs[0])))
    return torch.cat([o.to(device) for o in outs])


_ROW = threading.local()


def current_row() -> Optional[int]:
    """The data row the calling thread is running for `Rows`, else None."""
    return getattr(_ROW, "index", None)


class Rows:
    """The data rows of a mesh, run by one worker thread per distinct
    device (the rows of a device one after another, in row order), each
    row under its device (`torch.cuda.device`) and inference mode. Rows on
    different cards run side by side; rows that share a card (a grid of
    one device repeated) run on one thread, since their kernels queue on
    the card's one stream anyway, and threads that share a card contend
    for the interpreter (ab_mesh.py on an H100: a thread a row was 2.7–
    5.3× slower on a 4 × 1 grid of one card, with or without a CUDA
    stream a row). No collectives: the rows never exchange data."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.devices = row_devices(mesh)
        self._pools = {}
        for dev in self.devices:
            if dev not in self._pools:
                self._pools[dev] = ThreadPoolExecutor(1, f"mesh-{dev}")

    def __len__(self) -> int:
        return len(self.devices)

    def close(self) -> None:
        for pool in self._pools.values():
            pool.shutdown(wait=True)

    def _run(self, rows: List[int], fn: Callable, parts: Sequence[tuple]):
        """Run `rows` in order → [(row, result, error)]; a failing row does
        not stop the next."""
        out = []
        for i in rows:
            dev = self.devices[i]
            ctx = torch.cuda.device(dev) if dev.type == "cuda" \
                else contextlib.nullcontext()
            _ROW.index = i
            try:
                with ctx, torch.inference_mode():
                    out.append((i, fn(i, *parts[i]), None))
            except Exception as e:
                out.append((i, None, e))
            finally:
                _ROW.index = None
        return out

    def map(self, fn: Callable, parts: Sequence[tuple]) -> list:
        """fn(row, *parts[row]) for every row on its device's thread → the
        results in row order. Waits for every row; a failure on any row is
        raised here (the first row's, in row order), never served
        around."""
        by_dev: Dict[torch.device, List[int]] = {}
        for i, dev in enumerate(self.devices):
            by_dev.setdefault(dev, []).append(i)
        futures = [self._pools[dev].submit(self._run, rows, fn, parts)
                   for dev, rows in by_dev.items()]
        wait(futures)
        done = sorted((r for f in futures for r in f.result()),
                      key=lambda r: r[0])
        for _, _, error in done:
            if error is not None:
                raise error
        return [result for _, result, _ in done]

    def split(self, fn: Callable, arrays: Sequence, pads: Sequence = (),
              device=None):
        """Pad the batch (the arrays' shared leading dim B) to a multiple of
        the rows, split it evenly, run fn(row, *its parts) on each row and
        gather the outputs (a tensor or a tuple of tensors with the part's
        leading dim) in batch order on `device` (default: row 0's), the
        padding sliced off. `pads[k]`, where given and not None, is the row
        that pads arrays[k] (broadcast); zeros otherwise. Parts are the
        arrays' slices as given (numpy or tensors): fn moves them."""
        b = len(arrays[0])
        n = len(self)
        pad = (-b) % n
        if pad:
            arrays = [_pad(a, pad, pads[k] if k < len(pads) else None)
                      for k, a in enumerate(arrays)]
        size = (b + pad) // n
        outs = self.map(fn, [tuple(a[i * size:(i + 1) * size]
                                   for a in arrays) for i in range(n)])
        out = _gather(outs, device or self.devices[0])
        return _tree_rows(out, 0, b) if pad else out


def _pad(a, n: int, row=None):
    """a with n rows appended: `row` broadcast, or zeros."""
    shape = (n,) + tuple(a.shape[1:])
    if isinstance(a, torch.Tensor):
        fill = a.new_zeros(shape) if row is None else \
            torch.as_tensor(row, dtype=a.dtype, device=a.device).expand(
                shape)
        return torch.cat([a, fill])
    a = np.asarray(a)
    fill = np.zeros(shape, a.dtype) if row is None else \
        np.broadcast_to(np.asarray(row, a.dtype), shape)
    return np.concatenate([a, fill])


class ShardedRec:
    """An SVTR placed as JAX's `shard_rec_params` places its tree: every
    leaf but the CTC head replicated, the head's vocab axis split over
    `model` (w (D, V) as (None, 'model'), b (V,) as ('model',)), each head
    shard replicated down the data axis.

    The replicated body is held once per data row, on the row's first
    device, where it runs: the copies along a row's model axis would repeat
    the same computation (JAX's GSPMD runs it on each device of the row),
    so the port runs it once and sends the features along the row. Row 0's
    body and head shards are the master leaves the optimizer updates
    (`parameters`); `sync` copies them to the other rows."""

    def __init__(self, model, mesh: Mesh):
        self.mesh = mesh
        self.body_sharding = replicated(mesh)
        body = copy.deepcopy(model)
        del body.head
        self.body = replicate(body, mesh)
        head = model.head
        self.head_w = NamedSharding(mesh, (None, "model")).place(
            head.w.detach())
        self.head_b = NamedSharding(mesh, ("model",)).place(head.b.detach())
        for t in self._head_shards():
            t.requires_grad_(head.w.requires_grad)

    def _head_shards(self):
        return list(self.head_w.shards.flat) + list(self.head_b.shards.flat)

    def parameters(self):
        """The master leaves: row 0's body, then the head shards of row 0."""
        return [p for p in self.body[0].parameters() if p.requires_grad] + \
            list(self.head_w.shards[0]) + list(self.head_b.shards[0])

    def _rows(self):
        """Per data row, its trainable leaves in `parameters`' order."""
        return [[p for p in b.parameters() if p.requires_grad] +
                list(self.head_w.shards[i]) + list(self.head_b.shards[i])
                for i, b in enumerate(self.body)]

    def reduce_grads(self) -> None:
        """Sum every row's gradients into the master leaves (the data-axis
        psum) and clear the other rows'."""
        rows = self._rows()
        for i in range(1, len(rows)):
            for p0, p in zip(rows[0], rows[i]):
                if p.grad is not None:
                    g = p.grad.to(p0.device)
                    p0.grad = g if p0.grad is None else p0.grad + g
                    p.grad = None

    @torch.no_grad()
    def sync(self) -> None:
        """Copy the master leaves to the other rows."""
        rows = self._rows()
        for i in range(1, len(rows)):
            for p0, p in zip(rows[0], rows[i]):
                p.copy_(p0)

    def tree(self):
        """The whole parameter tree in the JAX layout (numpy), from the
        master leaves."""
        tree = convert.tree_from_model(self.body[0])
        tree["head"] = {"w": self.head_w.gather("cpu").detach().numpy(),
                        "b": self.head_b.gather("cpu").detach().numpy()}
        return tree


def shard_rec_params(model, mesh: Mesh) -> ShardedRec:
    """Place a recognizer (an SVTR) on the mesh: see ShardedRec."""
    return ShardedRec(model, mesh)


def shard_batch(batch, mesh: Mesh):
    """Shard the leading (batch) axis of every array of a dict over
    `data`."""
    return {k: data_sharding(mesh, np.ndim(a)).place(torch.as_tensor(a))
            for k, a in batch.items()}

"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) and loaded
with ctypes. Libraries are built at first use into `build/kernels/` at the
repository root, named by a hash of their source and of the `csrc/*.cuh`
headers so an edited kernel never loads a stale build. `build_all()` starts
one nvcc per source at once.

A wrapper counts its launches in `LAUNCHES[name]` through `count_launch`,
adding one each time it launches its kernel and nowhere else; threads that
launch side by side lose no count. A wrapper whose function is a product
adds its FLOPs (2 a multiply-add) through `count_flops` to every count
opened by `counting_flops`, whichever route computes it.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("ctc_head", "seg_reduce2", "seg_reduce")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()
_FLOP_COUNTS: List[list] = []

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the GPU")


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, target) or
    None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    rc = proc.wait()
    log = out.with_suffix(".log").read_text()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {rc}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Build every named kernel library that is not built yet, one nvcc per
    source, all started together. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    with _LOCK:
        jobs = [(n, _start(n)) for n in names]
        errors: List[str] = []
        for n, job in jobs:
            if job is None:
                continue
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for a
    library built by this process or an earlier one."""
    path = _target(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed, with
    argtypes set from `signatures` (function name → ctypes types) and every
    restype int (the function's cudaGetLastError())."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def count_launch(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def counting_flops():
    """A count of the FLOPs the wrappers' products do while it is open:
    yields a one-element list, its total."""
    count = [0]
    with _COUNT_LOCK:
        _FLOP_COUNTS.append(count)
    try:
        yield count
    finally:
        with _COUNT_LOCK:
            _FLOP_COUNTS.remove(count)


def count_flops(n: int) -> None:
    with _COUNT_LOCK:
        for count in _FLOP_COUNTS:
            count[0] += n


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")

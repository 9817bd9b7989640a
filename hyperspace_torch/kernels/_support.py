"""Build and dispatch support for the hand-written CUDA kernels
(counterpart of ``hyperspace_tpu/kernels/_support.py``).

Dispatch rule: a kernel wrapper runs its plain PyTorch version for
tensors on the CPU, launches its CUDA kernel for tensors on a CUDA
device, and raises for anything else.  There is no switch that picks
the plain version on the card and no fallback when a build or launch
fails — the failure surfaces to the caller.

Build: each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with
``ctypes``, once per process, at the kernel's first use (never at
import).  Libraries land in ``build/hyperspace_torch/`` at the root of
the checkout, named by a hash of their source and of the ``csrc/``
headers it includes by a quoted name (``tf32.cuh``), so an edited
source or header rebuilds and concurrent builds never see a
half-written file.
Every exported C function launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "hyperspace_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU.  Asking for CUDA on a host without it raises — the
    port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu; got {dev}")
    return dev


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _sources(name: str) -> dict[str, bytes]:
    """The text of ``csrc/<name>.cu`` and of every header it includes
    by a quoted name, directly or through another header, by file name
    in the order first met."""
    texts: dict[str, bytes] = {}
    todo = [f"{name}.cu"]
    while todo:
        fname = todo.pop(0)
        if fname in texts:
            continue
        with open(os.path.join(CSRC, fname), "rb") as f:
            texts[fname] = f.read()
        todo += [m.decode() for m in _INCLUDE.findall(texts[fname])]
    return texts


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for fname, text in _sources(name).items():
        h.update(fname.encode() + b"\0" + text)
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu``; returns (process, tmp, out)
    or None when the library is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                           + log.decode(errors="replace"))
    os.replace(tmp, out)


def build_all(names) -> None:
    """Build every named source that is not built yet, one ``nvcc`` per
    source, all started together."""
    started = {n: _start_build(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish_build(n, s)


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_lib_path(name))
            _LIBS[name] = lib
        return lib


def function(lib_name: str, fn_name: str, argtypes: list):
    """A launcher from ``csrc/<lib_name>.cu`` with its C signature set:
    ``c_void_p`` for every pointer and the stream, returning the
    ``cudaError_t`` of the launch as an int."""
    fn = getattr(library(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, allowed: tuple, *tensors: torch.Tensor) -> None:
    """The launchers take contiguous tensors of the ``allowed`` dtypes on
    one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype not in allowed:
            want = ", ".join(str(d).replace("torch.", "") for d in allowed)
            raise ValueError(f"{name}: want {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous tensors")


def topk_disagreements(ids_a, d_a, ids_b, d_b, *, rtol: float,
                       atol: float) -> int:
    """Rows on which two top-k answers disagree beyond float noise.

    Distances must agree within ``atol + rtol·|d|``.  The row is cut
    into runs of near-ties (neighbouring distances within that
    tolerance); each run's id set must be equal in both answers, except
    the last run, which the k-th slot may cut through differently.
    Unreachable slots (+inf) must carry id -1 in both.  Inputs are
    [B, k] numpy arrays."""
    import numpy as np

    bad = 0
    for ia, da, ib, db in zip(ids_a, d_a, ids_b, d_b):
        tol = atol + rtol * np.abs(np.where(np.isfinite(da), da, 0.0))
        fa, fb = np.isfinite(da), np.isfinite(db)
        ok = (np.array_equal(fa, fb)
              and np.all(np.abs(da[fa] - db[fa]) <= tol[fa])
              and np.all(ia[~fa] == -1) and np.all(ib[~fb] == -1))
        k, s = int(fa.sum()), 0
        while ok and s < k:
            e = s + 1
            while e < k and abs(da[e] - da[e - 1]) <= tol[e]:
                e += 1
            if e < len(da) and set(ia[s:e]) != set(ib[s:e]):
                ok = False
            s = e
        bad += not ok
    return bad

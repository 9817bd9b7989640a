"""ctypes bindings for the native C++ host prep (counterpart of
``hyperspace_tpu/data/native.py``'s ``prepare_edges`` and
``locality_order``).

``_native/graphprep.cc`` and ``_native/localorder.cc`` are compiled with
``g++ -O2 -std=c++17 -shared -fPIC`` on first use (never at import) into
``build/hyperspace_torch/`` at the root of the checkout, named by a hash
of the two sources, so an edited source rebuilds and concurrent builds
never load a half-written file.  Plain C ABI + ctypes.

:func:`load` raises ``ImportError`` when no C++ compiler is found or the
build fails; the callers in :mod:`hyperspace_torch.data.graphs` then run
their numpy versions, which are the parity oracles of these functions
(bitwise the same arrays).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from hyperspace_torch.kernels._support import BUILD_DIR

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native")
SOURCES = ("graphprep.cc", "localorder.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lib = None
_LOCK = threading.Lock()


def lib_path() -> str:
    """Where the library of the current sources lives."""
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"hsdata-{h.hexdigest()[:16]}.so")


def _build() -> str:
    out = lib_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise ImportError("no C++ compiler for the native host prep")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, *(os.path.join(_DIR, s) for s in SOURCES),
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError as e:  # callers fall back on
        raise ImportError(                      # ImportError (module doc)
            f"native host prep build failed: {e.stderr.decode()[:500]}"
        ) from e
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built and bound once per process."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        P32, P64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(
            ctypes.c_int64)
        lib.graph_prepare.restype = ctypes.c_void_p
        lib.graph_prepare.argtypes = [
            P32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64, P64]
        lib.graph_prepare_copy.restype = None
        lib.graph_prepare_copy.argtypes = [
            ctypes.c_void_p, P32, P32, ctypes.POINTER(ctypes.c_uint8), P32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
        lib.graph_prepare_free.restype = None
        lib.graph_prepare_free.argtypes = [ctypes.c_void_p]
        lib.locality_order.restype = None
        lib.locality_order.argtypes = [P32, ctypes.c_int64, ctypes.c_int32,
                                       P64]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
    except (ImportError, OSError):
        return False
    return True


def _as_i32_pairs(a) -> np.ndarray:
    a = np.asarray(a)
    if len(a) == 0:
        return np.zeros((0, 2), np.int32)
    a = np.ascontiguousarray(a, np.int32)
    if a.ndim != 2 or a.shape[1] != 2:
        raise ValueError(f"expected [N, 2] pairs, got {a.shape}")
    return a


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def prepare_edges(edges, num_nodes: int, *, symmetrize: bool = True,
                  self_loops: bool = True, pad_multiple: int = 1024):
    """Symmetrize → self-loops → dedupe → receiver-major sort → pad →
    reverse involution → in-degree, in C++.  Returns (senders, receivers,
    mask, rev_perm, deg), bitwise ``graphs._prepare_edges_numpy``'s;
    ``rev_perm`` is meaningful only when ``symmetrize`` (callers drop it
    otherwise).  Ids must lie in [0, num_nodes): the C++ side does no
    bounds check."""
    lib = load()
    e = _as_i32_pairs(edges)
    e_pad = ctypes.c_int64()
    handle = lib.graph_prepare(
        _ptr(e, ctypes.c_int32), e.shape[0], int(num_nodes),
        int(symmetrize), int(self_loops), int(pad_multiple),
        ctypes.byref(e_pad))
    try:
        n = e_pad.value
        senders = np.empty(n, np.int32)
        receivers = np.empty(n, np.int32)
        mask = np.empty(n, np.uint8)
        rev_perm = np.empty(n, np.int32)
        deg = np.empty(num_nodes, np.float32)
        lib.graph_prepare_copy(
            handle, _ptr(senders, ctypes.c_int32),
            _ptr(receivers, ctypes.c_int32), _ptr(mask, ctypes.c_uint8),
            _ptr(rev_perm, ctypes.c_int32), _ptr(deg, ctypes.c_float),
            int(num_nodes))
    finally:
        lib.graph_prepare_free(handle)
    return senders, receivers, mask.astype(bool), rev_perm, deg


def locality_order(edges, num_nodes: int) -> np.ndarray:
    """BFS locality relabeling, ``order[rank] = old id`` ([N] int64),
    bitwise ``graphs._locality_order_python``'s."""
    lib = load()
    e = _as_i32_pairs(edges)
    # the C++ walk does no bounds check (an out-of-range id would write
    # out of bounds): fail here as the Python walk would
    if len(e) and (e.min() < 0 or e.max() >= num_nodes):
        raise IndexError(
            f"edge ids out of range [0, {num_nodes}): min {e.min()}, "
            f"max {e.max()}")
    out = np.empty(num_nodes, np.int64)
    lib.locality_order(_ptr(e, ctypes.c_int32), e.shape[0], int(num_nodes),
                       _ptr(out, ctypes.c_int64))
    return out

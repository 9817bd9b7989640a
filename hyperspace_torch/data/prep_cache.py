"""Persistent on-disk cache of graph preprocessing (counterpart of
``hyperspace_tpu/data/prep_cache.py``).

The host prep of a big graph (the edge layout with its CSR plan and
cluster split, the locality order, the link-prediction split) is a pure
function of (input arrays, knobs, code), so repeat runs can load it
instead of rebuilding it.

Keying: sha256 over the input arrays' raw bytes (dtype and shape
included), every knob, and a code fingerprint: the bytes of the port's
modules that compute the artifacts (``data/graphs.py``, ``data/native.py``,
the two ``data/_native`` sources, ``kernels/cluster.py``,
``kernels/segment.py`` and this file), so editing any producer misses
every entry instead of serving a stale layout.

Storage: one pickle an entry under ``<repo>/.cache/graphprep_torch``
(ignored by git; the JAX package keeps its own under
``.cache/graphprep``), written atomically (tmp + rename) so an
interrupted run never leaves a half-written entry.  A corrupt or
unreadable entry counts as a miss and is rebuilt in place.

Knobs:

- ``HYPERSPACE_CACHE_DIR``     — cache root override.
- ``HYPERSPACE_GRAPH_CACHE=0`` — turns off the ``"auto"`` default
  (explicit ``cache=True`` or a :class:`PrepCache` still cache).

Call sites default to ``cache="auto"``: caching engages only from
200,000 raw edges (``graphs.CACHE_AUTO_MIN_EDGES``), so test-sized graphs
never touch the disk.  :class:`PrepCache` counts its hits and misses.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Callable, Optional

import numpy as np

# bump to miss every entry on a format change
CACHE_FORMAT = 1

# producers whose source is part of the key (relative to the package)
_CODE_FILES = (
    os.path.join("data", "graphs.py"),
    os.path.join("data", "prep_cache.py"),
    os.path.join("data", "native.py"),
    os.path.join("data", "_native", "graphprep.cc"),
    os.path.join("data", "_native", "localorder.cc"),
    os.path.join("kernels", "cluster.py"),
    os.path.join("kernels", "segment.py"),
)

_ENV_DIR = "HYPERSPACE_CACHE_DIR"
_ENV_SWITCH = "HYPERSPACE_GRAPH_CACHE"
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_code_fp: Optional[str] = None


def default_root() -> str:
    root = os.environ.get(_ENV_DIR)
    if root:
        return os.path.abspath(root)
    return os.path.join(os.path.dirname(_PKG), ".cache", "graphprep_torch")


def auto_enabled() -> bool:
    """Whether ``cache="auto"`` call sites may cache at all."""
    return os.environ.get(_ENV_SWITCH, "1").lower() not in (
        "0", "false", "no", "off")


def code_fingerprint() -> str:
    """sha256 of the producer modules' bytes (once a process)."""
    global _code_fp
    if _code_fp is None:
        h = hashlib.sha256()
        for rel in _CODE_FILES:
            h.update(rel.encode())
            try:
                with open(os.path.join(_PKG, rel), "rb") as f:
                    h.update(f.read())
            except OSError:
                h.update(b"<missing>")
        _code_fp = h.hexdigest()
    return _code_fp


def _update(h, part) -> None:
    """Feed one key part into the hash, tagged by type so that the int 1
    and the string "1" never collide."""
    if isinstance(part, np.ndarray):
        a = np.ascontiguousarray(part)
        h.update(f"nd:{a.dtype.str}:{a.shape}:".encode())
        h.update(a.tobytes())
    elif isinstance(part, (tuple, list)):
        h.update(f"seq{len(part)}:".encode())
        for p in part:
            _update(h, p)
    elif isinstance(part, bytes):
        h.update(b"b:" + part)
    else:
        h.update(f"{type(part).__name__}:{part!r};".encode())


def key_hash(kind: str, key_parts) -> str:
    h = hashlib.sha256()
    _update(h, (CACHE_FORMAT, code_fingerprint(), kind, tuple(key_parts)))
    return h.hexdigest()


class PrepCache:
    """Content-addressed pickle store with hit and miss counts."""

    def __init__(self, root: Optional[str] = None):
        self.root = os.path.abspath(root or default_root())
        self.hits = 0
        self.misses = 0

    def _path(self, kind: str, key_parts) -> str:
        return os.path.join(self.root, f"{kind}-{key_hash(kind, key_parts)}"
                                       ".pkl")

    def get_or_build(self, kind: str, key_parts, builder: Callable[[], Any]):
        """Load the entry of (kind, key_parts), or build and store it.
        The builder's value must pickle (numpy arrays and plain
        containers of them).  A storage failure degrades to building
        without caching."""
        path = self._path(kind, key_parts)
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    payload = pickle.load(f)
                self.hits += 1
                return payload
            except Exception:  # noqa: BLE001 — a corrupt entry is a miss
                try:
                    os.remove(path)
                except OSError:
                    pass
        payload = builder()
        self.misses += 1
        try:
            os.makedirs(self.root, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        except OSError:
            pass  # a read-only checkout: serve the built value
        return payload


_default: Optional[PrepCache] = None


def default_cache() -> PrepCache:
    global _default
    if _default is None:
        _default = PrepCache()
    return _default


def resolve(cache, *, auto_ok: bool) -> Optional[PrepCache]:
    """A call site's ``cache`` argument: ``None``/``False`` → off;
    ``True`` → the default cache; a :class:`PrepCache` → itself;
    ``"auto"`` → the default cache iff the call site's workload is big
    enough (``auto_ok``) and ``HYPERSPACE_GRAPH_CACHE`` allows it."""
    if cache is None or cache is False:
        return None
    if isinstance(cache, PrepCache):
        return cache
    if cache is True:
        return default_cache()
    if cache == "auto":
        return default_cache() if (auto_ok and auto_enabled()) else None
    raise ValueError(f"unknown cache argument {cache!r}")

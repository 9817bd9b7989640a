"""Request micro-batcher: bucket padding + per-query LRU result cache
(counterpart of ``hyperspace_tpu/serve/batcher.py``, request path only).

- **Bucketing.**  Query batches are padded (by repeating the last id —
  always a valid row) up to the smallest power-of-two bucket from
  ``min_bucket`` to ``max_bucket``; bigger requests are split into
  ``max_bucket`` slabs, so the engine sees a handful of batch shapes.
  Padded slots are real-but-discarded work, counted in ``padded_waste``
  beside ``slots``, the total dispatched.
- **Result cache.**  An LRU keyed by (artifact fingerprint, query id, k,
  exclude_self, precision, scan signature) holding per-query top-k
  rows; a request mixing hot and cold ids computes only the cold ones.
  The scan signature names the exact scan, or the IVF probe with its
  width and index fingerprint, plus the fused marker and the PQ lane
  with its codebooks' fingerprint, so exact, probed (per width) and PQ
  rows never answer for one another.  Edge scoring is uncached.

Counters live on the batcher (``stats()``).  Deadlines, admission
control, the degradation ladder, access logs and spans are not ported
yet.
"""

from __future__ import annotations

import collections
import operator
import threading
from typing import Sequence

import numpy as np

from hyperspace_torch.serve.engine import QueryEngine

DEFAULT_MIN_BUCKET = 8
DEFAULT_MAX_BUCKET = 1024
DEFAULT_CACHE_SIZE = 65536


def bucket_sizes(min_bucket: int = DEFAULT_MIN_BUCKET,
                 max_bucket: int = DEFAULT_MAX_BUCKET) -> tuple:
    """The power-of-two bucket ladder, smallest to largest."""
    if min_bucket < 1 or max_bucket < min_bucket:
        raise ValueError(f"bad bucket range [{min_bucket}, {max_bucket}]")
    out, b = [], 1
    while b < min_bucket:
        b *= 2
    while b < max_bucket:
        out.append(b)
        b *= 2
    out.append(max_bucket)
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (larger requests are split into top-bucket
    slabs first)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _checked_ids(ids, name: str, num_nodes: int) -> list[int]:
    """Validate a request's id list on the host before any dtype cast:
    every id integral (a float like 1.9 fails, never truncates) and in
    [0, num_nodes) (a huge int never wraps through the int32 cast)."""
    if isinstance(ids, np.ndarray):
        ids = ids.reshape(-1).tolist()
    elif np.isscalar(ids):
        raise ValueError(f"{name} must be a list of ids")
    if not len(ids):
        raise ValueError(f"{name} must be a non-empty id list")
    out = []
    for i in ids:
        if isinstance(i, bool):  # bools index-coerce to 0/1 — reject
            raise ValueError(f"{name} must be integer ids; got bool")
        try:
            i = operator.index(i)
        except TypeError:
            raise ValueError(
                f"{name} must be integer ids; got "
                f"{type(i).__name__}") from None
        if not 0 <= i < num_nodes:
            raise ValueError(f"{name} id {i} out of range [0, {num_nodes})")
        out.append(i)
    return out


class _LRU:
    """Tiny lock-guarded LRU: cache key -> (idx row, dist row)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            try:
                self._d.move_to_end(key)
                return self._d[key]
            except KeyError:
                return None

    def put(self, key, value) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


class RequestBatcher:
    """Pads requests onto the bucket ladder and fronts the LRU cache."""

    def __init__(self, engine: QueryEngine, *,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 max_bucket: int = DEFAULT_MAX_BUCKET,
                 cache_size: int = DEFAULT_CACHE_SIZE):
        self.engine = engine
        self.buckets = bucket_sizes(min_bucket, max_bucket)
        self.cache = _LRU(cache_size)
        self._counts = dict.fromkeys(
            ("requests", "cache_hit", "cache_miss", "slots", "padded_waste"),
            0)
        self._lock = threading.Lock()

    def _count(self, **incs) -> None:
        with self._lock:
            for name, v in incs.items():
                self._counts[name] += v

    # --- top-k ----------------------------------------------------------------

    def validate_topk_request(self, ids, k) -> tuple[list[int], int]:
        """Host-side validation of the id list and k (reject, don't
        coerce)."""
        ids = _checked_ids(ids, "ids", self.engine.num_nodes)
        if isinstance(k, bool):  # True would index-coerce to k=1
            raise ValueError("k must be an integer; got bool")
        try:
            k = operator.index(k)
        except TypeError:
            raise ValueError(
                f"k must be an integer; got {type(k).__name__}") from None
        return ids, k

    def plan_topk(self, k: int, exclude_self: bool):
        """The cache key function for this (k, exclude_self): the same
        (fingerprint, id, k) has distinct answers per flag, precision and
        scan signature, so all of them ride in the key."""
        eng = self.engine
        fp, prec, scan = eng.fingerprint, eng.precision, eng.scan_signature
        return lambda qid: (fp, qid, k, exclude_self, prec, scan)

    def _dispatch_topk(self, misses: Sequence[int], k: int, *,
                       exclude_self: bool, keyf) -> dict:
        rows: dict[int, tuple] = {}
        top = self.buckets[-1]
        for s in range(0, len(misses), top):
            slab = list(misses[s:s + top])
            b = bucket_for(len(slab), self.buckets)
            self._count(slots=b, padded_waste=b - len(slab))
            padded = slab + [slab[-1]] * (b - len(slab))
            idx, dist = self.engine.topk_neighbors(
                np.asarray(padded, np.int32), k, exclude_self=exclude_self)
            idx, dist = idx.cpu().numpy(), dist.cpu().numpy()
            for j, qid in enumerate(slab):
                val = (idx[j].copy(), dist[j].copy())
                rows[qid] = val
                self.cache.put(keyf(qid), val)
        return rows

    def topk(self, ids, k: int, *,
             exclude_self: bool = True) -> tuple[np.ndarray, np.ndarray]:
        """``(neighbors [B, k] int32, dists [B, k])`` in request order;
        cache-aware, bucket-padded."""
        self._count(requests=1)
        ids, k = self.validate_topk_request(ids, k)
        keyf = self.plan_topk(k, exclude_self)
        rows: dict[int, tuple] = {}
        misses: list[int] = []
        for qid in dict.fromkeys(ids):  # unique ids: one compute each
            hit = self.cache.get(keyf(qid))
            if hit is not None:
                rows[qid] = hit
            else:
                misses.append(qid)
        self._count(cache_hit=len(rows), cache_miss=len(misses))
        rows.update(self._dispatch_topk(misses, k, exclude_self=exclude_self,
                                        keyf=keyf))
        return (np.stack([rows[q][0] for q in ids]),
                np.stack([rows[q][1] for q in ids]))

    # --- edge scores ----------------------------------------------------------

    def score(self, u_ids, v_ids, *, prob: bool = False,
              fd_r: float = 2.0, fd_t: float = 1.0) -> np.ndarray:
        """Bucket-padded ``engine.score_edges`` ([B] in request order)."""
        self._count(requests=1)
        n = self.engine.num_nodes
        u = np.asarray(_checked_ids(u_ids, "u", n), np.int64)
        v = np.asarray(_checked_ids(v_ids, "v", n), np.int64)
        if u.shape != v.shape:
            raise ValueError(f"score: need matching id lists; got "
                             f"{u.shape} vs {v.shape}")
        out = np.empty((u.size,), np.float64)
        top = self.buckets[-1]
        for s in range(0, u.size, top):
            su, sv = u[s:s + top], v[s:s + top]
            b = bucket_for(su.size, self.buckets)
            self._count(slots=b, padded_waste=b - su.size)
            pu = np.concatenate([su, np.full(b - su.size, su[-1])])
            pv = np.concatenate([sv, np.full(b - sv.size, sv[-1])])
            d = self.engine.score_edges(pu.astype(np.int32),
                                        pv.astype(np.int32), prob=prob,
                                        fd_r=fd_r, fd_t=fd_t)
            out[s:s + su.size] = d.cpu().numpy()[:su.size]
        return out

    # --- introspection --------------------------------------------------------

    def stats(self) -> dict:
        """Request, cache and slot counters plus the engine's identity
        (the ``stats`` op of the CLI loop)."""
        with self._lock:
            c = dict(self._counts)
        lookups = c["cache_hit"] + c["cache_miss"]
        return {
            **c,
            "cache_hit_rate": (round(c["cache_hit"] / lookups, 4)
                               if lookups else 0.0),
            "padded_waste_ratio": (round(c["padded_waste"] / c["slots"], 4)
                                   if c["slots"] else 0.0),
            "cache_entries": len(self.cache),
            "buckets": list(self.buckets),
            "fingerprint": self.engine.fingerprint,
            "precision": self.engine.precision,
            "scan_strategy": self.engine.scan_strategy,
            "scan_mode": self.engine.scan_mode,
            "nprobe": self.engine.nprobe,
        }

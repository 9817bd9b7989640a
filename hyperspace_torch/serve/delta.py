"""Live mutable index: a delta segment over a frozen engine (counterpart
of ``hyperspace_tpu/serve/delta.py``).

A small, exactly scanned **delta segment** in front of a frozen
:class:`~hyperspace_torch.serve.engine.QueryEngine` absorbs insert,
update and delete; a **compaction** folds the accumulated mutations into
a rebuilt base and swaps it in.

- **Ids are row indices, forever.**  Inserts land at the contiguous tail
  of the host master (``HostEmbedTable.append_rows``); a deleted id's row
  is never reclaimed, it is tombstoned.
- **Tombstones ride as a penalty row.**  ``drop`` ([padded rows] f32:
  0 live, +inf deleted or superseded by a delta write) is added to every
  scan tile of the base before its top-k
  (``engine.topk_neighbors(drop=...)``), so a dead base row never wins.
  No kernel has a tombstone lane, so a masked base scan is the two-stage
  path (``pdist`` chunks on the card) and a ``fused`` base is refused.
- **Queries score fresh vectors.**  The query rows are gathered from the
  host master (``q_rows=``), so a query by an updated id ranks its
  post-upsert vector.
- **The generation makes staleness structural.**  Every mutation bumps
  ``generation``, which :attr:`LiveQueryEngine.scan_signature` folds into
  the batcher's cache key.

Device mirrors: every generation gets fresh device tensors of the delta
rows, ids, slot penalty and drop row (built on first use after a
mutation), never an in-place copy into tensors a query already holds, so
a scan launched from another thread reads the generation it snapshotted.
A compaction's new base is swapped in only after the card has finished
the work that built it (a stream sync).

The merge: the base's top-k (``allow_underfill``) and the ``[B, cap]``
delta distances (one ``pdist`` tile plus the slot penalty and the
self-mask) are concatenated, base columns first, and ranked by one stable
sort on the device — an exact tie keeps the earlier column (the base's
order, then the lower slot).  JAX merges on the host by ``argpartition``
and a stable sort of the kept k, which may keep another id at an exact
tie at the k-th place.  Under-filled answers raise JAX's ``ValueError``s;
a tombstone is never served as filler.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from hyperspace_torch.parallel.host_table import HostEmbedTable
from hyperspace_torch.serve.engine import (QueryEngine, _fermi_dirac,
                                           _stable_topk, _tile_dist)
from hyperspace_torch.telemetry import registry as telem

DEFAULT_DELTA_CAP = 1024
DEFAULT_COMPACT_AT = 0.75


def _delta_scan(q: torch.Tensor, rows: torch.Tensor, penalty: torch.Tensor,
                q_idx: torch.Tensor, ids: torch.Tensor, *, spec: tuple,
                exclude_self: bool) -> torch.Tensor:
    """Exact distances of ``q`` [B, D] to the delta segment ``rows``
    [cap, D] → [B, cap]; ``penalty`` (+inf on free slots) and the
    optional self-mask applied."""
    d = _tile_dist(spec, q, rows) + penalty[None, :]
    if exclude_self:
        d = d.masked_fill(ids[None, :] == q_idx[:, None], float("inf"))
    return d


class LiveQueryEngine:
    """A mutable engine: frozen :class:`QueryEngine` base + host master +
    fixed-capacity delta segment.  Duck-types the ``QueryEngine`` query
    surface, so ``RequestBatcher`` serves it unchanged.

    ``base`` must not be a fused-scan engine: the fused kernels have no
    tombstone lane, and an engine advertising ``"fused"`` in its
    signature while dispatching the two-stage path would lie to the
    cache key."""

    def __init__(self, base: QueryEngine, master: HostEmbedTable, *,
                 capacity: int = DEFAULT_DELTA_CAP,
                 compact_at: float = DEFAULT_COMPACT_AT,
                 auto_compact: bool = True):
        if base.scan_mode == "fused":
            raise ValueError(
                "LiveQueryEngine needs a two_stage/carry base: the fused "
                "kernel has no tombstone lane, and a silent fallback "
                "would desync the engine's scan_signature from the "
                "program that answers")
        if int(master.num_rows) != base.num_nodes:
            raise ValueError(
                f"master has {master.num_rows} rows; base engine was "
                f"built over {base.num_nodes} — they must start aligned")
        if int(master.width) != base.dim:
            raise ValueError(
                f"master width {master.width} != engine dim {base.dim}")
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        if not 0.0 < float(compact_at) <= 1.0:
            raise ValueError(
                f"compact_at must be in (0, 1]; got {compact_at}")
        self.base = base
        self.master = master
        self.capacity = capacity
        self.compact_at = float(compact_at)
        self.auto_compact = bool(auto_compact)
        # the rebuilt base serves the same configuration
        self._ncells = int(base.index.ncells) if base.index is not None \
            else 0
        # host state; pen: 0 = live entry, +inf = free slot (a free slot
        # never wins a top-k, so the scan needs no occupancy mask)
        dim = base.dim
        self._rows = np.zeros((capacity, dim), np.float32)
        self._ids = np.full((capacity,), -1, np.int32)
        self._pen = np.full((capacity,), np.inf, np.float32)
        self._seq = np.zeros((capacity,), np.int64)  # write stamps
        self._slot_of: dict[int, int] = {}
        self._free = list(range(capacity - 1, -1, -1))
        self._deleted: set[int] = set()
        self._drop = np.zeros((base.table.shape[0],), np.float32)
        self._gen = 0
        self._next_seq = 1
        self._lock = threading.RLock()
        self._compact_lock = threading.Lock()
        self._dev = None  # (rows, ids, pen, drop) of this generation
        self._compactor: Optional[threading.Thread] = None

    # --- QueryEngine duck-type surface ---------------------------------------

    @property
    def fingerprint(self) -> str:
        return self.base.fingerprint

    @property
    def precision(self) -> str:
        return self.base.precision

    @property
    def scan_mode(self) -> str:
        return self.base.scan_mode

    @property
    def scan_strategy(self) -> str:
        return self.base.scan_strategy

    @property
    def nprobe(self) -> int:
        return self.base.nprobe

    @property
    def index(self):
        return self.base.index

    @property
    def spec(self) -> tuple:
        return self.base.spec

    @property
    def dim(self) -> int:
        return self.base.dim

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def num_nodes(self) -> int:
        """Total id space [0, N), tombstoned rows included (a deleted id
        stays addressable and rejected)."""
        return int(self.master.num_rows)

    @property
    def num_live(self) -> int:
        return int(self.master.num_rows) - len(self._deleted)

    @property
    def generation(self) -> int:
        return self._gen

    @property
    def segment_rows(self) -> int:
        return len(self._slot_of)

    @property
    def scan_signature(self) -> tuple:
        """The base signature + the generation: a pre-mutation cache row
        can never answer a post-mutation request."""
        return self.base.scan_signature + ("gen", self._gen)

    def scan_signature_for(self, nprobe: int) -> tuple:
        return self.base.scan_signature_for(nprobe) + ("gen", self._gen)

    # --- queries --------------------------------------------------------------

    def _snapshot(self, arr: np.ndarray):
        """This generation's device mirrors, base and the queries' fresh
        master rows, taken together under the lock."""
        with self._lock:
            if self._dev is None:
                dev = self.base.device
                self._dev = tuple(torch.tensor(a, device=dev) for a in (
                    self._rows, self._ids, self._pen, self._drop))
            return self._dev, self.base, self.master.gather(arr)

    def _check_live_ids(self, ids, name: str) -> np.ndarray:
        arr = np.asarray(ids)
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError(f"{name} must be a non-empty 1-D id array")
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"{name} must be integer ids; got {arr.dtype}")
        if arr.size and (arr.min() < 0 or arr.max() >= self.num_nodes):
            raise ValueError(
                f"{name} out of range [0, {self.num_nodes}): "
                f"min={arr.min()}, max={arr.max()}")
        dead = [int(i) for i in arr if int(i) in self._deleted]
        if dead:
            raise ValueError(
                f"{name} refers to deleted id(s) {sorted(set(dead))[:8]} "
                "— tombstoned rows cannot be queried")
        return arr.astype(np.int64)

    def topk_neighbors(self, q_idx, k: int, *, exclude_self: bool = True,
                       nprobe: Optional[int] = None):
        """``(neighbors [B, k] int32, dists [B, k] f32)`` tensors over the
        live view: the base scan under the tombstone mask merged with the
        delta segment's exact scan, both scoring the queries' fresh
        master rows; ascending, ties by column (module docstring).
        Raises the under-filled ``ValueError`` when fewer than ``k`` live
        rows are reachable."""
        arr = self._check_live_ids(q_idx, "q_idx")
        k = int(k)
        limit = self.num_nodes - (1 if exclude_self else 0)
        if not 1 <= k <= limit:
            raise ValueError(
                f"k={k} out of range [1, {limit}] for a {self.num_nodes}-"
                f"row table (exclude_self={exclude_self})")
        (d_rows, d_ids, d_pen, d_drop), base, q_np = self._snapshot(arr)
        base_k = min(k, base.num_nodes - (1 if exclude_self else 0))
        if base.scan_strategy == "ivf":
            base_k = min(base_k, base.nprobe * base.index.max_cell)
        base_k = max(base_k, 1)
        q_rows = torch.as_tensor(q_np, device=base.device)
        q_idx32 = torch.as_tensor(arr.astype(np.int32), device=base.device)
        bi, bd = base.topk_neighbors(
            arr.astype(np.int32), base_k, exclude_self=exclude_self,
            nprobe=nprobe, q_rows=q_rows, drop=d_drop,
            allow_underfill=True)
        dd = _delta_scan(q_rows, d_rows, d_pen, q_idx32, d_ids,
                         spec=base.spec, exclude_self=exclude_self)
        # tombstoned base rows and free slots carry +inf, and a
        # delta-resident id's base copy is tombstoned: no id appears
        # twice at a finite distance
        cand_d = torch.cat([bd.to(dd.dtype), dd], dim=1)
        cand_i = torch.cat([bi.to(torch.int32),
                            d_ids[None, :].expand(arr.size, -1)], dim=1)
        if k > cand_d.shape[1]:
            raise ValueError(
                f"live top-k under-filled: k={k} exceeds the "
                f"{cand_d.shape[1]} reachable candidate slots "
                f"({self.num_live} live of {self.num_nodes} rows) — "
                "lower k, raise nprobe=, or compact")
        out_d, out_i = _stable_topk(cand_d, cand_i, k)
        if bool(torch.isinf(out_d).any()):
            raise ValueError(
                f"live top-k under-filled: k={k} exceeds the reachable "
                f"live rows ({self.num_live} live of {self.num_nodes}; "
                "tombstones are excluded, never served) — lower k or "
                "compact after fewer deletes")
        return out_i, out_d

    def score_edges(self, u_idx, v_idx, *, prob: bool = False,
                    fd_r: float = 2.0, fd_t: float = 1.0) -> torch.Tensor:
        """Per-pair distances over fresh master rows."""
        u = self._check_live_ids(u_idx, "u_idx")
        v = self._check_live_ids(v_idx, "v_idx")
        if u.shape != v.shape:
            raise ValueError(
                f"u_idx {u.shape} and v_idx {v.shape} must match")
        base = self.base
        xu = torch.as_tensor(self.master.gather(u), device=base.device)
        xv = torch.as_tensor(self.master.gather(v), device=base.device)
        d = base.manifold.dist(xu, xv)
        return _fermi_dirac(d, fd_r, fd_t) if prob else d

    # --- mutations ------------------------------------------------------------

    def _validate_upsert(self, ids, rows):
        arr = np.asarray(ids)
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError("ids must be a non-empty 1-D id array")
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"ids must be integer ids; got {arr.dtype}")
        rows = np.asarray(rows, np.float32)
        if rows.shape != (arr.size, self.dim):
            raise ValueError(
                f"rows {rows.shape} must be ({arr.size}, {self.dim})")
        if arr.size and arr.min() < 0:
            raise ValueError(f"ids must be >= 0; got min={arr.min()}")
        return arr.astype(np.int64), rows

    def upsert(self, ids, rows) -> dict:
        """Insert or update rows; returns ``{"upserted", "inserted",
        "generation", "segment_rows"}``.  Inserts extend the id space
        contiguously from ``num_nodes``; duplicate ids in one batch
        resolve last-write-wins.  Write order: master, delta slot, the
        superseded base row's tombstone, then the generation."""
        arr, rows = self._validate_upsert(ids, rows)
        with self._lock:
            n0 = self.num_nodes
            new = np.unique(arr[arr >= n0])
            want = np.arange(n0, n0 + new.size, dtype=np.int64)
            if new.size and not np.array_equal(np.sort(new), want):
                raise ValueError(
                    f"insert ids must be contiguous from {n0} (ids are "
                    f"row indices); got new ids {sorted(new.tolist())[:8]}")
            last = {}
            for j, i in enumerate(arr.tolist()):
                last[i] = j
            uniq = np.fromiter(last.keys(), np.int64, len(last))
            take = np.fromiter(last.values(), np.int64, len(last))
            urows = rows[take]
            need = sum(1 for i in uniq.tolist()
                       if int(i) not in self._slot_of)
            if need > len(self._free):
                # segment full: fold it into the base, then retry
                self._compact_locked()
                if need > len(self._free):
                    raise ValueError(
                        f"upsert batch needs {need} delta slots; "
                        f"capacity is {self.capacity} — raise "
                        "delta_cap or split the batch")
            ins = uniq >= n0
            if ins.any():
                order = np.argsort(uniq[ins])
                got = self.master.append_rows(urows[ins][order])
                if not np.array_equal(got, np.sort(uniq[ins])):
                    raise RuntimeError(
                        f"master appended ids {got[:8]}, want "
                        f"{np.sort(uniq[ins])[:8]}")
            if (~ins).any():
                self.master.write_back(uniq[~ins], urows[~ins])
            inserted = int(ins.sum())
            seq = self._next_seq
            self._next_seq += 1
            for i, r in zip(uniq.tolist(), urows):
                i = int(i)
                slot = self._slot_of.get(i)
                if slot is None:
                    slot = self._free.pop()
                    self._slot_of[i] = slot
                self._rows[slot] = r
                self._ids[slot] = i
                self._pen[slot] = 0.0
                self._seq[slot] = seq
                self._deleted.discard(i)
                if i < self.base.num_nodes:
                    self._drop[i] = np.inf   # the base row is stale
            self._gen += 1
            self._dev = None
            telem.inc("serve/upserts", len(uniq))
            telem.set_gauge("serve/segment_rows", self.segment_rows)
            out = {"upserted": int(len(uniq)), "inserted": inserted,
                   "generation": self._gen,
                   "segment_rows": self.segment_rows}
        self._maybe_compact_async()
        return out

    def delete(self, ids) -> dict:
        """Tombstone rows; returns ``{"deleted", "generation"}``.  The id
        stays allocated but can no longer be queried or returned; an
        upsert revives it."""
        arr = self._check_live_ids(ids, "ids")
        uniq = np.unique(arr)
        with self._lock:
            for i in uniq.tolist():
                i = int(i)
                self._deleted.add(i)
                slot = self._slot_of.pop(i, None)
                if slot is not None:
                    self._ids[slot] = -1
                    self._pen[slot] = np.inf
                    self._seq[slot] = 0
                    self._free.append(slot)
                if i < self.base.num_nodes:
                    self._drop[i] = np.inf
            self._gen += 1
            self._dev = None
            telem.inc("serve/tombstones", len(uniq))
            telem.set_gauge("serve/segment_rows", self.segment_rows)
            return {"deleted": int(len(uniq)), "generation": self._gen}

    # --- compaction -----------------------------------------------------------

    def _maybe_compact_async(self):
        if not self.auto_compact:
            return
        if self.segment_rows < self.compact_at * self.capacity:
            return
        if not self._compact_lock.acquire(blocking=False):
            return  # one compaction at a time; the running one covers us
        t = threading.Thread(
            target=self._compact_bg, name="delta-compact", daemon=True)
        self._compactor = t
        t.start()

    def _compact_bg(self):
        try:
            self._compact_inner()
        finally:
            self._compact_lock.release()

    def join_compaction(self, timeout: Optional[float] = None) -> bool:
        """Wait for a background compaction; True when none is running."""
        t = self._compactor
        if t is not None:
            t.join(timeout)
            return not t.is_alive()
        return True

    def compact(self) -> dict:
        """Synchronous compaction: fold the delta into a rebuilt frozen
        base and swap it in.  Returns ``{"generation", "fingerprint",
        "segment_rows"}``."""
        with self._compact_lock:
            return self._compact_inner()

    def _compact_locked(self):
        """Compact while holding ``self._lock`` (the full-segment upsert
        path); the RLock keeps snapshot and swap atomic with the batch."""
        if self._compact_lock.acquire(blocking=False):
            try:
                self._compact_inner()
            finally:
                self._compact_lock.release()

    def _compact_inner(self) -> dict:
        base = self.base
        with self._lock:
            # a consistent point-in-time copy: entries written after it
            # (seq > mark) stay in the delta
            mark = self._next_seq - 1
            arr = self.master.to_array()
        index = None
        if self._ncells:
            # the streamed k-means rebuild (a HostEmbedTable source)
            from hyperspace_torch.serve.index import build_index
            snap = HostEmbedTable.from_array(arr)
            index = build_index(snap, base.spec, self._ncells,
                                device=base.device)
        new_base = QueryEngine(
            arr, base.spec, chunk_rows=base.chunk_rows,
            scan_mode=base.scan_mode, precision=base.precision,
            index=index, nprobe=base.nprobe if index is not None else 0,
            device=base.device)
        if new_base.device.type == "cuda":
            # the new base's tables are on the card before it serves
            torch.cuda.current_stream(new_base.device).synchronize()
        with self._lock:
            self.base = new_base
            # purge every slot the snapshot covered; post-mark writers
            # stay (their new base copies are stale: tombstoned)
            for i, slot in list(self._slot_of.items()):
                if self._seq[slot] <= mark:
                    del self._slot_of[i]
                    self._ids[slot] = -1
                    self._pen[slot] = np.inf
                    self._seq[slot] = 0
                    self._free.append(slot)
            drop = np.zeros((new_base.table.shape[0],), np.float32)
            for i in self._deleted:
                if i < new_base.num_nodes:
                    drop[i] = np.inf
            for i in self._slot_of:
                if i < new_base.num_nodes:
                    drop[i] = np.inf
            self._drop = drop
            self._gen += 1
            self._dev = None
            telem.inc("serve/compactions", 1)
            telem.set_gauge("serve/segment_rows", self.segment_rows)
            return {"generation": self._gen,
                    "fingerprint": new_base.fingerprint,
                    "segment_rows": self.segment_rows}

"""Host-resident embedding tables (counterpart of the one-process half
of ``hyperspace_tpu/parallel/host_table.py``).

:class:`HostEmbedTable` holds an ``[N, W]`` master table in host memory
as a list of contiguous row-range shards, never one monolithic array:
cross-shard ``gather``/``write_back`` by id, ``append_rows`` for the
live index's inserts (new ids land at the contiguous tail, so every id
already handed out stays valid), ``iter_chunks`` for streaming readers
(the host-streamed IVF build), whose blocks never cross a shard, and a
sharded checkpoint (``save_sharded``/``load_sharded``) that moves one
bounded block at a time: restoring into another shard count re-slices
shard by shard, and the largest array either side touches is counted by
the ``host_table/io_rows_peak`` gauge (:func:`io_rows_peak`).

The checkpoint is JAX's ``npy`` codec: one ``shard_{i:05d}.npy`` a row
range (fsync, then an atomic rename) and the ``host_table.json``
manifest written last, ``"codec": "npy"``, with JAX's keys and bounds,
so each package reads the other's ``npy`` checkpoints.  JAX's
``save_sharded`` writes Orbax items instead; the port has no Orbax and
refuses such a manifest with a ``ValueError`` naming the codec.
:func:`save_owned_rows`/:func:`load_rows` are the per-process row files
and range reads, for one process here (``process_index`` and
``process_count`` are explicit, ``barrier`` optional).

:class:`DeviceHotCache` is the training side: a fixed-capacity ``[C, W]``
tensor on one device holding the rows a chunk of steps touches, with a
host id→slot map and chunk-granular LRU eviction.  ``ensure(ids)``
uploads only the missing rows and writes them into the cache in place
(``index_copy_``), so the tensor a CUDA graph holds stays the cache;
``fetch(slots)`` reads rows back (through a pinned buffer on the card)
for the chunk-boundary write-back.  int8 and int4 caches keep packed
rows (``serve/quant.py``) and refuse training updates.  The trainer is
``train/host_embed.py``.  Nothing else in the port moves master rows to
the device.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from hyperspace_torch.telemetry import registry as _telem

MANIFEST = "host_table.json"
FORMAT_VERSION = 1

# the largest single array the checkpoint paths have moved in this
# process (also the host_table/io_rows_peak gauge): "never the whole
# table on one host" is testable as reset_io_peak(); <round trip>;
# io_rows_peak() <= max(saved shard, destination shard) rows
_io_rows_peak = 0


def io_rows_peak() -> int:
    return _io_rows_peak


def reset_io_peak() -> None:
    global _io_rows_peak
    _io_rows_peak = 0
    _telem.set_gauge("host_table/io_rows_peak", 0)


def _track_io_rows(rows: int) -> None:
    global _io_rows_peak
    if rows > _io_rows_peak:
        _io_rows_peak = rows
        _telem.set_gauge("host_table/io_rows_peak", rows)


def _shard_bounds(num_rows: int, shards: int) -> np.ndarray:
    """Row-range starts (len shards+1): near-equal contiguous ranges."""
    base, extra = divmod(num_rows, shards)
    sizes = [base + (1 if i < extra else 0) for i in range(shards)]
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


class HostEmbedTable:
    """Host-resident ``[N, W]`` master table as contiguous row shards."""

    def __init__(self, shards: Sequence[np.ndarray]):
        if not shards:
            raise ValueError("HostEmbedTable needs at least one shard")
        widths = {int(s.shape[1]) for s in shards}
        if len(widths) != 1:
            raise ValueError(f"shard widths differ: {sorted(widths)}")
        # writable, contiguous host copies: the master takes write_back
        self._shards = [
            s if isinstance(s, np.ndarray) and s.flags.writeable
            and s.flags.c_contiguous else np.array(s)
            for s in shards]
        self._starts = np.concatenate(
            [[0], np.cumsum([s.shape[0] for s in self._shards])]
        ).astype(np.int64)
        self.num_rows = int(self._starts[-1])
        self.width = widths.pop()
        self.dtype = self._shards[0].dtype
        # a gather racing a write_back sees each row whole, old or new
        self._lock = threading.Lock()

    # --- construction ---------------------------------------------------------

    @classmethod
    def from_array(cls, arr: np.ndarray, shards: int = 1) -> "HostEmbedTable":
        """Split an in-memory ``[N, W]`` array into ``shards`` row
        ranges (views, no copy: the table takes ownership)."""
        arr = np.asarray(arr)
        if arr.ndim != 2:
            raise ValueError(f"want [N, W]; got {arr.shape}")
        b = _shard_bounds(arr.shape[0], int(shards))
        return cls([arr[b[i]:b[i + 1]] for i in range(len(b) - 1)])

    @classmethod
    def build(cls, num_rows: int, width: int,
              fill: Callable[[int, int], np.ndarray], *,
              shard_rows: int = 1 << 20,
              dtype=np.float32) -> "HostEmbedTable":
        """Generate a table shard by shard: ``fill(start, rows)`` returns
        the ``[rows, width]`` block of that row range, so no caller holds
        the whole table at once."""
        b = _shard_bounds(int(num_rows), max(1, -(-num_rows // shard_rows)))
        shards = []
        for i in range(len(b) - 1):
            rows = int(b[i + 1] - b[i])
            blk = np.asarray(fill(int(b[i]), rows), dtype)
            if blk.shape != (rows, width):
                raise ValueError(
                    f"fill({b[i]}, {rows}) returned {blk.shape}; "
                    f"want ({rows}, {width})")
            shards.append(blk)
        return cls(shards)

    # --- host-side access -----------------------------------------------------

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self._shards)

    def _locate(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        si = np.searchsorted(self._starts, ids, side="right") - 1
        return si, ids - self._starts[si]

    def gather(self, ids) -> np.ndarray:
        """``table[ids]`` across shards → a new ``[len(ids), W]`` array."""
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_rows):
            raise ValueError(
                f"ids out of range [0, {self.num_rows}): "
                f"min={ids.min()}, max={ids.max()}")
        out = np.empty((len(ids), self.width), self.dtype)
        si, local = self._locate(ids)
        with self._lock:
            for s in np.unique(si):
                m = si == s
                out[m] = self._shards[s][local[m]]
        _telem.inc("host_table/gather_rows", int(len(ids)))
        return out

    def write_back(self, ids, rows: np.ndarray) -> None:
        """Scatter ``rows`` into the master at ``ids``."""
        ids = np.asarray(ids, np.int64)
        rows = np.asarray(rows)
        if rows.shape != (len(ids), self.width):
            raise ValueError(
                f"rows {rows.shape} must be ({len(ids)}, {self.width})")
        si, local = self._locate(ids)
        with self._lock:
            for s in np.unique(si):
                m = si == s
                self._shards[s][local[m]] = rows[m]
        _telem.inc("host_table/writeback_rows", int(len(ids)))

    def append_rows(self, rows: np.ndarray) -> np.ndarray:
        """Grow the table by ``rows`` ([M, W]) as a new trailing shard;
        returns the assigned ids ``[num_rows, num_rows + M)`` (int64).
        Ids are row indices everywhere downstream, so new rows land at
        the contiguous tail and existing ids stay valid."""
        rows = np.asarray(rows, self.dtype)
        if rows.ndim != 2 or rows.shape[1] != self.width:
            raise ValueError(
                f"rows {rows.shape} must be [M, {self.width}]")
        if rows.shape[0] == 0:
            return np.empty((0,), np.int64)
        with self._lock:
            lo = self.num_rows
            self._shards.append(np.array(rows))
            self._starts = np.append(
                self._starts, lo + rows.shape[0]).astype(np.int64)
            self.num_rows = lo + rows.shape[0]
        _telem.inc("host_table/writeback_rows", int(rows.shape[0]))
        return np.arange(lo, lo + rows.shape[0], dtype=np.int64)

    def iter_chunks(self, chunk: int) -> Iterator[tuple[int, np.ndarray]]:
        """Yield ``(row_start, block)`` host views covering the table in
        order, each at most ``chunk`` rows and never crossing a shard
        boundary (no copies)."""
        for s, arr in enumerate(self._shards):
            start = int(self._starts[s])
            for lo in range(0, arr.shape[0], chunk):
                yield start + lo, arr[lo:lo + chunk]

    def to_array(self) -> np.ndarray:
        """The full table as one host array (tests, compaction's
        snapshot, small tables)."""
        return np.concatenate(self._shards, axis=0)

    def _slice_rows(self, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) as one array: a view when the range sits in one
        shard, a bounded copy when it straddles shards."""
        si = int(np.searchsorted(self._starts, lo, side="right") - 1)
        if hi <= self._starts[si + 1]:
            s0 = int(self._starts[si])
            return self._shards[si][lo - s0:hi - s0]
        return self.gather(np.arange(lo, hi, dtype=np.int64))

    # --- sharded save / restore ----------------------------------------------

    def save_sharded(self, directory: str,
                     shards: Optional[int] = None) -> None:
        """Write the table as ``shards`` row-range ``.npy`` files plus the
        JSON manifest, the manifest last (the commit point).  Re-slicing
        to another shard count than the in-memory layout moves one
        bounded block a saved shard: the largest array touched is
        max(in-memory shard, saved shard) rows
        (``host_table/io_rows_peak``)."""
        shards = int(shards or self.num_shards)
        if shards < 1:
            raise ValueError(f"shards must be >= 1; got {shards}")
        os.makedirs(directory, exist_ok=True)
        bounds = _shard_bounds(self.num_rows, shards)
        for i in range(shards):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            _write_shard(directory, i, self._slice_rows(lo, hi))
        _write_manifest(directory, self, bounds)

    @classmethod
    def load_sharded(cls, directory: str,
                     shards: Optional[int] = None) -> "HostEmbedTable":
        """Restore into ``shards`` row ranges (default: as saved).  Every
        saved shard is read once, in order, and copied into the
        overlapping destination shards, so no array is larger than
        max(saved shard, destination shard) rows whatever the two shard
        counts are."""
        meta = _read_manifest(directory)
        n, w = int(meta["num_rows"]), int(meta["width"])
        dtype = np.dtype(meta["dtype"])
        saved = np.asarray(meta["bounds"], np.int64)
        new = _shard_bounds(n, int(shards or meta["shards"]))
        dest = [np.empty((int(new[i + 1] - new[i]), w), dtype)
                for i in range(len(new) - 1)]
        for i in range(len(saved) - 1):
            lo, hi = int(saved[i]), int(saved[i + 1])
            blk = _read_shard(directory, i)
            _track_io_rows(blk.shape[0])
            # copy this saved range into every overlapping new shard
            for j in range(len(dest)):
                a, b = max(lo, int(new[j])), min(hi, int(new[j + 1]))
                if a < b:
                    dest[j][a - int(new[j]):b - int(new[j])] = \
                        blk[a - lo:b - lo]
            del blk
        return cls(dest)


def _shard_path(directory: str, i: int) -> str:
    return os.path.join(directory, f"shard_{i:05d}.npy")


def _write_shard(directory: str, i: int, blk: np.ndarray,
                 tag: int = 0) -> None:
    """One shard file, durable before it becomes visible (fsync, then an
    atomic rename)."""
    _track_io_rows(blk.shape[0])
    path = _shard_path(directory, i)
    tmp = f"{path}.tmp.{tag}"
    with open(tmp, "wb") as f:
        np.save(f, np.ascontiguousarray(blk))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write_manifest(directory: str, table: HostEmbedTable,
                    bounds: np.ndarray) -> None:
    with open(os.path.join(directory, MANIFEST), "w",
              encoding="utf-8") as f:
        json.dump({
            "version": FORMAT_VERSION, "codec": "npy",
            "num_rows": table.num_rows, "width": table.width,
            "dtype": str(np.dtype(table.dtype)), "shards": len(bounds) - 1,
            "bounds": [int(b) for b in bounds],
        }, f)


def _read_manifest(directory: str) -> dict:
    """The manifest of a saved table; refuses another version and any
    codec but ``npy`` (JAX's ``save_sharded`` writes Orbax items, which
    this package does not read)."""
    with open(os.path.join(directory, MANIFEST), encoding="utf-8") as f:
        meta = json.load(f)
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported host-table format {meta.get('version')!r}")
    codec = meta.get("codec", "orbax")
    if codec == "orbax":
        raise ValueError(
            "host-table codec 'orbax' (the JAX package's save_sharded "
            "items) is not readable here: re-save the table with the "
            "'npy' codec (save_owned_rows, or this package's "
            "save_sharded)")
    if codec != "npy":
        raise ValueError(f"unknown host-table codec {codec!r}")
    return meta


def _read_shard(directory: str, i: int) -> np.ndarray:
    """One saved shard's rows (``npy`` codec)."""
    return np.load(_shard_path(directory, i))


def save_owned_rows(table: HostEmbedTable, directory: str, *,
                    process_index: int = 0, process_count: int = 1,
                    barrier: Optional[Callable[[], None]] = None) -> None:
    """Checkpoint of a host table by process: process ``process_index``
    of ``process_count`` writes only its owned row range (one shard file
    a process), everyone meets at ``barrier()``, and process 0 alone
    writes the manifest, the commit point: a reader racing a crash
    mid-save finds shard files but no manifest and sees no checkpoint.
    The layout is :meth:`HostEmbedTable.save_sharded`'s, so
    :meth:`HostEmbedTable.load_sharded` restores it at any shard
    count.  One process here; the multi-process plane is not ported."""
    pi, pc = int(process_index), int(process_count)
    if not 0 <= pi < pc:
        raise ValueError(f"process {pi} out of range [0, {pc})")
    os.makedirs(directory, exist_ok=True)
    bounds = _shard_bounds(table.num_rows, pc)
    lo, hi = int(bounds[pi]), int(bounds[pi + 1])
    _write_shard(directory, pi, table._slice_rows(lo, hi), tag=pi)
    if barrier is not None:
        barrier()  # every process's shard is durable before the commit
    if pi == 0:
        _write_manifest(directory, table, bounds)
    if barrier is not None:
        barrier()  # no process returns before the checkpoint is committed


def load_rows(directory: str, lo: int, hi: int) -> np.ndarray:
    """Rows ``[lo, hi)`` of a saved table, reading only the overlapping
    rows of the overlapping shards (memory-mapped): a process re-reads
    just its range, whatever process count wrote the checkpoint."""
    meta = _read_manifest(directory)
    n, w = int(meta["num_rows"]), int(meta["width"])
    if not 0 <= lo <= hi <= n:
        raise ValueError(f"rows [{lo}, {hi}) out of range [0, {n}]")
    saved = np.asarray(meta["bounds"], np.int64)
    out = np.empty((hi - lo, w), np.dtype(meta["dtype"]))
    for i in range(len(saved) - 1):
        slo, shi = int(saved[i]), int(saved[i + 1])
        a, b = max(lo, slo), min(hi, shi)
        if a >= b:
            continue
        blk = np.load(_shard_path(directory, i), mmap_mode="r")
        _track_io_rows(b - a)
        out[a - lo:b - lo] = blk[a - slo:b - slo]
        del blk
    return out


class DeviceHotCache:
    """Fixed-capacity device cache of hot master-table rows.

    ``capacity`` bounds the device footprint (``C × W`` elements); the
    id→slot map, LRU order and free slots live on the host.  Rows are
    uploaded on a miss (:meth:`ensure`), read back for the write-back
    (:meth:`fetch`), and updated in place by the training chunk through
    :attr:`array`.

    Eviction is chunk-granular: ``ensure(ids)`` evicts the least recently
    used ids not in ``ids`` when it needs slots.  The trainer writes every
    touched row back to the master at each chunk boundary, so an evicted
    row never holds the only copy of an update, and a hit means the
    device copy is the master's current value.

    Uploads are exactly the miss rows, written into the cache tensor in
    place (``index_copy_``): the tensor is never rebound, so a CUDA graph
    that holds it as a buffer keeps reading the cache.  (JAX pads each
    upload to a power-of-two bucket, for XLA's one-executable-per-shape;
    nothing here needs that.)

    ``quant`` ("int8" | "int4") keeps the device copy packed
    (``serve/quant.py``: int8 codes with an f32 scale a row, or two int4
    nibbles a byte with an f16 scale), quantised on the host before the
    upload and dequantised by :meth:`fetch`: a read lane, which refuses
    the training update through :attr:`array`.
    """

    def __init__(self, master: HostEmbedTable, capacity: int, *,
                 quant: Optional[str] = None, device="cuda"):
        from hyperspace_torch.kernels._support import resolve_device

        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        if quant not in (None, "int8", "int4"):
            raise ValueError(
                f"cache quant must be None, 'int8' or 'int4'; got {quant!r}")
        self._master = master
        self.quant = quant
        self.device = resolve_device(device)
        self.capacity = int(min(capacity, master.num_rows))
        dev, c, w = self.device, self.capacity, master.width
        if quant == "int8":
            self._arr = torch.zeros((c, w), dtype=torch.int8, device=dev)
            self._scale = torch.zeros((c, 1), dtype=torch.float32,
                                      device=dev)
        elif quant == "int4":
            from hyperspace_torch.serve.quant import int4_packed_width

            self._arr = torch.zeros((c, int4_packed_width(w)),
                                    dtype=torch.uint8, device=dev)
            self._scale = torch.zeros((c, 1), dtype=torch.float16,
                                      device=dev)
        else:
            self._arr = torch.zeros(
                (c, w), dtype=torch.from_numpy(
                    np.empty(0, master.dtype)).dtype, device=dev)
            self._scale = None
        self._host = {}        # pinned read-back buffers, made at need
        # vectorised bookkeeping: id → slot (-1 absent), slot → id (-1
        # free), and a chunk tick a slot for chunk-granular LRU
        self._slot_of = np.full(master.num_rows, -1, np.int32)
        self._slot_id = np.full(self.capacity, -1, np.int64)
        self._last_used = np.zeros(self.capacity, np.int64)
        self._tick = 0
        _telem.set_gauge("host_table/cache_capacity", self.capacity)

    @property
    def array(self) -> torch.Tensor:
        """The device cache: ``[C, W]`` rows (int8 codes ``[C, W]`` or
        packed nibbles ``[C, ⌈W/2⌉]`` under ``quant``)."""
        return self._arr

    @array.setter
    def array(self, new: torch.Tensor) -> None:
        if self.quant is not None:
            raise ValueError(
                f"a {self.quant} hot-row cache is a serve-side read lane; "
                "in-place training updates need a full-precision cache")
        if tuple(new.shape) != (self.capacity, self._master.width):
            raise ValueError(
                f"cache array {tuple(new.shape)} must be "
                f"({self.capacity}, {self._master.width})")
        self._arr = new

    @property
    def scale(self) -> Optional[torch.Tensor]:
        """Per-slot dequantisation scales ``[C, 1]`` (packed caches)."""
        return self._scale

    @property
    def nbytes(self) -> int:
        """Device bytes the cache holds."""
        n = self._arr.nbytes
        if self._scale is not None:
            n += self._scale.nbytes
        return n

    def ensure(self, ids: np.ndarray) -> np.ndarray:
        """Make every id resident; return its slot ([len(ids)] int32).

        ``ids`` must be unique (the chunk's unique-id union).  The misses
        are gathered from the master and uploaded at once; hits cost a
        vectorised lookup.  Raises when ``ids`` alone exceed the
        capacity: a chunk's working set must fit.
        """
        ids = self._check_ids(ids)
        miss = self._slot_of[ids] < 0
        rows = self._master.gather(ids[miss]) if miss.any() else None
        return self._ensure_rows(ids, rows)

    def ensure_with_rows(self, ids: np.ndarray, miss_rows,
                         miss_mask: np.ndarray) -> np.ndarray:
        """:meth:`ensure` with the miss rows gathered beforehand (the
        trainer's ``gather_ahead`` mode): ``miss_rows`` align with
        ``miss_mask``, the positions of ``ids`` that were misses at
        gather time.  Ids that became resident since are not overwritten
        (their cached value is at least as fresh), so those rows are
        dropped."""
        ids = self._check_ids(ids)
        still_miss = self._slot_of[ids] < 0
        keep = still_miss[miss_mask]
        rows = np.asarray(miss_rows)[keep] if miss_rows is not None else None
        return self._ensure_rows(ids, rows)

    def _check_ids(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        if len(ids) > self.capacity:
            raise ValueError(
                f"chunk working set ({len(ids)} unique rows) exceeds the "
                f"hot-row cache capacity {self.capacity} — raise hot_rows= "
                "or lower chunk_steps/batch_size")
        if len(np.unique(ids)) != len(ids):
            raise ValueError("ensure() ids must be unique (pass the "
                             "chunk's unique-id union)")
        return ids

    def _ensure_rows(self, ids: np.ndarray,
                     miss_rows: Optional[np.ndarray]) -> np.ndarray:
        self._tick += 1
        slots = self._slot_of[ids].copy()
        miss = slots < 0
        self._last_used[slots[~miss]] = self._tick  # refresh hit recency
        nmiss = int(miss.sum())
        _telem.inc("host_table/cache_hits", len(ids) - nmiss)
        _telem.inc("host_table/cache_misses", nmiss)
        reg = _telem.default_registry()
        lookups = (reg.get("host_table/cache_hits")
                   + reg.get("host_table/cache_misses"))
        if lookups:
            _telem.set_gauge(
                "host_table/cache_hit_rate",
                round(reg.get("host_table/cache_hits") / lookups, 4))
        if not nmiss:
            return slots
        if miss_rows is None or len(miss_rows) != nmiss:
            raise ValueError(
                f"need {nmiss} miss rows; got "
                f"{0 if miss_rows is None else len(miss_rows)}")
        free = np.flatnonzero(self._slot_id < 0)
        if len(free) < nmiss:
            # evict the least recently used slots outside this request
            # (this chunk's hits were just stamped with the new tick)
            need = nmiss - len(free)
            occ = np.flatnonzero((self._slot_id >= 0)
                                 & (self._last_used < self._tick))
            order = np.argsort(self._last_used[occ], kind="stable")[:need]
            evict = occ[order]
            self._slot_of[self._slot_id[evict]] = -1
            self._slot_id[evict] = -1
            _telem.inc("host_table/cache_evictions", need)
            free = np.concatenate([free, evict])
        mslots = free[:nmiss].astype(np.int32)
        miss_ids = ids[miss]
        self._slot_of[miss_ids] = mslots
        self._slot_id[mslots] = miss_ids
        self._last_used[mslots] = self._tick
        slots[miss] = mslots
        # packed lanes quantise on the host: the link carries the packed
        # bytes, never the f32 rows
        scale_rows = None
        if self.quant == "int8":
            from hyperspace_torch.serve.quant import quantize_rows

            miss_rows, scale_rows = quantize_rows(
                np.asarray(miss_rows, np.float32))
        elif self.quant == "int4":
            from hyperspace_torch.serve.quant import pack_int4_rows

            miss_rows, scale_rows = pack_int4_rows(
                np.asarray(miss_rows, np.float32))
        miss_rows = np.ascontiguousarray(miss_rows)
        idx = torch.from_numpy(mslots.astype(np.int64)).to(self.device)
        self._arr.index_copy_(0, idx, torch.from_numpy(miss_rows).to(
            self.device, self._arr.dtype))
        sent = int(miss_rows.nbytes)
        if scale_rows is not None:
            self._scale.index_copy_(0, idx, torch.from_numpy(
                np.ascontiguousarray(scale_rows)).to(self.device))
            sent += int(scale_rows.nbytes)
        _telem.inc("host_table/upload_rows", nmiss)
        _telem.inc("host_table/upload_bytes", sent)
        return slots

    def _read_back(self, t: torch.Tensor) -> np.ndarray:
        """``t`` (gathered cache rows) as a host array; on the card
        through a pinned buffer of the cache's own size."""
        if t.device.type != "cuda":
            return t.numpy().copy()
        key = (t.dtype, tuple(t.shape[1:]))
        if key not in self._host:
            self._host[key] = torch.empty((self.capacity,) + key[1],
                                          dtype=t.dtype, pin_memory=True)
        buf = self._host[key][:t.shape[0]]
        buf.copy_(t)
        return buf.numpy().copy()

    def fetch(self, slots: np.ndarray) -> np.ndarray:
        """Cache rows back on the host (the chunk-boundary write-back
        read): one device gather and one copy.  Packed caches dequantise
        on the host: the f32 view of the resident codes (lossy against
        the master, never a write-back source)."""
        idx = torch.from_numpy(np.asarray(slots, np.int64)).to(self.device)
        out = self._read_back(self._arr.index_select(0, idx))
        if self.quant is not None:
            sc = self._read_back(self._scale.index_select(0, idx))
            if self.quant == "int8":
                from hyperspace_torch.serve.quant import dequantize_rows

                out = dequantize_rows(out, sc)
            else:
                from hyperspace_torch.serve.quant import dequantize_int4_rows

                out = dequantize_int4_rows(out, sc, self._master.width)
            out = out.astype(self._master.dtype)
        return out

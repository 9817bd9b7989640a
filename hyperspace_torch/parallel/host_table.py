"""A host-resident embedding table (counterpart of the one-process half
of ``hyperspace_tpu/parallel/host_table.py``).

:class:`HostEmbedTable` holds an ``[N, W]`` master table in host memory
as a list of contiguous row-range shards, never one monolithic array:
cross-shard ``gather``/``write_back`` by id, ``append_rows`` for the
live index's inserts (new ids land at the contiguous tail, so every id
already handed out stays valid), and ``iter_chunks`` for streaming
readers (the host-streamed IVF build), whose blocks never cross a shard.

numpy only: nothing here touches the card.  The sharded checkpoint
(``save_sharded``/``load_sharded``), the multi-process row files and
the device hot-row cache of the JAX module are not ported here.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterator, Sequence

import numpy as np

from hyperspace_torch.telemetry import registry as _telem


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

"""IVF index for sub-linear hyperbolic retrieval (counterpart of
``hyperspace_tpu/serve/index.py``, resident build).

The inverted-file index of Jégou et al. 2011 with geodesic geometry:

- **Coarse quantizer: hyperbolic k-means.**  ``ncells`` centroids over
  the table, seeded k-means++-style (D² sampling under the manifold's
  own distance) and refined by a fixed number of Lloyd iterations.  The
  centroid update is a normalized sum in each family's lift: a lorentz
  cell's centroid is the Lorentz centroid of Law et al. 2019, a
  poincare cell's is that centroid of the rows lifted to the
  hyperboloid, projected back, a euclidean cell's the mean, a sphere
  cell's the mean projected onto the sphere, and a product cell's each
  factor's rule on its slice.  Empty cells keep their previous centroid.
- **Cell layout: dense.**  Per-cell row ids packed into a
  ``[ncells, max_cell]`` int32 array padded with ``-1``; every table
  row lands in exactly one cell.
- **Balancing.**  After Lloyd, cells are capped at ``balance × N/ncells``
  rows: an oversized cell keeps its closest rows and spills the rest,
  each to its nearest centroid with room (rank-round bidding).

On a CUDA device the nearest-centroid assignment is the ``scan_topk``
kernel at k = 1 with the centroids as the slab, as the JAX index build
uses its kernel there (sphere and product specs, which the kernel does
not take, argmin the full distance, as JAX does); on the CPU it is the
JAX index build's reduced-key argmin, step for step, so the two
packages build the same index from the same table and seed.  The per-cell sums are summed in
row order (``index_add_``) on the CPU and by a one-hot product on the
card (no float atomics).

**The host-streamed build** (``host_resident=True``, or automatically
for tables of ``HOST_BUILD_ROWS`` rows and more and for a
:class:`~hyperspace_torch.parallel.host_table.HostEmbedTable` source):
the table stays on the host.  k-means++ seeds from a uniform subsample
(``seed_sample``, ``SEED_SAMPLE_DEFAULT`` rows by default), each Lloyd
pass and the final assignment copy one ``[_BUILD_CHUNK, D]`` block at a
time to the device (the ``index/build_device_rows_peak`` gauge), and
the spill pass copies only the spilled rows.  The per-block arithmetic
and its fold order are the resident build's, so from the same seeds the
two builds assign every row alike.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import torch

from hyperspace_torch.kernels import _support
from hyperspace_torch.manifolds import Lorentz, Sphere, smath
from hyperspace_torch.manifolds.maps import ball_to_lorentz, lorentz_to_ball
from hyperspace_torch.serve.artifact import manifold_from_spec

INDEX_VERSION = 1

# tables smaller than this answer faster by exact scan than by probing;
# engines fall back to the exact program below it, whatever nprobe says
IVF_MIN_TABLE_ROWS = 2048

# Lloyd assignment walks the table this many rows at a time
_BUILD_CHUNK = 4096

# at or above this many rows the build streams the table from the host
HOST_BUILD_ROWS = 1 << 20

# k-means++ candidate rows of a streamed build when seed_sample is 0
SEED_SAMPLE_DEFAULT = 1 << 17

_KINDS = ("poincare", "lorentz", "euclidean", "sphere", "product")


def auto_ncells(n: int) -> int:
    """Default cell count: ~√N, clamped to [2, 4096]."""
    return max(2, min(4096, int(round(float(n) ** 0.5))))


@dataclasses.dataclass(frozen=True)
class ServingIndex:
    """A built (or loaded) IVF index over one frozen table."""

    centroids: np.ndarray  # [ncells, D] f32, rows ON the manifold
    cells: np.ndarray      # [ncells, max_cell] int32, -1 padded
    counts: np.ndarray     # [ncells] int32 real rows per cell
    num_nodes: int         # table rows the index was built over
    iters: int             # Lloyd iterations used
    seed: int              # k-means++ seeding RNG seed
    fingerprint: str       # content hash (arrays + build params)

    @property
    def ncells(self) -> int:
        return int(self.cells.shape[0])

    @property
    def max_cell(self) -> int:
        return int(self.cells.shape[1])

    @property
    def dim(self) -> int:
        return int(self.centroids.shape[1])


def index_fingerprint_of(centroids: np.ndarray, cells: np.ndarray,
                         counts: np.ndarray, *, num_nodes: int,
                         iters: int, seed: int) -> str:
    """Content identity of an index: sha256 over the arrays and the
    build parameters (byte-identical to the JAX package's) — a cache-key
    ingredient, so engines probing different indexes never share rows."""
    centroids = np.ascontiguousarray(centroids)
    cells = np.ascontiguousarray(cells)
    counts = np.ascontiguousarray(counts)
    h = hashlib.sha256()
    h.update(json.dumps({
        "version": INDEX_VERSION,
        "num_nodes": int(num_nodes), "iters": int(iters), "seed": int(seed),
        "centroids": [list(centroids.shape), str(centroids.dtype)],
        "cells": [list(cells.shape), str(cells.dtype)],
        "counts": [list(counts.shape), str(counts.dtype)],
    }, sort_keys=True).encode())
    h.update(centroids.tobytes())
    h.update(cells.tobytes())
    h.update(counts.tobytes())
    return h.hexdigest()


# --- per-family lifts --------------------------------------------------------


def _check_kind(spec: tuple) -> str:
    if spec[0] not in _KINDS:
        raise ValueError(f"unknown manifold spec kind {spec[0]!r} (want "
                         f"one of {_KINDS})")
    return spec[0]


def _lift_dim(spec: tuple, dim: int) -> int:
    """Width of the lifted coordinates (poincare lifts to d+1; a product
    to the sum of its factors' lifts)."""
    kind = _check_kind(spec)
    if kind == "poincare":
        return dim + 1
    if kind == "product":
        return sum(_lift_dim((fk, c), d) for fk, d, c in spec[1])
    return dim


def _lift(spec: tuple, x: torch.Tensor) -> torch.Tensor:
    """Coordinates in which the family's centroid is a normalized sum."""
    kind = _check_kind(spec)
    if kind == "poincare":
        return ball_to_lorentz(x, spec[1])
    if kind == "product":
        parts, o = [], 0
        for fk, d, c in spec[1]:
            parts.append(_lift((fk, c), x[..., o:o + d]))
            o += d
        return torch.cat(parts, dim=-1)
    return x


def _unlift(spec: tuple, s: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """Per-cell lifted sums ``s`` [ncells, DL] + counts → centroids
    [ncells, D] (garbage on empty cells — the caller masks those)."""
    kind = _check_kind(spec)
    mean = s / torch.clamp_min(cnt, 1.0)[:, None]
    if kind == "lorentz":
        return Lorentz(float(spec[1])).centroid(s[:, None, :])
    if kind == "poincare":
        mu = Lorentz(float(spec[1])).centroid(s[:, None, :])
        return lorentz_to_ball(mu, spec[1])
    if kind == "sphere":
        return Sphere(float(spec[1])).proj(mean)
    if kind == "product":
        parts, o = [], 0
        for fk, d, c in spec[1]:
            dl = _lift_dim((fk, c), d)
            parts.append(_unlift((fk, c), s[:, o:o + dl], cnt))
            o += dl
        return torch.cat(parts, dim=-1)
    return mean


def _dist(spec: tuple, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The manifold's own distance, broadcast over rows."""
    _check_kind(spec)
    return manifold_from_spec(spec).dist(x, y)


# --- Lloyd -------------------------------------------------------------------


def _nearest_centroid(cent: torch.Tensor, rows: torch.Tensor, *,
                      spec: tuple) -> torch.Tensor:
    """Per-row nearest-centroid id [rows] int64.

    On a CUDA device: the ``scan_topk`` kernel at k = 1 with the
    centroids as the slab (no [rows, ncells] tile in memory).  On the
    CPU: the JAX index build's argmin of a monotone-reduced key —
    poincare ``d²(x,y) / (1 − c‖y‖²)``, lorentz ``−⟨x, y⟩_L``,
    euclidean ``‖x − y‖²`` — which picks the same centroid as the full distance
    except at floating-point near-ties; first index on ties.  Sphere and
    product specs argmin the full distance on either device, as JAX
    does."""
    kind = spec[0]
    if kind in ("sphere", "product"):
        return torch.argmin(_dist(spec, rows[:, None, :], cent[None, :, :]),
                            dim=1)
    if rows.device.type == "cuda":
        from hyperspace_torch.kernels import scan_topk as fused_kernel

        _, ids = fused_kernel.scan_topk(
            cent, rows, torch.zeros(rows.shape[0], dtype=torch.int32,
                                    device=rows.device), 0,
            spec=spec, k=1, n=cent.shape[0], exclude_self=False)
        return ids[:, 0].long()
    if kind == "lorentz":
        lane0 = torch.cat([-cent[:, :1], cent[:, 1:]], dim=1)
        key = -(rows @ lane0.T)
    else:
        gram = rows @ cent.T
        xx = smath.sq_norm(rows)                          # [rows, 1]
        yy = smath.sq_norm(cent)[:, 0][None, :]           # [1, ncells]
        key = smath.clamp_min(xx - 2.0 * gram + yy, 0.0)
        if kind == "poincare":
            c = torch.as_tensor(spec[1], dtype=rows.dtype)
            key = key / smath.clamp_min(1.0 - c * yy,
                                        smath.eps_for(rows.dtype))
    return torch.argmin(key, dim=1)


def _segment_sums(lifted: torch.Tensor, seg: torch.Tensor,
                  ncells: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cell sums of ``lifted`` rows and per-cell counts, f32.  Row
    order on the CPU (the JAX index build's segment sum); a one-hot
    product on the card, which needs no float atomics."""
    if lifted.device.type == "cuda":
        onehot = torch.nn.functional.one_hot(seg, ncells).to(lifted.dtype)
        return onehot.T @ lifted, onehot.sum(dim=0)
    sums = torch.zeros((ncells, lifted.shape[1]), dtype=lifted.dtype)
    sums.index_add_(0, seg, lifted)
    cnts = torch.zeros(ncells, dtype=lifted.dtype)
    cnts.index_add_(0, seg, torch.ones(seg.shape[0], dtype=lifted.dtype))
    return sums, cnts


# --- table sources: resident (a device tensor) or host-streamed --------------


def _src_rows(table) -> tuple[int, int]:
    """(rows, width) of an ndarray, a tensor or a ``HostEmbedTable``."""
    from hyperspace_torch.parallel.host_table import HostEmbedTable

    if isinstance(table, HostEmbedTable):
        return table.num_rows, table.width
    return int(table.shape[0]), int(table.shape[1])


def _src_iter(table, chunk: int):
    """Yield ``(start, np block)`` host views, at most ``chunk`` rows each
    (a ``HostEmbedTable``'s never cross a shard)."""
    from hyperspace_torch.parallel.host_table import HostEmbedTable

    if isinstance(table, HostEmbedTable):
        yield from table.iter_chunks(chunk)
        return
    for lo in range(0, table.shape[0], chunk):
        yield lo, table[lo:lo + chunk]


def _src_gather(table, ids: np.ndarray) -> np.ndarray:
    from hyperspace_torch.parallel.host_table import HostEmbedTable

    if isinstance(table, HostEmbedTable):
        return table.gather(ids)
    return table[ids]


def _device_block(block: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One streamed host block on the device: the only table rows a
    streamed build holds there at a time."""
    return torch.tensor(np.asarray(block, np.float32), device=dev)


def _blocks(src, chunk: int, dev: torch.device):
    """``(start, device block)`` over a resident device tensor (slices)
    or a host source (one copied block at a time)."""
    if isinstance(src, torch.Tensor):
        for lo in range(0, src.shape[0], chunk):
            yield lo, src[lo:lo + chunk]
        return
    for lo, blk in _src_iter(src, chunk):
        yield lo, _device_block(blk, dev)


def _rows_of(src, ids: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The rows ``ids`` of a resident tensor or a host source, on the
    device."""
    if isinstance(src, torch.Tensor):
        return src[torch.as_tensor(ids, device=dev)]
    return _device_block(_src_gather(src, ids), dev)


def _lloyd(src, cent: torch.Tensor, *, spec: tuple, chunk: int, iters: int,
           ncells: int):
    """Fixed-iteration Lloyd over ``src`` in ``chunk``-row blocks: a
    device tensor (the resident build) or a host source (the streamed
    build, one block on the device at a time); the same per-block
    arithmetic in the same fold order either way.

    Returns ``(centroids [ncells, D], assign [N] int64)`` — the
    assignment is a final pass against the returned centroids, so the
    cell layout matches them exactly."""
    dev = cent.device
    dl = _lift_dim(spec, _src_rows(src)[1])
    for _ in range(int(iters)):
        sums = torch.zeros((ncells, dl), dtype=torch.float32, device=dev)
        cnts = torch.zeros(ncells, dtype=torch.float32, device=dev)
        for _lo, rows in _blocks(src, chunk, dev):
            a = _nearest_centroid(cent, rows, spec=spec)
            s, k = _segment_sums(_lift(spec, rows), a, ncells)
            sums, cnts = sums + s, cnts + k
        new = _unlift(spec, sums, cnts)
        # empty cells keep their centroid — a zero sum must never
        # normalize into a garbage point that then captures rows
        cent = torch.where(cnts[:, None] > 0, new, cent)
    assign = torch.cat([_nearest_centroid(cent, rows, spec=spec)
                        for _lo, rows in _blocks(src, chunk, dev)])
    return cent, assign


def _lloyd_stream(table, cent0: torch.Tensor, *, spec: tuple, chunk: int,
                  iters: int, ncells: int):
    """The host-streamed Lloyd: :func:`_lloyd` over the host source, the
    largest block it put on the device in ``index/build_device_rows_peak``
    (a row count)."""
    from hyperspace_torch.telemetry import registry as telem

    peak = max((blk.shape[0] for _lo, blk in _src_iter(table, chunk)),
               default=0)
    telem.set_gauge("index/build_device_rows_peak", peak)
    return _lloyd(table, cent0, spec=spec, chunk=chunk, iters=iters,
                  ncells=ncells)


def _own_dist(rows: torch.Tensor, cent_rows: torch.Tensor, *,
              spec: tuple) -> torch.Tensor:
    """Per-row geodesic distance to the row's own centroid ([N])."""
    return _dist(spec, rows, cent_rows)


def _all_cell_dist(rows: torch.Tensor, cent: torch.Tensor, *,
                   spec: tuple) -> torch.Tensor:
    """[S, ncells] geodesic distances rows × centroids (``pdist`` for
    the hyperbolic families, as the JAX index build's ``_tile_dist``)."""
    if spec[0] in ("poincare", "lorentz"):
        from hyperspace_torch.kernels.distmat import pdist

        return pdist(rows, cent, spec[1], manifold=spec[0])
    return _dist(spec, rows[:, None, :], cent[None, :, :])


def _spill_balance(src, centroids: torch.Tensor, assign: np.ndarray,
                   spec: tuple, *, cap: int) -> np.ndarray:
    """Cap every cell at ``cap`` rows.

    Oversized cells keep their ``cap`` closest members (by geodesic
    distance to the centroid); spilled rows re-assign by rank rounds:
    at round ``j`` every still-unplaced row bids for its ``j``-th
    nearest centroid, and each cell grants its remaining room in
    spilled order.  Total capacity ``ncells × cap >= N`` guarantees
    every row lands.  ``src`` is the resident device table or the
    streamed build's host source (blocks and spilled rows copied to the
    device as needed)."""
    ncells = int(centroids.shape[0])
    counts = np.bincount(assign, minlength=ncells)
    if counts.max() <= cap:
        return assign
    dev = centroids.device
    parts = []
    for lo, blk in _blocks(src, _BUILD_CHUNK, dev):
        ca = centroids[torch.as_tensor(assign[lo:lo + blk.shape[0]],
                                       device=dev)]
        parts.append(_own_dist(blk, ca, spec=spec).cpu().numpy())
    d_own = np.concatenate(parts)
    assign = assign.copy()
    spilled = []
    for c in np.flatnonzero(counts > cap):
        members = np.flatnonzero(assign == c)
        order = members[np.argsort(d_own[members], kind="stable")]
        spilled.append(order[cap:])
    spilled = np.concatenate(spilled)
    room = (cap - np.minimum(counts, cap)).astype(np.int64)
    bs = _BUILD_CHUNK
    for s in range(0, len(spilled), bs):
        rows = spilled[s:s + bs]
        pd = _all_cell_dist(_rows_of(src, rows, dev), centroids,
                            spec=spec).cpu().numpy()
        pref = np.argsort(pd, axis=1, kind="stable")
        left = np.arange(len(rows))
        for j in range(ncells):
            if not left.size:
                break
            want = pref[left, j]
            order = np.argsort(want, kind="stable")  # stable ⇒ spilled order
            w = want[order]
            _uniq, starts, cnt = np.unique(w, return_index=True,
                                           return_counts=True)
            bid_rank = np.arange(len(w)) - np.repeat(starts, cnt)
            ok = bid_rank < room[w]
            granted = order[ok]
            assign[rows[left[granted]]] = want[granted]
            room -= np.bincount(w[ok], minlength=ncells)
            keep = np.ones(len(left), bool)
            keep[granted] = False
            left = left[keep]
    return assign


def build_index(table, manifold_spec: tuple, ncells: int, *,
                iters: int = 8, seed: int = 0,
                chunk: int = _BUILD_CHUNK,
                balance: float = 2.0,
                seed_sample: int = 0,
                host_resident: bool | None = None,
                device="cuda") -> ServingIndex:
    """Offline IVF build: hyperbolic k-means + dense cell layout.

    Deterministic for a fixed ``(table, spec, ncells, iters, seed)`` on
    a given device: the seeding RNG is ``np.random.default_rng(seed)``
    (the JAX index build's stream).  ``balance`` caps cells at
    ``balance × N/ncells`` rows (0 disables the cap);
    ``seed_sample`` draws the k-means++ seeds from a uniform subsample
    of that many rows.  ``table`` is an ``[N, D]`` array or a
    :class:`~hyperspace_torch.parallel.host_table.HostEmbedTable`;
    ``host_resident`` picks the streamed build (module docstring; None:
    a ``HostEmbedTable`` or ``N >= HOST_BUILD_ROWS`` streams).  The work
    runs on ``device`` — CUDA unless the caller asks for the CPU."""
    from hyperspace_torch.parallel.host_table import HostEmbedTable

    is_host_tab = isinstance(table, HostEmbedTable)
    if not is_host_tab:
        table = np.ascontiguousarray(np.asarray(table, np.float32))
        if table.ndim != 2:
            raise ValueError(
                f"index table must be [N, D]; got {table.shape}")
    n, _dim = _src_rows(table)
    ncells = int(ncells)
    if not 2 <= ncells <= n:
        raise ValueError(
            f"ncells must be in [2, {n}] for a {n}-row table; got {ncells}")
    if balance and not balance >= 1.0:
        raise ValueError(
            f"balance must be 0 (disabled) or >= 1.0; got {balance}")
    spec = tuple(manifold_spec)
    _check_kind(spec)
    stream = (host_resident if host_resident is not None
              else is_host_tab or n >= HOST_BUILD_ROWS)
    if is_host_tab and not stream:
        raise ValueError(
            "a HostEmbedTable source builds host-resident — drop "
            "host_resident=False (densifying it on device is the "
            "materialization this path exists to avoid)")
    dev = _support.resolve_device(device)

    # k-means++ seeding: D² sampling under the geodesic metric — each
    # new seed is drawn ∝ squared distance to the nearest chosen seed
    rng = np.random.default_rng(seed)

    def sq_dist_to(rows, pick):
        d = _dist(spec, rows, rows[pick][None, :]).cpu().numpy()
        return np.square(d, dtype=np.float64)

    tdev = None
    if stream or (seed_sample and int(seed_sample) < n):
        ssize = min(int(seed_sample) or SEED_SAMPLE_DEFAULT, n)
        if ssize < ncells:
            raise ValueError(
                f"seed_sample={ssize} must hold at least ncells="
                f"{ncells} candidate rows")
        sample_ids = np.sort(rng.choice(n, size=ssize, replace=False))
        if stream:
            pool = _device_block(_src_gather(table, sample_ids), dev)
        else:
            tdev = torch.tensor(table, device=dev)
            pool = tdev[torch.as_tensor(sample_ids, device=dev)]
    else:
        pool = tdev = torch.tensor(table, device=dev)
    size = pool.shape[0]
    chosen = [int(rng.integers(size))]
    d2 = sq_dist_to(pool, chosen[0])
    for _ in range(ncells - 1):
        total = d2.sum()
        if total > 0:
            pick = int(rng.choice(size, p=d2 / total))
        else:  # all remaining mass at distance 0 (duplicate points)
            pick = int(rng.integers(size))
        chosen.append(pick)
        d2 = np.minimum(d2, sq_dist_to(pool, pick))
    cent0 = pool[torch.as_tensor(chosen, device=dev)]

    if stream:
        src = table
        cent, assign = _lloyd_stream(table, cent0, spec=spec,
                                     chunk=int(chunk), iters=int(iters),
                                     ncells=ncells)
    else:
        src = tdev
        cent, assign = _lloyd(tdev, cent0, spec=spec, chunk=int(chunk),
                              iters=int(iters), ncells=ncells)
    centroids = cent.cpu().numpy().astype(np.float32)
    assign = assign.cpu().numpy()
    if balance and balance > 0:
        assign = _spill_balance(src, cent, assign, spec,
                                cap=int(np.ceil(float(balance) * n
                                                / ncells)))

    counts = np.bincount(assign, minlength=ncells).astype(np.int32)
    max_cell = int(max(counts.max(), 1))
    cells = np.full((ncells, max_cell), -1, np.int32)
    order = np.argsort(assign, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    for c in range(ncells):
        ids = order[starts[c]:starts[c + 1]]
        cells[c, :len(ids)] = ids

    fp = index_fingerprint_of(centroids, cells, counts, num_nodes=n,
                              iters=int(iters), seed=int(seed))
    return ServingIndex(centroids=centroids, cells=cells, counts=counts,
                        num_nodes=n, iters=int(iters), seed=int(seed),
                        fingerprint=fp)

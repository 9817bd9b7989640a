"""Batched exact k-NN and edge scoring over a frozen embedding table
(counterpart of ``hyperspace_tpu/serve/engine.py``, single device, f32).

- ``topk_neighbors(q_idx, k)`` — the k nearest table rows to each query
  row under the hyperbolic metric (Poincaré-embedding retrieval);
- ``score_edges(u_idx, v_idx)`` — per-pair distances, optionally through
  the Fermi–Dirac link decoder of the HGCN LP head.

The table moves to the device once, zero-padded to a chunk multiple;
padded rows and each query's own row are masked to +inf by index.  Two
scan strategies (``scan_mode``), rank-identical:

- ``two_stage`` (default): each table chunk is one ``pdist`` kernel
  launch (``kernels/distmat.py``) giving a [B, chunk] distance tile, a
  stable per-chunk top-k keeps k candidates, and one stable merge of
  the [B, chunks·k] candidates answers.  Stable sorts keep the lowest
  column first among equal distances, as ``lax.top_k`` does.  No step
  of the chunk loop reads a value back to the host.
- ``fused``: one ``scan_topk`` kernel launch (``kernels/scan_topk.py``)
  over the padded table; the distance matrix never reaches memory.  k
  above ``FUSED_MAX_K`` uses the two-stage scan.

Everything runs on ``device`` — CUDA unless the caller asks for the CPU,
where the kernels' plain versions answer.  Not ported yet (they raise):
the ``carry`` scan, the bf16/int8/int4/PQ lanes, IVF probing, mesh
sharding, and product / sphere / euclidean specs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hyperspace_torch.kernels import _support
from hyperspace_torch.kernels import scan_topk as fused_kernel
from hyperspace_torch.kernels.distmat import pdist
from hyperspace_torch.manifolds import Lorentz, PoincareBall
from hyperspace_torch.serve.artifact import ServingArtifact, fingerprint_of

# f32 bytes one [B, chunk] distance tile may occupy at the nominal batch
TILE_BUDGET = 8 * 1024 * 1024
NOMINAL_BATCH = 1024  # the batcher's default max bucket
_ROW_ALIGN = 128

SCAN_MODES = ("two_stage", "fused")
_MANIFOLDS = {"poincare": PoincareBall, "lorentz": Lorentz}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def auto_chunk_rows(n: int) -> int:
    """Table-chunk rows that keep one [NOMINAL_BATCH, chunk] f32 distance
    tile under ``TILE_BUDGET`` (the two-stage sizing of the JAX
    engine)."""
    per_row = 4 * NOMINAL_BATCH
    chunk = max(_ROW_ALIGN,
                (TILE_BUDGET // per_row) // _ROW_ALIGN * _ROW_ALIGN)
    return min(chunk, _round_up(max(n, 1), _ROW_ALIGN))


def _fermi_dirac(d: torch.Tensor, r: float, t: float) -> torch.Tensor:
    """The HGCN LP head's link decoder."""
    return 1.0 / (torch.exp((torch.square(d) - r) / t) + 1.0)


class QueryEngine:
    """Batched k-NN / edge-score queries over one frozen table."""

    def __init__(self, table, manifold_spec: tuple, *,
                 fingerprint: Optional[str] = None,
                 chunk_rows: int = 0,
                 scan_mode: str = "two_stage",
                 precision: str = "f32",
                 device="cuda",
                 mesh=None, index=None, nprobe: int = 0):
        table = np.ascontiguousarray(np.asarray(table))
        if table.ndim != 2:
            raise ValueError(f"table must be [N, D]; got {table.shape}")
        if scan_mode == "carry":
            raise ValueError("scan_mode='carry' is not ported yet "
                             f"(want one of {SCAN_MODES})")
        if scan_mode not in SCAN_MODES:
            raise ValueError(
                f"scan_mode must be one of {SCAN_MODES}; got {scan_mode!r}")
        if precision != "f32":
            raise ValueError(f"precision={precision!r} is not ported yet "
                             "(only the f32 scan is)")
        if mesh is not None:
            raise ValueError("mesh sharding is not ported yet")
        if index is not None or nprobe:
            raise ValueError("IVF probing is not ported yet")
        self.spec = tuple(manifold_spec)
        if self.spec[0] not in _MANIFOLDS:
            raise ValueError(f"{self.spec[0]!r} specs are not ported yet "
                             f"(want one of {sorted(_MANIFOLDS)})")
        chunk_rows = int(chunk_rows)
        if chunk_rows < 0:
            raise ValueError(f"chunk_rows must be >= 0 (0 = auto); "
                             f"got {chunk_rows}")
        self.device = _support.resolve_device(device)
        self.num_nodes, self.dim = (int(s) for s in table.shape)
        self.scan_mode = scan_mode
        self.precision = precision
        self.manifold = _MANIFOLDS[self.spec[0]](float(self.spec[1]))
        self.fingerprint = fingerprint or fingerprint_of(table, self.spec)
        self.chunk_rows = chunk_rows or auto_chunk_rows(self.num_nodes)
        self._fused = (scan_mode == "fused"
                       and fused_kernel.kind_supported(self.spec)
                       and self.dim <= fused_kernel.FUSED_MAX_DIM)
        padded = _round_up(self.num_nodes, self.chunk_rows)
        src = torch.from_numpy(table)
        self.table = torch.zeros((padded, self.dim), dtype=src.dtype,
                                 device=self.device)   # [padded, D]
        self.table[:self.num_nodes] = src.to(self.device)
        self._cols = torch.arange(padded, dtype=torch.int32,
                                  device=self.device)

    @classmethod
    def from_artifact(cls, art: ServingArtifact, **kw) -> "QueryEngine":
        return cls(art.table, art.manifold_spec,
                   fingerprint=art.fingerprint, **kw)

    @property
    def scan_strategy(self) -> str:
        return "exact"

    @property
    def scan_signature(self) -> tuple:
        """Result identity of the scan path (a batcher cache-key part):
        fused answers are rank-identical to two-stage ones but only
        ulp-close in distance, so they are keyed apart."""
        return ("exact",) + (("fused",) if self._fused else ())

    # --- queries --------------------------------------------------------------

    def topk_neighbors(self, q_idx, k: int, *, exclude_self: bool = True):
        """``(neighbors [B, k] int32, dists [B, k])`` tensors on the
        engine's device, ascending by distance.  ``k`` must leave room
        in the table (``k <= N - exclude_self``)."""
        q_idx = self._check_ids(q_idx, "q_idx")
        k = int(k)
        limit = self.num_nodes - (1 if exclude_self else 0)
        if not 1 <= k <= limit:
            raise ValueError(
                f"k={k} out of range [1, {limit}] for a {self.num_nodes}-row "
                f"table (exclude_self={exclude_self})")
        q = self.table[q_idx.long()]                       # [B, D]
        if self._fused and fused_kernel.supports(self.spec, k=k,
                                                 dim=self.dim):
            d, i = fused_kernel.scan_topk(
                self.table, q, q_idx, 0, spec=self.spec, k=k,
                n=self.num_nodes, exclude_self=exclude_self)
            return i, d
        return self._two_stage(q, q_idx, k, exclude_self)

    def _two_stage(self, q: torch.Tensor, q_idx: torch.Tensor, k: int,
                   exclude_self: bool):
        chunk = self.chunk_rows
        kc = min(k, chunk)
        cand_d, cand_i = [], []
        for s in range(0, self.table.shape[0], chunk):
            d = pdist(q, self.table[s:s + chunk], self.spec[1],
                      manifold=self.spec[0])               # [B, chunk]
            cols = self._cols[s:s + chunk]
            if s + chunk > self.num_nodes:                 # zero padding
                d.masked_fill_((cols >= self.num_nodes)[None, :],
                               float("inf"))
            if exclude_self:
                d.masked_fill_(cols[None, :] == q_idx[:, None], float("inf"))
            top, order = torch.sort(d, dim=1, stable=True)
            cand_d.append(top[:, :kc])
            cand_i.append(cols[order[:, :kc]])
        top, order = torch.sort(torch.cat(cand_d, dim=1), dim=1, stable=True)
        return (torch.gather(torch.cat(cand_i, dim=1), 1, order[:, :k]),
                top[:, :k])

    def score_edges(self, u_idx, v_idx, *, prob: bool = False,
                    fd_r: float = 2.0, fd_t: float = 1.0) -> torch.Tensor:
        """Per-pair manifold distances ``d(table[u], table[v])`` ([B]);
        ``prob=True`` maps them through the Fermi–Dirac decoder
        ``1 / (exp((d² − r)/t) + 1)``."""
        u_idx = self._check_ids(u_idx, "u_idx").long()
        v_idx = self._check_ids(v_idx, "v_idx").long()
        if u_idx.shape != v_idx.shape:
            raise ValueError(
                f"u_idx {tuple(u_idx.shape)} and v_idx "
                f"{tuple(v_idx.shape)} must match")
        d = self.manifold.dist(self.table[u_idx], self.table[v_idx])
        return _fermi_dirac(d, fd_r, fd_t) if prob else d

    def _check_ids(self, ids, name: str) -> torch.Tensor:
        arr = np.asarray(ids)
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError(f"{name} must be a non-empty 1-D id array")
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"{name} must be integer ids; got {arr.dtype}")
        if arr.min() < 0 or arr.max() >= self.num_nodes:
            raise ValueError(
                f"{name} out of range [0, {self.num_nodes}): "
                f"min={arr.min()}, max={arr.max()}")
        return torch.as_tensor(arr.astype(np.int32), device=self.device)

"""Batched k-NN and edge scoring over a frozen embedding table
(counterpart of ``hyperspace_tpu/serve/engine.py``, single device).

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

Specs: the ball and the hyperboloid score chunks with ``pdist``;
euclidean, sphere and product specs with the manifold's own distance
(the JAX engine's ``_tile_dist``), euclidean also through the fused
scan.  Sphere and product specs have no kernel of their own, in JAX as
here, so ``fused`` serves them by the two-stage scan.

The coarse-scan lanes (``precision=``) compose with both modes.  Each
keeps a copy of the padded table beside the f32 master, scans it for
``k_scan`` candidates and rescores them against the master, so every
returned distance is an f32 manifold distance:

- **bf16**: a bf16 copy, the queries cast to bf16; ``k + max(k, 8)``
  candidates; bf16 ``pdist`` chunks under ``two_stage``.
- **int8**: a per-row symmetric int8 code and f32 scale
  (``serve/quant.py``); ``k + max(4k, 32)`` candidates.
- **int4**: two nibbles a byte and an f16 scale a row (``quant=`` takes
  an int4 payload shipped in an artifact); ``k + max(16k, 128)``.
- **PQ**: one uint8 code a subspace of each row's lift (``quant=``
  takes a PQ payload); ``k + max(16k, 128)`` candidates, by ADC in the
  ``scan_topk_pq`` kernel under ``fused``, by decoding chunks to the
  lift under ``two_stage`` (product specs: always, per factor).

Under ``fused`` the bf16, int8 and int4 lanes stream their copy through
``scan_topk``; under ``two_stage`` each chunk is widened to f32 in
PyTorch (bf16 stays bf16 for ``pdist``) and scored as the f32 lane's.

**IVF probing** (``index=`` + ``nprobe=``; ``serve/index.py``) composes
with every lane and spec: the queries are scored against the index's
centroids (``pdist`` in f32, or the manifold's distance), the nearest
``nprobe`` cells' row ids are gathered (nearest cell first, ``-1`` pads
inside each cell's row), and only those candidates are scanned — by the
``scan_topk_cand`` kernel under ``fused`` (f32, bf16 and int8 copies),
by chunked gathers and plain distances under ``two_stage`` and for int4
and PQ; ties go to the earlier candidate position.  The lanes' rescore
follows.  Exact fallbacks (the engine then is the exact engine):
``nprobe=0``, ``nprobe >= ncells``, tables under ``IVF_MIN_TABLE_ROWS``.

Inside a span scope (``telemetry/spans.py``, the serve CLI's ``trace=``)
each query records a ``device_compute`` stage that ends after a sync of
the caller's stream; with spans off nothing waits.

The live index (``serve/delta.py``) queries a frozen engine through
``topk_neighbors(q_rows=, drop=, allow_underfill=)``: fresh query rows,
and a tombstone penalty row added to every tile (a masked scan always
runs the two-stage path: no kernel has a tombstone lane).

Everything runs on ``device`` — CUDA unless the caller asks for the CPU,
where the kernels' plain versions answer.  Not ported yet (they raise):
the ``carry`` scan and mesh sharding.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hyperspace_torch.kernels import _support
from hyperspace_torch.kernels import scan_topk as fused_kernel
from hyperspace_torch.kernels.distmat import pdist
from hyperspace_torch.manifolds import smath
from hyperspace_torch.serve.artifact import (ServingArtifact, fingerprint_of,
                                             manifold_from_spec, spec_dim)
from hyperspace_torch.telemetry import spans

# f32 bytes one [B, chunk] distance tile may occupy at the nominal batch
TILE_BUDGET = 8 * 1024 * 1024
NOMINAL_BATCH = 1024  # the batcher's default max bucket
_ROW_ALIGN = 128

SCAN_MODES = ("two_stage", "fused")
QUANT_PRECISIONS = ("int8", "int4", "pq")
PRECISIONS = ("f32", "bf16") + QUANT_PRECISIONS
SPEC_KINDS = ("poincare", "lorentz", "euclidean", "sphere", "product")
# the families whose chunks ``pdist`` scores
_PDIST_KINDS = ("poincare", "lorentz")

# each lane's over-fetch, k + max(MULT·k, MIN) coarse candidates (the
# JAX engine's), so the f32 rescore can repair the coarse ranking's
# k-th-boundary mistakes: bf16 and int8 steps are fine, int4's 16 times
# int8's, and a PQ code quantizes whole subspaces
_RESCORE = {"bf16": (1, 8), "int8": (4, 32), "int4": (16, 128),
            "pq": (16, 128)}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def auto_chunk_rows(n: int, width: int = 1) -> int:
    """Table-chunk rows that keep one [NOMINAL_BATCH, chunk, width] f32
    tile under ``TILE_BUDGET`` (the two-stage sizing of the JAX engine:
    ``width`` 1 for [B, chunk] distance tiles, a product spec's row width
    for its factors' broadcast distances)."""
    per_row = 4 * NOMINAL_BATCH * int(width)
    chunk = max(_ROW_ALIGN,
                (TILE_BUDGET // per_row) // _ROW_ALIGN * _ROW_ALIGN)
    return min(chunk, _round_up(max(n, 1), _ROW_ALIGN))


def cand_chunk_rows(dim: int, capacity: int) -> int:
    """Candidate columns a two-stage IVF tile takes: the [B, chunk, D]
    gathered rows under four tile budgets at the nominal batch (the JAX
    engine's ``_cand_chunk``)."""
    per_row = 4 * NOMINAL_BATCH * dim
    chunk = max(_ROW_ALIGN,
                (4 * TILE_BUDGET // per_row) // _ROW_ALIGN * _ROW_ALIGN)
    return min(chunk, _round_up(max(capacity, 1), _ROW_ALIGN))


def _fermi_dirac(d: torch.Tensor, r: float, t: float) -> torch.Tensor:
    """The HGCN LP head's link decoder."""
    return 1.0 / (torch.exp((torch.square(d) - r) / t) + 1.0)


def _arcosh_close(c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """arcosh(1 + u)/√c for a clamped argument ``u``."""
    return smath.arcosh1p(u) / smath.clamp_min(smath.sqrt_c(c, u),
                                               smath.min_norm(u.dtype))


def _tile_dist(spec: tuple, q: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """[B, D] × [M, D] → [B, M] distances: ``pdist`` for the ball and the
    hyperboloid (in the inputs' dtype, f32 or bf16), the manifold's own
    distance broadcast for the other specs (in f32)."""
    if spec[0] in _PDIST_KINDS:
        return pdist(q, rows, spec[1], manifold=spec[0])
    return manifold_from_spec(spec).dist(q.float()[:, None, :],
                                         rows.float()[None, :, :])


def _cand_dist(spec: tuple, q: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """[B, D] queries × per-query candidate rows [B, C, D] → [B, C]: the
    closed forms with one batched Gram (the manifold's own distance for
    euclidean, sphere and product specs, as in JAX)."""
    if spec[0] not in _PDIST_KINDS:
        return manifold_from_spec(spec).dist(q[:, None, :], rows)
    c = torch.as_tensor(spec[1], dtype=q.dtype, device=q.device)
    if spec[0] == "lorentz":
        gram = (torch.einsum("bd,bcd->bc", q[:, 1:], rows[..., 1:])
                - q[:, :1] * rows[..., 0])                # ⟨x, y⟩_L
        return _arcosh_close(c, smath.clamp_min(-c * gram - 1.0, 0.0))
    gram = torch.einsum("bd,bcd->bc", q, rows)
    xx = smath.sq_norm(q)                                 # [B, 1]
    yy = smath.sq_norm(rows)[..., 0]                      # [B, C]
    d2 = smath.clamp_min(xx - 2.0 * gram + yy, 0.0)
    den = smath.clamp_min((1.0 - c * xx) * (1.0 - c * yy),
                          smath.eps_for(q.dtype))
    return _arcosh_close(c, 2.0 * c * d2 / den)


def _pq_decode_rows(cb: torch.Tensor, codes: torch.Tensor,
                    lift_dim: int) -> torch.Tensor:
    """PQ codes [..., m] uint8 + codebooks [m, 256, ds] → reconstructed
    lifted rows [..., lift_dim] (the codebooks' pad lanes sliced off)."""
    m = cb.shape[0]
    sel = cb[torch.arange(m, device=cb.device), codes.long()]  # [..., m, ds]
    return sel.reshape(codes.shape[:-1] + (m * cb.shape[2],))[..., :lift_dim]


def _pq_lift_dist(spec: tuple, q_lift: torch.Tensor,
                  rows_lift: torch.Tensor) -> torch.Tensor:
    """Coarse distances in the lift: lifted queries [B, DL] ×
    reconstructions ([M, DL] shared or [B, C, DL] per query) → [B, M] /
    [B, C] (the JAX engine's ``_pq_lift_dist``).  A ball or hyperboloid
    lifts to Lorentz coordinates at the spec's curvature (the clamps the
    PQ kernel applies: the reconstructions sit off the hyperboloid);
    euclidean to itself (the Gram form); a sphere to itself, the
    reconstruction projected back; a product per factor, combined as
    ``Product.dist`` combines them."""
    kind = spec[0]
    shared = rows_lift.ndim == 2
    if kind == "product":
        from hyperspace_torch.serve.index import _lift_dim

        o, acc = 0, 0.0
        for fk, d, c in spec[1]:
            dl = _lift_dim((fk, c), d)
            df = _pq_lift_dist((fk, c), q_lift[:, o:o + dl],
                               rows_lift[..., o:o + dl])
            acc = acc + torch.square(df)
            o += dl
        return smath.safe_sqrt(acc)
    if kind in _PDIST_KINDS:
        c = torch.as_tensor(spec[1], dtype=q_lift.dtype,
                            device=q_lift.device)
        if shared:
            gram = (q_lift[:, 1:] @ rows_lift[:, 1:].T
                    - q_lift[:, :1] * rows_lift[None, :, 0])
        else:
            gram = (torch.einsum("bd,bcd->bc", q_lift[:, 1:],
                                 rows_lift[..., 1:])
                    - q_lift[:, :1] * rows_lift[..., 0])
        return _arcosh_close(c, smath.clamp_min(-c * gram - 1.0, 0.0))
    if kind == "euclidean":
        if shared:
            gram = q_lift @ rows_lift.T
            yy = torch.sum(rows_lift * rows_lift, dim=-1)[None, :]
        else:
            gram = torch.einsum("bd,bcd->bc", q_lift, rows_lift)
            yy = torch.sum(rows_lift * rows_lift, dim=-1)
        xx = torch.sum(q_lift * q_lift, dim=-1, keepdim=True)
        return smath.safe_sqrt(smath.clamp_min(xx - 2.0 * gram + yy, 0.0))
    m = manifold_from_spec(spec)          # sphere: the lift is the identity
    rows = m.proj(rows_lift)
    if shared:
        return m.dist(q_lift[:, None, :], rows[None, :, :])
    return m.dist(q_lift[:, None, :], rows)


def _rescore_f32(spec: tuple, rows: torch.Tensor, q: torch.Tensor,
                 idx: torch.Tensor, scan_d: torch.Tensor) -> torch.Tensor:
    """f32 manifold distances of gathered candidate rows [B, K, D] to the
    f32 queries [B, D]; slots the coarse scan left at -1 or +inf stay
    +inf, so they never outrank a real candidate."""
    d = manifold_from_spec(spec).dist(q[:, None, :], rows)
    return torch.where((idx < 0) | ~torch.isfinite(scan_d),
                       torch.full_like(d, float("inf")), d)


def _merge_rescored(d32: torch.Tensor, idx: torch.Tensor, k: int):
    """Final ranking: the stable top-k of the rescored candidates →
    ``(ids, dists)``."""
    dist, out = _stable_topk(d32, idx, k)
    return out, dist


def _stable_topk(d: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest of ``d`` [B, W] with their ids, equal distances in
    column order (``lax.top_k``'s rule; ``torch.topk`` is not stable)."""
    top, order = torch.sort(d, dim=1, stable=True)
    return top[:, :k], torch.gather(ids, 1, order[:, :k])


def _two_stage_core(tiles, k: int):
    """Per-tile stable top-k over each ``(d [B, w], ids [B, w])`` of
    ``tiles`` (masked slots +inf), then one stable merge of the kept
    candidates → ``(dists ascending, ids)`` [B, min(k, Σw)]."""
    cand_d, cand_i = [], []
    for d, ids in tiles:
        top, sel = _stable_topk(d, ids, min(k, d.shape[1]))
        cand_d.append(top)
        cand_i.append(sel)
    return _stable_topk(torch.cat(cand_d, dim=1), torch.cat(cand_i, dim=1), k)


class QueryEngine:
    """Batched k-NN / edge-score queries over one frozen table."""

    def __init__(self, table, manifold_spec: tuple, *,
                 fingerprint: Optional[str] = None,
                 chunk_rows: int = 0,
                 scan_mode: str = "two_stage",
                 precision: str = "f32",
                 device="cuda",
                 mesh=None, index=None, nprobe: int = 0,
                 quant=None, pq_m: int = 0):
        table = np.ascontiguousarray(np.asarray(table))
        if table.ndim != 2:
            raise ValueError(f"table must be [N, D]; got {table.shape}")
        if scan_mode == "carry":
            raise ValueError("scan_mode='carry' is not ported yet "
                             f"(want one of {SCAN_MODES})")
        if scan_mode not in SCAN_MODES:
            raise ValueError(
                f"scan_mode must be one of {SCAN_MODES}; got {scan_mode!r}")
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}; got {precision!r}")
        if mesh is not None:
            raise ValueError("mesh sharding is not ported yet")
        self.spec = tuple(manifold_spec)
        if self.spec[0] not in SPEC_KINDS:
            raise ValueError(f"unknown manifold spec kind {self.spec[0]!r} "
                             f"(want one of {SPEC_KINDS})")
        want = spec_dim(self.spec)
        if want >= 0 and table.shape[1] != want:
            raise ValueError(f"table width {table.shape[1]} != product "
                             f"spec width {want}")
        chunk_rows = int(chunk_rows)
        if chunk_rows < 0:
            raise ValueError(f"chunk_rows must be >= 0 (0 = auto); "
                             f"got {chunk_rows}")
        self.num_nodes, self.dim = (int(s) for s in table.shape)
        self.nprobe = int(nprobe)
        if self.nprobe < 0:
            raise ValueError(f"nprobe must be >= 0; got {nprobe}")
        if self.nprobe > 0 and index is None:
            raise ValueError(
                "nprobe > 0 needs an IVF index (build one with "
                "serve.index.build_index, or export with index=)")
        if index is not None:
            if int(index.num_nodes) != self.num_nodes:
                raise ValueError(
                    f"index was built over {index.num_nodes} rows; "
                    f"table has {self.num_nodes}")
            if int(index.centroids.shape[1]) != self.dim:
                raise ValueError(
                    f"index centroid width {index.centroids.shape[1]} "
                    f"!= table width {self.dim}")
        # a payload is read only by the lane it packs (an artifact may
        # carry an int4 payload while this engine serves f32)
        if quant is not None and getattr(quant, "lane", None) == precision:
            if int(quant.num_nodes) != self.num_nodes:
                raise ValueError(
                    f"quant payload covers {quant.num_nodes} rows; table "
                    f"has {self.num_nodes} — re-export for THIS table")
        else:
            quant = None
        self.device = _support.resolve_device(device)
        self.scan_mode = scan_mode
        self.precision = precision
        self.index = index
        self.manifold = manifold_from_spec(self.spec)
        self.fingerprint = fingerprint or fingerprint_of(table, self.spec)
        self.chunk_rows = chunk_rows or auto_chunk_rows(
            self.num_nodes, self.dim if self.spec[0] == "product" else 1)
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
        self._pq = precision == "pq"
        self._mixed = precision != "f32"
        self.scan_table, self.scan_scale = self.table, None
        if self._pq:
            self._init_pq(table, quant, int(pq_m), padded)
        elif self._mixed:
            self._init_lane(table, quant, padded)

        from hyperspace_torch.serve.index import IVF_MIN_TABLE_ROWS

        self._ivf = (index is not None and 0 < self.nprobe < index.ncells
                     and self.num_nodes >= IVF_MIN_TABLE_ROWS)
        if self._ivf:
            self._centroids = torch.as_tensor(
                np.asarray(index.centroids, np.float32), device=self.device)
            self._cells = torch.as_tensor(
                np.asarray(index.cells, np.int32), device=self.device)
            self._cand_chunk = cand_chunk_rows(
                self.dim, self.nprobe * index.max_cell)

    def _init_lane(self, table: np.ndarray, quant, padded: int) -> None:
        """The bf16, int8 or int4 scan copy of the padded table (zero
        padding rows quantize to scale 0 and dequantize to exact zeros;
        they are masked by index anyway); int4 takes a matching
        payload's codes."""
        from hyperspace_torch.serve import quant as Q

        if self.precision == "bf16":
            self.scan_table = self.table.to(torch.bfloat16)
            return
        rows = np.zeros((padded, self.dim), np.float32)
        rows[:self.num_nodes] = table
        if self.precision == "int8":
            codes, scale = Q.quantize_rows(rows)
        elif quant is not None:
            codes = np.zeros((padded, Q.int4_packed_width(self.dim)),
                             np.uint8)
            scale = np.zeros((padded, 1), np.float16)
            codes[:self.num_nodes] = quant.arrays["packed"]
            scale[:self.num_nodes] = quant.arrays["scale"]
        else:
            codes, scale = Q.pack_int4_rows(rows)
        self.scan_table = torch.as_tensor(codes, device=self.device)
        self.scan_scale = torch.as_tensor(scale, device=self.device)

    def _init_pq(self, table: np.ndarray, quant, pq_m: int,
                 padded: int) -> None:
        """The PQ scan copy: the payload's codes and codebooks when it
        is a PQ payload for this table, else codebooks trained here."""
        from hyperspace_torch.serve.index import _lift_dim
        from hyperspace_torch.serve.quant import (build_pq, default_pq_m,
                                                  pq_fingerprint_of)

        self._lift_dim = _lift_dim(self.spec, self.dim)
        if quant is not None:
            pp = quant.params
            codes = quant.arrays["codes"]
            cb = np.asarray(quant.arrays["codebooks"], np.float32)
            self._pq_fp = pq_fingerprint_of(
                cb, lift_dim=int(pp["lift_dim"]), iters=int(pp["iters"]),
                seed=int(pp["seed"]))
        else:
            # train on the unpadded rows; padding rows get code 0 and
            # are masked by index
            codes, cbk = build_pq(table, self.spec, m=(
                pq_m or default_pq_m(self._lift_dim)))
            cb, self._pq_fp = cbk.codebooks, cbk.fingerprint
        self._pq_m = int(cb.shape[0])
        if self._fused:
            self._fused = self._pq_m <= fused_kernel.FUSED_MAX_PQ_M
        self.scan_table = torch.zeros((padded, self._pq_m),
                                      dtype=torch.uint8, device=self.device)
        self.scan_table[:self.num_nodes] = torch.as_tensor(
            np.ascontiguousarray(codes), device=self.device)
        self.pq_codebooks = torch.as_tensor(cb, device=self.device)

    @classmethod
    def from_artifact(cls, art: ServingArtifact, **kw) -> "QueryEngine":
        kw.setdefault("index", art.index)
        kw.setdefault("quant", art.quant)
        return cls(art.table, art.manifold_spec,
                   fingerprint=art.fingerprint, **kw)

    @property
    def scan_strategy(self) -> str:
        """``"ivf"`` when queries probe the index, else ``"exact"``."""
        return "ivf" if self._ivf else "exact"

    @property
    def scan_signature(self) -> tuple:
        """Result identity of the scan path (a batcher cache-key part):
        ``("exact",)`` or ``("ivf", nprobe, index fingerprint)``, then
        ``"fused"`` (rank-identical to two-stage but only ulp-close in
        distance) and the quantized lane (``"int8"``, ``"int4"``, or
        ``"pq"`` with its codebooks' fingerprint), as JAX's engine
        writes it; the batcher's key carries the precision beside it."""
        sig = (("ivf", self.nprobe, self.index.fingerprint) if self._ivf
               else ("exact",))
        return sig + self._lane_markers()

    def scan_signature_for(self, nprobe: int) -> tuple:
        """The signature at an overridden probe width."""
        return ("ivf", int(nprobe), self.index.fingerprint) \
            + self._lane_markers()

    def _lane_markers(self) -> tuple:
        lane = (("pq", self._pq_fp) if self._pq
                else (self.precision,) if self.precision in ("int8", "int4")
                else ())
        return (("fused",) if self._fused else ()) + lane

    def _k_scan(self, k: int, cap: int) -> int:
        """Over-fetch width of the lane's coarse scan, at most ``cap``."""
        mult, least = _RESCORE[self.precision]
        return min(k + max(mult * k, least), cap)

    # --- queries --------------------------------------------------------------

    def topk_neighbors(self, q_idx, k: int, *, exclude_self: bool = True,
                       nprobe: Optional[int] = None, q_rows=None, drop=None,
                       allow_underfill: bool = False):
        """``(neighbors [B, k] int32, dists [B, k])`` tensors on the
        engine's device, ascending by distance.  ``k`` must leave room
        in the table (``k <= N - exclude_self``).  ``nprobe`` (probing
        engines only) narrows the probe for this call, within
        ``[1, self.nprobe]``.

        ``q_rows`` / ``drop`` / ``allow_underfill`` are the live index's
        hooks (``serve/delta.py``).  ``q_rows`` ([B, D] f32) supplies the
        query vectors (fresh master rows) instead of this table's rows;
        the ids then only drive the self-mask and may lie past the
        table.  ``drop`` ([padded rows] f32: 0 live, +inf deleted or
        superseded) is added to every distance tile before its top-k, so
        a masked row never wins; a masked scan never takes a fused
        kernel (they have no such lane, in JAX as here) and runs the
        two-stage path.  ``allow_underfill`` lets a probing engine
        answer +inf filler instead of raising, for the caller's merge."""
        if q_rows is None:
            q_idx = self._check_ids(q_idx, "q_idx")
        else:
            arr = np.asarray(q_idx)
            if arr.ndim != 1 or arr.size == 0:
                raise ValueError("q_idx must be a non-empty 1-D id array")
            if not np.issubdtype(arr.dtype, np.integer):
                raise ValueError(
                    f"q_idx must be integer ids; got {arr.dtype}")
            q_rows = torch.as_tensor(q_rows, dtype=self.table.dtype,
                                     device=self.device)
            if q_rows.ndim != 2 or q_rows.shape[0] != arr.size:
                raise ValueError(
                    f"q_rows {tuple(q_rows.shape)} must be [B, D] aligned "
                    f"with q_idx (B={arr.size})")
            q_idx = torch.as_tensor(arr.astype(np.int32), device=self.device)
        if drop is not None:
            drop = torch.as_tensor(drop, dtype=self.table.dtype,
                                   device=self.device)
            if tuple(drop.shape) != (self.table.shape[0],):
                raise ValueError(
                    f"drop mask shape {tuple(drop.shape)} must match the "
                    f"padded table rows ({self.table.shape[0]},)")
        k = int(k)
        limit = self.num_nodes - (1 if exclude_self else 0)
        if not 1 <= k <= limit:
            raise ValueError(
                f"k={k} out of range [1, {limit}] for a {self.num_nodes}-row "
                f"table (exclude_self={exclude_self})")
        if nprobe is not None and not self._ivf:
            raise ValueError(
                "nprobe override needs a probing engine (this one "
                "answers by exact scan)")
        # the "device_compute" span stage: inside a span scope it closes
        # after the engine's stream has finished the scan, so it times
        # the device work, not the launches; spans off, it is a shared
        # no-op and nothing waits
        with spans.stage("device_compute",
                         metric="serve/stage/device_compute_ms"):
            out = self._topk(q_idx, k, exclude_self, nprobe, q_rows, drop,
                             allow_underfill)
            self._sync_for_span()
        return out

    def _topk(self, q_idx: torch.Tensor, k: int, exclude_self: bool,
              nprobe: Optional[int], q_rows=None, drop=None,
              allow_underfill: bool = False):
        q = self.table[q_idx.long()] if q_rows is None else q_rows  # [B, D]
        if self._ivf:
            return self._probe_topk(q, q_idx, k, exclude_self=exclude_self,
                                    nprobe=nprobe, drop=drop,
                                    allow_underfill=allow_underfill)
        if self._mixed:
            sd, sidx = self._scan_lane(q, q_idx, self._k_scan(
                k, self.num_nodes), exclude_self, drop)
            return self._rescore(q, sidx, sd, k)
        if (self._fused and drop is None
                and fused_kernel.supports(self.spec, k=k, dim=self.dim)):
            d, i = fused_kernel.scan_topk(
                self.table, q, q_idx, 0, spec=self.spec, k=k,
                n=self.num_nodes, exclude_self=exclude_self)
            return i, d
        d, i = self._two_stage(lambda s: _tile_dist(
            self.spec, q, self.table[s:s + self.chunk_rows]), q_idx, k,
            exclude_self, drop)
        return i, d

    def _sync_for_span(self) -> None:
        """Wait for this thread's stream on the engine's device, only
        when a span stage is recording (the measurement mode)."""
        if spans.active() and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _two_stage(self, dist_of, q_idx: torch.Tensor, k: int,
                   exclude_self: bool, drop=None):
        """The chunked slab scan: ``dist_of(s)`` gives the [B, chunk]
        distances of the chunk at row ``s``; zero-padding rows and,
        under ``exclude_self``, each query's own row are masked, and
        ``drop``'s slice of the chunk is added."""
        def tiles():
            for s in range(0, self.table.shape[0], self.chunk_rows):
                d = dist_of(s)
                cols = self._cols[s:s + self.chunk_rows]
                if s + self.chunk_rows > self.num_nodes:   # zero padding
                    d.masked_fill_((cols >= self.num_nodes)[None, :],
                                   float("inf"))
                if exclude_self:
                    d.masked_fill_(cols[None, :] == q_idx[:, None],
                                   float("inf"))
                if drop is not None:
                    d = d + drop[s:s + self.chunk_rows].to(d.dtype)[None, :]
                yield d, cols[None, :].expand(d.shape[0], -1)

        return _two_stage_core(tiles(), k)

    def _lane_query(self, q: torch.Tensor) -> torch.Tensor:
        """The queries as the lane scans them: cast to bf16 for the bf16
        copy, the f32 master rows otherwise (the table is quantized, not
        the queries)."""
        return q.to(torch.bfloat16) if self.precision == "bf16" else q

    def _widened(self, ids) -> torch.Tensor:
        """Rows of the lane's copy (a slice or a gather) widened to f32
        as the scans widen them; the bf16 copy stays bf16."""
        from hyperspace_torch.serve.quant import dequantize_torch

        rows = self.scan_table[ids]
        if self.scan_scale is None:             # the f32 and bf16 copies
            return rows
        return dequantize_torch(rows, self.scan_scale[ids],
                                packed=self.precision == "int4",
                                dim=self.dim)

    def _scan_lane(self, q: torch.Tensor, q_idx: torch.Tensor, k_scan: int,
                   exclude_self: bool, drop=None):
        """The exact coarse scan of the lane's copy → ``(dists, ids)``:
        ``scan_topk`` (``scan_topk_pq`` for PQ) under ``fused``, else
        (and under a ``drop`` mask) the two-stage walk over widened
        chunks."""
        if self._pq:
            return self._scan_pq(q, q_idx, k_scan, exclude_self, drop)
        qs = self._lane_query(q)
        if self._fused and drop is None and fused_kernel.supports(
                self.spec, k=k_scan, dim=self.dim, lane=self.precision):
            return fused_kernel.scan_topk(
                self.scan_table, qs, q_idx, 0, spec=self.spec, k=k_scan,
                n=self.num_nodes, exclude_self=exclude_self,
                scale=self.scan_scale, packed=self.precision == "int4")
        return self._two_stage(lambda s: _tile_dist(
            self.spec, qs, self._widened(slice(s, s + self.chunk_rows))),
            q_idx, k_scan, exclude_self, drop)

    def _scan_pq(self, q: torch.Tensor, q_idx: torch.Tensor, k_scan: int,
                 exclude_self: bool, drop=None):
        """The exact PQ coarse scan: ``scan_topk_pq`` under ``fused``,
        else the two-stage walk decoding each chunk to the lift."""
        from hyperspace_torch.serve.index import _lift

        q_lift = _lift(self.spec, q).to(torch.float32)
        if self._fused and drop is None and fused_kernel.supports_pq(
                self.spec, k=k_scan, m=self._pq_m):
            lut = fused_kernel.pq_lut(q_lift, self.pq_codebooks,
                                      kind=self.spec[0])
            return fused_kernel.scan_topk_pq(
                self.scan_table, lut, q_idx, 0, spec=self.spec, k=k_scan,
                n=self.num_nodes, exclude_self=exclude_self)
        return self._two_stage(lambda s: _pq_lift_dist(
            self.spec, q_lift, _pq_decode_rows(
                self.pq_codebooks, self.scan_table[s:s + self.chunk_rows],
                self._lift_dim)), q_idx, k_scan, exclude_self, drop)

    def _rescore(self, q: torch.Tensor, sidx: torch.Tensor,
                 sd: torch.Tensor, k: int):
        """The coarse candidates rescored against the f32 master table,
        then the final ranking → ``(ids, dists)``."""
        rows = self.table[torch.clamp_min(sidx, 0).long()]  # [B, K, D]
        return _merge_rescored(_rescore_f32(self.spec, rows, q, sidx, sd),
                               sidx, k)

    def _probe_topk(self, q: torch.Tensor, q_idx: torch.Tensor, k: int, *,
                    exclude_self: bool, nprobe: Optional[int], drop=None,
                    allow_underfill: bool = False):
        """The probing path: validate the width and the capacity, run
        :meth:`_topk_ivf`, and raise when some query's probed cells held
        fewer than ``k`` reachable rows (filler is not an answer), unless
        ``allow_underfill``."""
        p = self.nprobe if nprobe is None else int(nprobe)
        if not 1 <= p <= self.nprobe:
            raise ValueError(
                f"nprobe override {p} out of range [1, {self.nprobe}] "
                "(wider than configured would gather rows the resident "
                "chunking was not sized for)")
        capacity = p * self.index.max_cell
        if capacity < k:
            raise ValueError(
                f"k={k} exceeds the probe capacity nprobe×max_cell = "
                f"{p}×{self.index.max_cell} = {capacity}; raise nprobe=")
        k_scan = self._k_scan(k, capacity) if self._mixed else k
        idx, dist = self._topk_ivf(q, q_idx, k, k_scan, p, exclude_self,
                                   drop)
        if not allow_underfill and bool(torch.isinf(dist).any()):
            raise ValueError(
                f"IVF probe under-filled: some query's {p} "
                f"nearest cell(s) hold fewer than k={k} reachable rows "
                "(sparse/empty cells, or exclude_self masking one) — "
                "raise nprobe= or rebuild the index with more balance")
        return idx, dist

    def _topk_ivf(self, q: torch.Tensor, q_idx: torch.Tensor, k: int,
                  k_scan: int, nprobe: int, exclude_self: bool, drop=None):
        """Centroid scoring (f32 ``pdist``, or the manifold's distance)
        → the nearest ``nprobe`` cells' row ids, nearest cell first →
        the candidate scan (+ the lane's rescore) → ``(ids, dists)``.
        The cells partition the table, so a candidate appears at most
        once."""
        dc = _tile_dist(self.spec, q, self._centroids)     # [B, ncells]
        # the nearest cells, ties to the lower cell (lax.top_k's rule)
        cell_sel = torch.sort(dc, dim=1, stable=True)[1][:, :nprobe]
        cand = self._cells[cell_sel].reshape(q.shape[0], -1)
        sd, sidx = self._scan_topk_cand(q, cand, q_idx, k_scan,
                                        exclude_self, drop)
        if self._mixed:
            return self._rescore(q, sidx, sd, k)
        return sidx, sd

    def _scan_topk_cand(self, q: torch.Tensor, cand: torch.Tensor,
                        q_idx: torch.Tensor, k: int, exclude_self: bool,
                        drop=None):
        """Top-k over each query's own candidates ``cand`` [B, C] (-1 =
        padding) → ``(dists, table ids)`` [B, min(k, C)]: the
        ``scan_topk_cand`` kernel under ``fused`` (the f32, bf16 and int8
        copies), else (and under a ``drop`` mask, added per gathered id)
        chunked gathers, widened to f32, and plain distances (PQ codes
        decode to the lift)."""
        ctot = cand.shape[1]
        ko = min(k, ctot)
        qs = self._lane_query(q)
        if (self._fused and not self._pq and drop is None
                and fused_kernel.supports_cand(self.spec, k=k, dim=self.dim,
                                               cand=ctot,
                                               lane=self.precision)):
            d, i = fused_kernel.scan_topk_cand(
                self.scan_table, cand, qs, q_idx, spec=self.spec, k=k,
                exclude_self=exclude_self, scale=self.scan_scale)
            return d[:, :ko], i[:, :ko]
        q_lift = None
        if self._pq:
            from hyperspace_torch.serve.index import _lift

            q_lift = _lift(self.spec, q).to(torch.float32)
        chunk = self._cand_chunk

        def tiles():
            for s in range(0, ctot, chunk):
                ids = cand[:, s:s + chunk]
                safe = torch.clamp_min(ids, 0).long()
                if self._pq:
                    d = _pq_lift_dist(self.spec, q_lift, _pq_decode_rows(
                        self.pq_codebooks, self.scan_table[safe],
                        self._lift_dim))
                else:
                    d = _cand_dist(self.spec, qs.float(),
                                   self._widened(safe).float())
                if drop is not None:
                    d = d + drop[safe].to(d.dtype)
                mask = ids < 0
                if exclude_self:
                    mask = mask | (ids == q_idx[:, None])
                yield d.masked_fill(mask, float("inf")), ids

        return _two_stage_core(tiles(), ko)

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
        with spans.stage("device_compute",
                         metric="serve/stage/device_compute_ms"):
            d = self.manifold.dist(self.table[u_idx], self.table[v_idx])
            out = _fermi_dirac(d, fd_r, fd_t) if prob else d
            self._sync_for_span()
        return out

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

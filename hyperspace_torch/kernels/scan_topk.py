"""Streaming exact k-NN without a distance matrix (counterpart of
``hyperspace_tpu/kernels/scan_topk.py``).

``scan_topk`` launches the hand-written CUDA kernel ``csrc/scan_topk.cu``
for tensors on a CUDA device and runs :func:`scan_topk_plain` for
tensors on the CPU.  Both honour the JAX kernel's contract: ascending
float32 distances and int32 global ids ``col0 + local``; rows at global
id >= ``n`` are masked, as is each query's own row under
``exclude_self``; unreachable slots are ``(+inf, -1)``; ties go to the
lowest global column.

The slab's lanes (``serve/quant.py``): float32, bfloat16, int8 with a
float32 scale a row (``scale=``), and int4 packed two nibbles a byte
with an f16 scale a row (``packed=True``).  Each lane widens its rows
to float32 (``code · scale``) and scores them with the float32 lane's
arithmetic: results are those of the widened table, and only the
table's bytes shrink.  Queries are float32 or bfloat16 (widened).

The kernel picks its own shared-memory tile and splits the table over
enough blocks to fill the card, so the JAX module's VMEM footprint
model (``fused_tile_rows``) has no counterpart here.  A query's splits
share a threshold word (``_parts``), which the wrapper allocates
and fills; the kernel reads the slab where it lies, at any alignment,
and the wrapper copies nothing.

Two more entry points, each with its plain version and its kernel in
the same source:

- :func:`scan_topk_cand` — per-query candidate rows (the IVF probing
  scorer): each query scores its own gathered cells' table rows.  Ties
  go to the earlier position in the candidate list.  Lanes float32,
  bfloat16 and int8 (each candidate's scale read beside its row); the
  int4 lane has no candidate kernel, in JAX as here.
- :func:`scan_topk_pq` — ADC over a PQ-coded slab: per-query lookup
  tables (:func:`pq_lut`, plain PyTorch as in JAX) summed over the
  ``m`` subspace codes of each row in subspace order, then closed into
  a distance of the reconstructed row.
"""

from __future__ import annotations

import ctypes

import torch

from hyperspace_torch.kernels import _support as S
from hyperspace_torch.kernels.distmat import pdist_plain
from hyperspace_torch.manifolds import smath

# carry lanes cap, as in the JAX kernel: larger k uses the two-stage scan
FUSED_MAX_K = 256
# feature-lane cap: the kernel's tile of table rows must fit shared memory
FUSED_MAX_DIM = 1024
# PQ subspace cap: eight query warps' [m*256] f32 lookup tables must fit
# the block's shared memory
FUSED_MAX_PQ_M = 8
PQ_CENTERS = 256

_KINDS = ("poincare", "lorentz", "euclidean")
_WARPS_PER_SM = 32    # resident query warps per SM the split aims for
_MAX_SPLITS = 64      # csrc/scan_topk.cu MAX_SPLITS
_MIN_SPLIT_ROWS = 256
# csrc/scan_topk.cu MERGE_KEYS: the slab scans' split merge holds
# splits · k keys twice in one warp's shared memory
_MERGE_KEYS = 12800
_INF_BITS = 0x7F800000   # float32 +inf, the threshold words' start
# the candidate scan's splits: one wave of query warps at bucket 1,024
# on the H100's 132 SMs, where more splits were slower (PERF.md §6), and
# at least one position a lane a warp-split, which small buckets gain by
_CAND_WARPS_PER_SM = 7
_CAND_MIN_SPLIT = 32
_CAND_ROWS = 2           # csrc/scan_topk.cu CAND_ROWS: positions a lane a step
# the slab lanes, in csrc/scan_topk.cu's `Lane` order
_LANES = ("f32", "bf16", "int8", "int4")
_CAND_LANES = ("f32", "bf16", "int8")
_SMEM_BUDGET = 200 * 1024   # csrc/scan_topk.cu SMEM_BUDGET
_LANE_DQ_MAX = 16           # csrc/scan_topk.cu LANE_DQ_MAX


def _row_bytes(lane: str, dim: int) -> int:
    """Bytes of one slab row in a lane (csrc/scan_topk.cu row_bytes)."""
    return {"f32": 4 * dim, "bf16": 2 * dim, "int8": dim,
            "int4": (dim + 1) // 2}[lane]


def _lane_fits(lane: str, dim: int, k: int) -> bool:
    """Does the narrowest tile (32 rows) of a narrow lane fit the block's
    shared memory (csrc/scan_topk.cu dense_bytes)?  The float32 lane's
    limit is ``FUSED_MAX_DIM``."""
    if lane == "f32":
        return True
    sel = 8 * k * 8 + 8 * 32 * 20
    query = 8 * dim * 4 if dim > _LANE_DQ_MAX else 0
    raw = (32 * _row_bytes(lane, dim) + 31) // 16 * 16
    scale = (32 * {"int8": 4, "int4": 2}.get(lane, 0) + 31) // 16 * 16
    tile = 32 * (dim | 1) * 4
    return sel + query + tile + 2 * raw + 2 * scale <= _SMEM_BUDGET


def kind_supported(spec: tuple) -> bool:
    """Manifold families with an in-kernel closed distance form."""
    return spec[0] in _KINDS


def supports(spec: tuple, *, k: int, dim: int, lane: str = "f32") -> bool:
    """Can :func:`scan_topk` serve this (spec, k, dim) in ``lane``?
    The narrow lanes' byte buffers cap their width below
    ``FUSED_MAX_DIM`` (:func:`_lane_fits`)."""
    return (kind_supported(spec) and 1 <= int(k) <= FUSED_MAX_K
            and int(dim) <= FUSED_MAX_DIM
            and _lane_fits(lane, int(dim), int(k)))


def supports_pq(spec: tuple, *, k: int, m: int) -> bool:
    """Can :func:`scan_topk_pq` serve this (spec, k, m)?  Product specs
    never can: their distance is not additive over subspaces."""
    return (kind_supported(spec) and 1 <= int(k) <= FUSED_MAX_K
            and 1 <= int(m) <= FUSED_MAX_PQ_M)


def supports_cand(spec: tuple, *, k: int, dim: int, cand: int,
                  lane: str = "f32") -> bool:
    """Can :func:`scan_topk_cand` serve this shape in ``lane`` (float32,
    bf16 or int8; its rows are read from the table, so the lane's bytes
    set no limit)?  The float32 :func:`supports` rules; ``cand`` (the
    candidates a query) sets no limit.  The JAX
    module also caps the pre-gathered ``[B, C, 128-lane]`` candidate
    block its TPU kernel streams (``CAND_GATHER_BUDGET``, C <= 512 at
    D = 10); the CUDA kernel gathers each row by id from the table and
    builds no such block, so the cap has no counterpart.  Answers are
    rank-identical to the two-stage candidate scan either way."""
    del cand
    return lane in _CAND_LANES and supports(spec, k=k, dim=dim)


def _dist_plain(kind: str, c: float, q: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    if kind != "euclidean":
        return pdist_plain(q, rows, c, manifold=kind)
    d2 = (smath.sq_norm(q) - 2.0 * (q @ rows.T)
          + smath.sq_norm(rows)[:, 0][None, :])
    return smath.safe_sqrt(d2)


def _widen(rows: torch.Tensor, scale, packed: bool, dim: int):
    """A lane's rows widened to float32 (``serve/quant.py``); ``scale``
    [M] or [M, 1] for int8 and int4."""
    from hyperspace_torch.serve.quant import dequantize_torch

    if scale is not None:
        scale = scale.reshape(-1, 1)
    return dequantize_torch(rows, scale, packed=packed, dim=dim)


def scan_topk_plain(slab: torch.Tensor, q: torch.Tensor,
                    q_idx: torch.Tensor, col0: int, *, kind: str, c: float,
                    k: int, n: int, exclude_self: bool, scale=None,
                    packed: bool = False):
    """The slab widened to float32 (``serve/quant.py``), the full masked
    distance matrix, then a stable ascending sort — stable, so equal
    distances keep column order (``torch.topk`` is not stable on
    ties)."""
    b, m = q.shape[0], slab.shape[0]
    rows = _widen(slab, scale, packed, q.shape[1])
    d = _dist_plain(kind, c, q.to(torch.float32), rows)
    gcol = col0 + torch.arange(m, device=q.device, dtype=torch.int64)
    mask = (gcol >= n)[None, :].expand(b, m)
    if exclude_self:
        mask = mask | (gcol[None, :] == q_idx.to(torch.int64)[:, None])
    d = torch.where(mask, torch.full_like(d, float("inf")), d)
    if m < k:
        d = torch.cat([d, d.new_full((b, k - m), float("inf"))], dim=1)
        gcol = torch.cat([gcol, gcol.new_full((k - m,), -1)])
    dist, order = torch.sort(d, dim=1, stable=True)
    dist, ids = dist[:, :k], gcol[order[:, :k]]
    ids = torch.where(torch.isinf(dist), torch.full_like(ids, -1), ids)
    return dist, ids.to(torch.int32)


def _splits(b: int, m: int, device: torch.device, *,
            warps_per_sm: int = _WARPS_PER_SM,
            min_rows: int = _MIN_SPLIT_ROWS) -> int:
    """Table splits per query block, so that small batches still put
    about ``warps_per_sm`` query warps on every SM, each split at least
    ``min_rows`` rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    warps = -(-b // 8) * 8
    want = -(-sms * warps_per_sm // warps)
    return max(1, min(want, _MAX_SPLITS, m // min_rows))


def _slab_splits(b: int, m: int, k: int, device: torch.device,
                 **kw) -> int:
    """:func:`_splits` within the split merge's shared memory."""
    return max(1, min(_splits(b, m, device, **kw), _MERGE_KEYS // k))


def _parts(b: int, splits: int, k: int, device: torch.device):
    """Per-split lists ``[B, S, k]`` and the queries' threshold words
    (float32 +inf bits, lowered by the kernel) when the slab is split;
    three Nones otherwise."""
    if splits == 1:
        return None, None, None
    return (torch.empty((b, splits, k), dtype=torch.float32, device=device),
            torch.empty((b, splits, k), dtype=torch.int32, device=device),
            torch.full((b,), _INF_BITS, dtype=torch.int32, device=device))


def _ptr(t):
    return None if t is None else t.data_ptr()


_SLAB_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.int8, "int4": torch.uint8}
_SCALE_DTYPES = {"int8": torch.float32, "int4": torch.float16}


def _lane_of(slab: torch.Tensor, scale, packed: bool) -> str:
    if packed:
        return "int4"
    if scale is not None:
        return "int8"
    return "bf16" if slab.dtype == torch.bfloat16 else "f32"


def _check_lane(name: str, lane: str, rows: torch.Tensor, scale,
                q: torch.Tensor) -> torch.Tensor:
    """The kernel's dtypes for ``lane``; returns the float32 queries."""
    S.check_cuda(name, (_SLAB_DTYPES[lane],), rows)
    S.check_cuda(name, (torch.float32, torch.bfloat16), q)
    others = [q]
    if lane in _SCALE_DTYPES:
        S.check_cuda(name, (_SCALE_DTYPES[lane],), scale)
        if scale.numel() != rows.shape[0]:
            raise ValueError(f"{name}: scale has {scale.numel()} entries "
                             f"for {rows.shape[0]} rows")
        others.append(scale)
    for t in others:
        if t.device != rows.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{rows.device}")
    return q.to(torch.float32).contiguous()


def _launch(slab, q, q_idx, col0, *, kind, c, k, n, exclude_self, lane,
            scale):
    q = _check_lane("scan_topk", lane, slab, scale, q)
    if (q_idx.device != q.device or q_idx.dtype != torch.int32
            or not q_idx.is_contiguous()):
        raise ValueError("scan_topk: q_idx must be contiguous int32 on "
                         "the queries' device")
    b, dim = q.shape
    m = slab.shape[0]
    od = torch.empty((b, k), dtype=torch.float32, device=q.device)
    oi = torch.empty((b, k), dtype=torch.int32, device=q.device)
    splits = _slab_splits(b, m, k, q.device)
    pd, pi, thr = _parts(b, splits, k, q.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = S.function("scan_topk", "hs_scan_topk",
                    [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                     ctypes.c_float, I, I, I, P])
    S.check(fn(slab.data_ptr(), _ptr(scale), q.data_ptr(), q_idx.data_ptr(),
               _ptr(thr), _ptr(pd), _ptr(pi), od.data_ptr(), oi.data_ptr(),
               b, m, dim, k, int(col0), int(n), int(exclude_self), float(c),
               _KINDS.index(kind), _LANES.index(lane), splits,
               S.stream_ptr(q)), "scan_topk")
    scan_topk.launches += 1
    scan_topk.launches_by_lane[lane] += 1
    return od, oi


def scan_topk(slab: torch.Tensor, q: torch.Tensor, q_idx: torch.Tensor,
              col0: int, *, spec: tuple, k: int, n: int,
              exclude_self: bool = False, scale=None, packed: bool = False):
    """Streaming top-k of ``q`` [B, D] against the row block ``slab``
    [M, D] → ``(dists ascending float32 [B, k], ids int32 [B, k])``.

    ``ids`` are global column ids ``col0 + local``; rows at global id
    >= ``n`` are masked, as is each query's own row when
    ``exclude_self`` (by ``q_idx`` [B] int32).  Slots beyond the
    reachable candidates are ``(+inf, -1)``.  The slab's lane: float32
    or bfloat16 rows; int8 rows with ``scale`` ([M] or [M, 1] float32);
    ``packed=True``: int4 rows [M, ceil(D/2)] uint8 with ``scale`` ([M]
    or [M, 1] float16, required).  Callers gate shapes with
    :func:`supports`; unsupported ones raise here."""
    dim = q.shape[1]
    if packed:
        if scale is None:
            raise ValueError("scan_topk: packed=True (int4) requires scale=")
        if slab.ndim != 2 or slab.shape[1] != (dim + 1) // 2:
            raise ValueError(
                f"scan_topk: packed slab {tuple(slab.shape)} is not "
                f"[M, ceil({dim}/2)]")
    elif slab.ndim != 2 or slab.shape[1] != dim:
        raise ValueError(
            f"scan_topk: slab {tuple(slab.shape)} does not match query "
            f"dim {dim}")
    lane = _lane_of(slab, scale, packed)
    if not supports(spec, k=k, dim=dim, lane=lane):
        raise ValueError(
            f"scan_topk: unsupported (spec={spec[0]!r}, k={k}, dim={dim}, "
            f"lane={lane}) — gate on scan_topk.supports() and use the "
            "two-stage scan")
    kind = spec[0]
    c = 0.0 if kind == "euclidean" else float(spec[1])
    kw = dict(kind=kind, c=c, k=int(k), n=int(n),
              exclude_self=bool(exclude_self))
    if q.device.type == "cpu" and slab.device.type == "cpu":
        return scan_topk_plain(slab, q, q_idx, int(col0), scale=scale,
                               packed=packed, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"scan_topk: unsupported device {q.device}")
    return _launch(slab, q, q_idx, col0, lane=lane, scale=scale, **kw)


scan_topk.launches = 0
# launches of each lane: the smoke's lane runs read and reset them with
# ``launches``
scan_topk.launches_by_lane = dict.fromkeys(_LANES, 0)


# --- per-query candidate variant (the IVF probing scorer) --------------------


def _topk_of(d: torch.Tensor, ids: torch.Tensor, k: int):
    """Stable ascending top-k of masked distances ``d`` [B, C] with
    their ids [B, C]: equal distances keep their column order; slots
    past the candidates, and +inf ones, are ``(+inf, -1)``."""
    b, cc = d.shape
    if cc < k:
        d = torch.cat([d, d.new_full((b, k - cc), float("inf"))], dim=1)
        ids = torch.cat([ids, ids.new_full((b, k - cc), -1)], dim=1)
    dist, order = torch.sort(d, dim=1, stable=True)
    dist, out = dist[:, :k], torch.gather(ids, 1, order[:, :k])
    out = torch.where(torch.isinf(dist), torch.full_like(out, -1), out)
    return dist, out.to(torch.int32)


def _cand_dist_plain(kind: str, c: float, q: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """[B, D] queries × per-query rows [B, C, D] → [B, C]: the JAX
    kernel's ``_pair_dist_b`` closed forms (elementwise products summed
    over the lane axis)."""
    cc = torch.as_tensor(c, dtype=torch.float32, device=q.device)
    sc = torch.clamp_min(torch.sqrt(cc), 1e-12)
    if kind == "lorentz":
        y_flip = torch.cat([-rows[..., :1], rows[..., 1:]], dim=-1)
        gram = torch.sum(q[:, None, :] * y_flip, dim=-1)
        u = torch.clamp_min(-cc * gram - 1.0, 0.0)
        return smath.arcosh1p(u) / sc
    gram = torch.sum(q[:, None, :] * rows, dim=-1)
    xx = torch.sum(q * q, dim=-1, keepdim=True)
    yy = torch.sum(rows * rows, dim=-1)
    d2 = torch.clamp_min(xx - 2.0 * gram + yy, 0.0)
    if kind == "euclidean":
        return torch.sqrt(d2)
    den = torch.clamp_min((1.0 - cc * xx) * (1.0 - cc * yy), 1e-7)
    return smath.arcosh1p(2.0 * cc * d2 / den) / sc


def _cand_masked_dist(table: torch.Tensor, cand: torch.Tensor,
                      q: torch.Tensor, q_idx: torch.Tensor, *, kind: str,
                      c: float, exclude_self: bool,
                      scale=None) -> torch.Tensor:
    """[B, C] float32 distances of each query to its candidate rows
    (widened to float32, int8 rows by their gathered ``scale``), +inf at
    ``id < 0`` and (under ``exclude_self``) at ``id == q_idx``."""
    cand = cand.to(torch.int64)
    safe = torch.clamp_min(cand, 0)
    rows = _widen(table[safe].reshape(-1, table.shape[1]),
                  None if scale is None else scale.reshape(-1)[safe],
                  False, table.shape[1]).reshape(safe.shape + (-1,))
    d = _cand_dist_plain(kind, c, q.to(torch.float32), rows)
    mask = cand < 0
    if exclude_self:
        mask = mask | (cand == q_idx.to(torch.int64)[:, None])
    return torch.where(mask, torch.full_like(d, float("inf")), d)


def scan_topk_cand_plain(table: torch.Tensor, cand: torch.Tensor,
                         q: torch.Tensor, q_idx: torch.Tensor, *, kind: str,
                         c: float, k: int, exclude_self: bool, scale=None):
    """Gather every candidate row (widened to float32), the closed-form
    distances, mask ``id < 0`` and (under ``exclude_self``) ``id ==
    q_idx``, then a stable ascending sort over the candidate
    positions."""
    d = _cand_masked_dist(table, cand, q, q_idx, kind=kind, c=c,
                          exclude_self=exclude_self, scale=scale)
    return _topk_of(d, cand.to(torch.int64), k)


def _cand_splits(b: int, cc: int, k: int, device: torch.device) -> int:
    """:func:`_slab_splits` over candidate positions, with the candidate
    scan's constants."""
    return _slab_splits(b, cc, k, device, warps_per_sm=_CAND_WARPS_PER_SM,
                        min_rows=_CAND_MIN_SPLIT)


def _launch_cand(table, cand, q, q_idx, *, kind, c, k, exclude_self, lane,
                 scale):
    q = _check_lane("scan_topk_cand", lane, table, scale, q)
    S.check_cuda("scan_topk_cand", (torch.int32,), cand, q_idx)
    if cand.device != q.device or q_idx.device != q.device:
        raise ValueError("scan_topk_cand: tensors on different devices")
    b, dim = q.shape
    cc = cand.shape[1]
    od = torch.empty((b, k), dtype=torch.float32, device=q.device)
    oi = torch.empty((b, k), dtype=torch.int32, device=q.device)
    splits = _cand_splits(b, cc, k, q.device)
    pd, pi, thr = _parts(b, splits, k, q.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = S.function("scan_topk", "hs_scan_topk_cand",
                    [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                     ctypes.c_float, I, I, I, P])
    S.check(fn(table.data_ptr(), _ptr(scale), cand.data_ptr(), q.data_ptr(),
               q_idx.data_ptr(), _ptr(thr), _ptr(pd), _ptr(pi),
               od.data_ptr(), oi.data_ptr(), b, cc, table.shape[0], dim, k,
               int(exclude_self), float(c), _KINDS.index(kind),
               _LANES.index(lane), splits, S.stream_ptr(q)),
            "scan_topk_cand")
    scan_topk_cand.launches += 1
    scan_topk_cand.launches_by_lane[lane] += 1
    return od, oi


def scan_topk_cand(table: torch.Tensor, cand: torch.Tensor, q: torch.Tensor,
                   q_idx: torch.Tensor, *, spec: tuple, k: int,
                   exclude_self: bool = False, scale=None):
    """Per-query candidate top-k: ``cand`` [B, C] int32 row ids into
    ``table`` [N, D] (``-1`` = padding, anywhere in the list), ``q``
    [B, D] → ``(dists ascending float32 [B, k], table ids int32
    [B, k])``.  Padding and, under ``exclude_self``, each query's own
    row (``q_idx`` [B] int32) are masked; ties go to the earlier
    candidate position; slots beyond the reachable candidates are
    ``(+inf, -1)``.  The table's lane: float32 or bfloat16 rows, or int8
    rows with ``scale`` ([N] or [N, 1] float32), each candidate's scale
    read beside its row."""
    dim = q.shape[1]
    if table.ndim != 2 or table.shape[1] != dim or cand.ndim != 2 \
            or cand.shape[0] != q.shape[0]:
        raise ValueError(
            f"scan_topk_cand: want table [N, {dim}], cand [B, C] and q "
            f"[B, {dim}]; got {tuple(table.shape)}, {tuple(cand.shape)}, "
            f"{tuple(q.shape)}")
    lane = _lane_of(table, scale, False)
    if not supports_cand(spec, k=k, dim=dim, cand=cand.shape[1],
                         lane=lane):
        raise ValueError(
            f"scan_topk_cand: unsupported (spec={spec[0]!r}, k={k}, "
            f"dim={dim}) — gate on scan_topk.supports_cand() and use the "
            "two-stage candidate scan")
    kind = spec[0]
    c = 0.0 if kind == "euclidean" else float(spec[1])
    kw = dict(kind=kind, c=c, k=int(k), exclude_self=bool(exclude_self))
    if q.device.type == "cpu" and table.device.type == "cpu":
        return scan_topk_cand_plain(table, cand, q, q_idx, scale=scale, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"scan_topk_cand: unsupported device {q.device}")
    return _launch_cand(table, cand, q, q_idx, lane=lane, scale=scale, **kw)


scan_topk_cand.launches = 0
scan_topk_cand.launches_by_lane = dict.fromkeys(_CAND_LANES, 0)


# --- PQ slab variant (ADC over coded rows) -----------------------------------


def pq_lut(q_lift: torch.Tensor, codebooks: torch.Tensor, *,
           kind: str) -> torch.Tensor:
    """Per-query ADC lookup table [B, m*256] f32 from lifted queries
    [B, >=m*ds] and codebooks [m, 256, ds] (``serve/quant.py``).

    Lorentz-gram families: ``LUT[b, s*256+j] = <q_s ⊙ flip_s, cb[s, j]>``
    with the global time lane's sign folded into subspace 0, so the sum
    over subspaces is the Lorentz inner product of q with the
    reconstruction.  Euclidean: ``‖q_s − cb[s, j]‖²``, whose sum is the
    squared distance.  Plain PyTorch, as the JAX package computes it
    outside its kernel."""
    m, ncent, ds = codebooks.shape
    b = q_lift.shape[0]
    q_lift = q_lift.to(torch.float32)
    if q_lift.shape[1] < m * ds:
        # the codebooks' pad lanes are exactly zero, so zero query pad
        # lanes are exact no-ops
        q_lift = torch.cat([q_lift, q_lift.new_zeros(
            (b, m * ds - q_lift.shape[1]))], dim=1)
    qs = q_lift[:, :m * ds].reshape(b, m, ds)
    cb = codebooks.to(torch.float32)
    if kind == "euclidean":
        diff = qs[:, :, None, :] - cb[None]               # [B, m, 256, ds]
        lut = torch.sum(diff * diff, dim=-1)
    else:
        sign = torch.ones((m, ds), dtype=torch.float32, device=qs.device)
        sign[0, 0] = -1.0
        lut = torch.einsum("bmd,mjd->bmj", qs * sign[None], cb)
    return lut.reshape(b, m * ncent)


def _pq_dist_from_sum(kind: str, c: float, ssum: torch.Tensor):
    """Close the ADC sums into distances of the reconstructed rows,
    with the clamps of the JAX kernel's ``_pq_dist_from_sum``."""
    if kind == "euclidean":
        return torch.sqrt(torch.clamp_min(ssum, 0.0))
    cc = torch.as_tensor(c, dtype=torch.float32, device=ssum.device)
    u = torch.clamp_min(-cc * ssum - 1.0, 0.0)
    return smath.arcosh1p(u) / torch.clamp_min(torch.sqrt(cc), 1e-12)


def scan_topk_pq_plain(codes: torch.Tensor, lut: torch.Tensor,
                       q_idx: torch.Tensor, col0: int, *, kind: str,
                       c: float, k: int, n: int, exclude_self: bool):
    """The ADC sums added in subspace order ``s = 0…m−1`` (as the kernel
    adds them), closed into distances, masked by ``n`` and
    ``exclude_self``, then a stable ascending sort — the
    :func:`scan_topk` contract."""
    b, (mrows, m) = lut.shape[0], codes.shape
    cod = codes.to(torch.int64)
    ssum = lut[:, cod[:, 0]]
    for s in range(1, m):
        ssum = ssum + lut[:, s * PQ_CENTERS + cod[:, s]]
    d = _pq_dist_from_sum(kind, c, ssum)                   # [B, M]
    gcol = col0 + torch.arange(mrows, device=lut.device, dtype=torch.int64)
    mask = (gcol >= n)[None, :].expand(b, mrows)
    if exclude_self:
        mask = mask | (gcol[None, :] == q_idx.to(torch.int64)[:, None])
    d = torch.where(mask, torch.full_like(d, float("inf")), d)
    return _topk_of(d, gcol[None, :].expand(b, mrows), k)


def _launch_pq(codes, lut, q_idx, col0, *, kind, c, k, n, exclude_self):
    S.check_cuda("scan_topk_pq", (torch.uint8,), codes)
    S.check_cuda("scan_topk_pq", (torch.float32,), lut)
    S.check_cuda("scan_topk_pq", (torch.int32,), q_idx)
    if codes.device != lut.device or q_idx.device != lut.device:
        raise ValueError("scan_topk_pq: tensors on different devices")
    b = lut.shape[0]
    mrows, m = codes.shape
    od = torch.empty((b, k), dtype=torch.float32, device=lut.device)
    oi = torch.empty((b, k), dtype=torch.int32, device=lut.device)
    splits = _slab_splits(b, mrows, k, lut.device)
    pd, pi, thr = _parts(b, splits, k, lut.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = S.function("scan_topk", "hs_scan_topk_pq",
                    [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                     ctypes.c_float, I, I, P])
    S.check(fn(codes.data_ptr(), lut.data_ptr(), q_idx.data_ptr(),
               _ptr(thr), _ptr(pd), _ptr(pi), od.data_ptr(), oi.data_ptr(),
               b, mrows, m, k, int(col0), int(n), int(exclude_self),
               float(c), _KINDS.index(kind), splits, S.stream_ptr(lut)),
            "scan_topk_pq")
    scan_topk_pq.launches += 1
    return od, oi


def scan_topk_pq(codes: torch.Tensor, lut: torch.Tensor,
                 q_idx: torch.Tensor, col0: int, *, spec: tuple, k: int,
                 n: int, exclude_self: bool = False):
    """Streaming top-k over a PQ-coded slab by ADC: ``codes`` [M, m]
    uint8 subspace codes, ``lut`` [B, m*256] f32 (:func:`pq_lut`) → the
    :func:`scan_topk` output contract (global ids ``col0 + local``,
    masking by ``n`` and ``exclude_self``, ``(+inf, -1)`` beyond the
    reachable rows, ties to the lowest column).  Distances are those of
    the reconstructed rows: callers over-fetch and rescore in f32."""
    if codes.ndim != 2:
        raise ValueError(f"scan_topk_pq: codes must be [M, m]; got "
                         f"{tuple(codes.shape)}")
    m = int(codes.shape[1])
    if not supports_pq(spec, k=k, m=m):
        raise ValueError(
            f"scan_topk_pq: unsupported (spec={spec[0]!r}, k={k}, m={m}) "
            "— gate on scan_topk.supports_pq() and use the two-stage "
            "decode scan")
    if lut.ndim != 2 or lut.shape[1] != m * PQ_CENTERS:
        raise ValueError(
            f"scan_topk_pq: lut width {tuple(lut.shape)} != m*256 = "
            f"{m * PQ_CENTERS}")
    kind = spec[0]
    c = 0.0 if kind == "euclidean" else float(spec[1])
    kw = dict(kind=kind, c=c, k=int(k), n=int(n),
              exclude_self=bool(exclude_self))
    if lut.device.type == "cpu" and codes.device.type == "cpu":
        return scan_topk_pq_plain(codes, lut, q_idx, int(col0), **kw)
    if lut.device.type != "cuda":
        raise ValueError(f"scan_topk_pq: unsupported device {lut.device}")
    return _launch_pq(codes, lut, q_idx, col0, **kw)


scan_topk_pq.launches = 0

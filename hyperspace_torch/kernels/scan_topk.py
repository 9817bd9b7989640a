"""Streaming exact k-NN without a distance matrix (counterpart of
``hyperspace_tpu/kernels/scan_topk.py``, dense float32 lane).

``scan_topk`` launches the hand-written CUDA kernel ``csrc/scan_topk.cu``
for tensors on a CUDA device and runs :func:`scan_topk_plain` for
tensors on the CPU.  Both honour the JAX kernel's contract: ascending
float32 distances and int32 global ids ``col0 + local``; rows at global
id >= ``n`` are masked, as is each query's own row under
``exclude_self``; unreachable slots are ``(+inf, -1)``; ties go to the
lowest global column.

The kernel picks its own shared-memory tile and splits the table over
enough blocks to fill the card, so the JAX module's VMEM footprint
model (``fused_tile_rows``) has no counterpart here.
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

_KINDS = ("poincare", "lorentz", "euclidean")
_WARPS_PER_SM = 32    # resident query warps per SM the split aims for
_MAX_SPLITS = 64      # csrc/scan_topk.cu MAX_SPLITS
_MIN_SPLIT_ROWS = 256


def kind_supported(spec: tuple) -> bool:
    """Manifold families with an in-kernel closed distance form."""
    return spec[0] in _KINDS


def supports(spec: tuple, *, k: int, dim: int) -> bool:
    """Can :func:`scan_topk` serve this (spec, k, dim)?"""
    return (kind_supported(spec) and 1 <= int(k) <= FUSED_MAX_K
            and int(dim) <= FUSED_MAX_DIM)


def _dist_plain(kind: str, c: float, q: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    if kind != "euclidean":
        return pdist_plain(q, rows, c, manifold=kind)
    d2 = (smath.sq_norm(q) - 2.0 * (q @ rows.T)
          + smath.sq_norm(rows)[:, 0][None, :])
    return smath.safe_sqrt(d2)


def scan_topk_plain(slab: torch.Tensor, q: torch.Tensor,
                    q_idx: torch.Tensor, col0: int, *, kind: str, c: float,
                    k: int, n: int, exclude_self: bool):
    """The full masked distance matrix, then a stable ascending sort —
    stable, so equal distances keep column order (``torch.topk`` is not
    stable on ties)."""
    b, m = q.shape[0], slab.shape[0]
    d = _dist_plain(kind, c, q.to(torch.float32), slab.to(torch.float32))
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


def _splits(b: int, m: int, device: torch.device) -> int:
    """Table splits per query block, so that small batches still put
    about ``_WARPS_PER_SM`` query warps on every SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    warps = -(-b // 8) * 8
    want = -(-sms * _WARPS_PER_SM // warps)
    return max(1, min(want, _MAX_SPLITS, m // _MIN_SPLIT_ROWS))


def _launch(slab, q, q_idx, col0, *, kind, c, k, n, exclude_self):
    S.check_cuda_f32("scan_topk", slab, q)
    if (q_idx.device != q.device or q_idx.dtype != torch.int32
            or not q_idx.is_contiguous()):
        raise ValueError("scan_topk: q_idx must be contiguous int32 on "
                         "the queries' device")
    b, dim = q.shape
    m = slab.shape[0]
    od = torch.empty((b, k), dtype=torch.float32, device=q.device)
    oi = torch.empty((b, k), dtype=torch.int32, device=q.device)
    splits = _splits(b, m, q.device)
    pd = pi = None
    if splits > 1:
        pd = torch.empty((b, splits, k), dtype=torch.float32, device=q.device)
        pi = torch.empty((b, splits, k), dtype=torch.int32, device=q.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = S.function("scan_topk", "hs_scan_topk",
                    [P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                     ctypes.c_float, I, I, P])
    S.check(fn(slab.data_ptr(), q.data_ptr(), q_idx.data_ptr(),
               None if pd is None else pd.data_ptr(),
               None if pi is None else pi.data_ptr(),
               od.data_ptr(), oi.data_ptr(), b, m, dim, k, int(col0), int(n),
               int(exclude_self), float(c), _KINDS.index(kind), splits,
               S.stream_ptr(q)), "scan_topk")
    scan_topk.launches += 1
    return od, oi


def scan_topk(slab: torch.Tensor, q: torch.Tensor, q_idx: torch.Tensor,
              col0: int, *, spec: tuple, k: int, n: int,
              exclude_self: bool = False):
    """Streaming top-k of ``q`` [B, D] against the row block ``slab``
    [M, D] → ``(dists ascending float32 [B, k], ids int32 [B, k])``.

    ``ids`` are global column ids ``col0 + local``; rows at global id
    >= ``n`` are masked, as is each query's own row when
    ``exclude_self`` (by ``q_idx`` [B] int32).  Slots beyond the
    reachable candidates are ``(+inf, -1)``.  Callers gate shapes with
    :func:`supports`; unsupported ones raise here."""
    dim = q.shape[1]
    if slab.ndim != 2 or slab.shape[1] != dim:
        raise ValueError(
            f"scan_topk: slab {tuple(slab.shape)} does not match query "
            f"dim {dim}")
    if not supports(spec, k=k, dim=dim):
        raise ValueError(
            f"scan_topk: unsupported (spec={spec[0]!r}, k={k}, dim={dim})"
            " — gate on scan_topk.supports() and use the two-stage scan")
    kind = spec[0]
    c = 0.0 if kind == "euclidean" else float(spec[1])
    kw = dict(kind=kind, c=c, k=int(k), n=int(n),
              exclude_self=bool(exclude_self))
    if q.device.type == "cpu" and slab.device.type == "cpu":
        return scan_topk_plain(slab, q, q_idx, int(col0), **kw)
    if q.device.type != "cuda":
        raise ValueError(f"scan_topk: unsupported device {q.device}")
    return _launch(slab, q, q_idx, col0, **kw)


scan_topk.launches = 0

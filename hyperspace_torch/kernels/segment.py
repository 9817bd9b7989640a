"""Sorted segment reductions (counterpart of
``hyperspace_tpu/kernels/segment.py``).

- ``csr_segment_sum(values, receivers, plan, n)`` is
  ``out[r] = Σ_{e: receivers_e = r} values_e`` over receiver-sorted edges,
  accumulated in at least float32 and returned in the values' dtype;
- ``csr_segment_reduce_1d`` is the same walk over per-edge scalars, with
  ``sum`` or ``max``;
- ``csr_att_bwd_edges`` is the attention backward's fused edge pass.

For tensors on a CUDA device each launches its hand-written kernel in
``csrc/segment.cu``; for tensors on the CPU it runs its ``*_plain``
version.

The JAX kernel walks a host-built plan of (node block × edge chunk)
items; the CUDA kernels need none: each walks the sorted edges in
tiles or spans, a row owned by the block that holds its first edge
(``csrc/segment.cu``'s head).  The CUDA path takes rows of at most
:data:`MAX_CARD_F` columns.  :func:`build_csr_plan` is ported all the same, array-equal to
the JAX one, because the JAX function and the graph layout carry it;
the wrapper takes it and ignores it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from hyperspace_torch.kernels import _support as S

_BN = 128  # nodes per block of the JAX plan
_BK = 512  # edges per chunk of the JAX plan

CARD_DTYPES = (torch.bfloat16, torch.float32)
# the widest rows the CUDA kernels take: a block's two chunk buffers (one
# row each at this width) and the carried row's f32 sums (two of them) or a
# (d_num | d_den) row must fit its shared memory, 196 KB at f32
MAX_CARD_F = 12288


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class CsrPlan(NamedTuple):
    """Work-item schedule of the JAX kernel: three [T] int32 arrays."""

    block: np.ndarray  # item -> output node-block index
    chunk: np.ndarray  # item -> edge-chunk index
    first: np.ndarray  # 1 iff item is the first of its node block


def build_csr_plan(receivers: np.ndarray, num_nodes: int, bn: int = _BN,
                   bk: int = _BK) -> CsrPlan:
    """The (node-block × edge-chunk) work items for a sorted edge list,
    every block with at least one item and every chunk index in range."""
    r = np.asarray(receivers)
    if len(r) > 1 and not np.all(np.diff(r) >= 0):
        raise ValueError("build_csr_plan requires receiver-sorted edges")
    e_pad = round_up(max(len(r), 1), bk)
    nb = -(-num_nodes // bn)
    nchunks = e_pad // bk
    starts = np.searchsorted(r, np.arange(nb) * bn, side="left")
    ends = np.searchsorted(r, np.minimum(np.arange(1, nb + 1) * bn, num_nodes),
                           side="left")
    c0 = np.minimum(starts // bk, nchunks - 1)
    c1 = np.clip(-(-ends // bk), c0 + 1, nchunks)
    counts = c1 - c0
    t = int(counts.sum())
    block = np.repeat(np.arange(nb, dtype=np.int32), counts)
    chunk = (np.arange(t, dtype=np.int32)
             - np.repeat(np.cumsum(counts) - counts, counts)
             + np.repeat(c0, counts)).astype(np.int32)
    first = np.zeros(t, np.int32)
    first[np.cumsum(counts) - counts] = 1
    return CsrPlan(block=block, chunk=chunk.astype(np.int32), first=first)


def csr_segment_sum_plain(values: torch.Tensor, receivers: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """The same sum in plain PyTorch: accumulate in
    promote(values, float32), then cast to the values' dtype."""
    acc_dt = torch.promote_types(values.dtype, torch.float32)
    out = torch.zeros((num_segments, values.shape[1]), dtype=acc_dt,
                      device=values.device)
    out.index_add_(0, receivers, values.to(acc_dt))
    return out.to(values.dtype)


def _check_width(name: str, f: int) -> None:
    if f > MAX_CARD_F:
        raise ValueError(f"{name}: rows of {f} columns; the CUDA kernel "
                         f"takes at most {MAX_CARD_F}")


def _launch(values: torch.Tensor, receivers: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    S.check_cuda("csr_segment_sum", CARD_DTYPES, values)
    S.check_cuda("csr_segment_sum", (torch.int32,), receivers)
    if receivers.device != values.device:
        raise ValueError("csr_segment_sum: values and receivers on "
                         f"{values.device} and {receivers.device}")
    e, f = values.shape
    _check_width("csr_segment_sum", f)
    out = torch.empty((num_segments, f), dtype=values.dtype,
                      device=values.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = S.function("segment", "hs_csr_segment_sum",
                    [P, P, P, I, I, I, I, P])
    S.check(fn(values.data_ptr(), receivers.data_ptr(), out.data_ptr(), e, f,
               num_segments, int(values.dtype == torch.bfloat16),
               S.stream_ptr(values)), "csr_segment_sum")
    csr_segment_sum.launches += 1
    return out


def csr_segment_sum(values: torch.Tensor, receivers: torch.Tensor, plan,
                    num_segments: int) -> torch.Tensor:
    """``segment_sum(values, receivers)`` over receiver-sorted edges.

    ``values: [E, F]`` (zero on padding edges), ``receivers: [E]`` int32
    ascending in [0, num_segments) (padding edges point at the last
    node), ``plan`` the JAX kernel's :class:`CsrPlan` (accepted for the
    same signature, not needed here).  CUDA tensors (bf16 or f32,
    contiguous) go through ``csrc/segment.cu``; CPU tensors through
    :func:`csr_segment_sum_plain`."""
    del plan
    if values.ndim != 2 or receivers.ndim != 1 or (
            receivers.shape[0] != values.shape[0]):
        raise ValueError(f"csr_segment_sum: want [E, F] values and [E] "
                         f"receivers; got {tuple(values.shape)} and "
                         f"{tuple(receivers.shape)}")
    if values.device.type == "cpu" and receivers.device.type == "cpu":
        return csr_segment_sum_plain(values, receivers, num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"csr_segment_sum: unsupported device "
                         f"{values.device}")
    return _launch(values, receivers, num_segments)


csr_segment_sum.launches = 0


# --- per-edge scalar reductions ------------------------------------------------

NEG_FILL = -3.0e38  # the JAX kernel's max fill: an empty segment's max


def csr_segment_reduce_1d_plain(values: torch.Tensor, receivers: torch.Tensor,
                                num_segments: int,
                                op: str = "sum") -> torch.Tensor:
    """Per-segment ``sum`` or ``max`` in plain PyTorch, in
    promote(values, float32), returned in the values' dtype; a max starts
    from :data:`NEG_FILL`, as the JAX kernel does."""
    acc_dt = torch.promote_types(values.dtype, torch.float32)
    v = values.to(acc_dt)
    if op == "sum":
        out = torch.zeros(num_segments, dtype=acc_dt, device=values.device)
        out.index_add_(0, receivers, v)
    else:
        out = torch.full((num_segments,), NEG_FILL, dtype=acc_dt,
                         device=values.device)
        out.scatter_reduce_(0, receivers.long(), v, "amax")
    return out.to(values.dtype)


def csr_segment_reduce_1d(values: torch.Tensor, receivers: torch.Tensor, plan,
                          num_segments: int, op: str = "sum") -> torch.Tensor:
    """Per-segment scalar ``sum`` or ``max`` over receiver-sorted edges.

    ``values: [E]`` (0 on padding edges for a sum), ``receivers: [E]``
    int32 ascending, ``plan`` accepted for the JAX signature and not
    needed.  A max over no edge is :data:`NEG_FILL`.  CUDA tensors (f32
    values) go through ``csrc/segment.cu``; CPU tensors through
    :func:`csr_segment_reduce_1d_plain`."""
    del plan
    if op not in ("sum", "max"):
        raise ValueError(f"csr_segment_reduce_1d: op must be sum or max; "
                         f"got {op!r}")
    if values.ndim != 1 or receivers.shape != values.shape:
        raise ValueError(f"csr_segment_reduce_1d: want [E] values and [E] "
                         f"receivers; got {tuple(values.shape)} and "
                         f"{tuple(receivers.shape)}")
    if values.device.type == "cpu" and receivers.device.type == "cpu":
        return csr_segment_reduce_1d_plain(values, receivers, num_segments,
                                           op)
    if values.device.type != "cuda":
        raise ValueError(f"csr_segment_reduce_1d: unsupported device "
                         f"{values.device}")
    S.check_cuda("csr_segment_reduce_1d", (torch.float32,), values)
    S.check_cuda("csr_segment_reduce_1d", (torch.int32,), receivers)
    if receivers.device != values.device:
        raise ValueError("csr_segment_reduce_1d: values and receivers on "
                         f"{values.device} and {receivers.device}")
    out = torch.empty(num_segments, dtype=torch.float32,
                      device=values.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = S.function("segment", "hs_csr_segment_reduce_1d",
                    [P, P, P, I, I, I, P])
    S.check(fn(values.data_ptr(), receivers.data_ptr(), out.data_ptr(),
               values.shape[0], num_segments, int(op == "max"),
               S.stream_ptr(values)), "csr_segment_reduce_1d")
    csr_segment_reduce_1d.launches += 1
    return out


csr_segment_reduce_1d.launches = 0


# --- the attention backward's fused edge pass ----------------------------------


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once to x's dtype, as the kernels and JAX divide,
    on every device: the quotient is taken in float64 (a float32 quotient
    rounded from float64 is the correctly rounded one), since PyTorch's
    CUDA division by a Python number multiplies by its rounded reciprocal
    instead (an ulp apart, which ``1 − (x/c)²`` amplifies near |x| = c)."""
    x64 = x.to(torch.float64)
    return (x64 / torch.full_like(x64, c)).to(x.dtype)


def csr_att_bwd_edges_plain(dn_ext: torch.Tensor, h: torch.Tensor,
                            w: torch.Tensor, lm: torch.Tensor,
                            receivers: torch.Tensor, num_segments: int,
                            bound: float, negative_slope: float):
    """:func:`csr_att_bwd_edges` in plain PyTorch, in
    promote(dn_ext, float32)."""
    acc_dt = torch.promote_types(dn_ext.dtype, torch.float32)
    f = h.shape[1]
    dn = dn_ext.to(acc_dt)[receivers]
    dw = torch.sum(dn[:, :f] * h.to(acc_dt), dim=-1) + dn[:, f]
    lmf = lm.to(acc_dt)
    leaky = torch.where(lmf >= 0.0, torch.ones_like(lmf),
                        torch.full_like(lmf, negative_slope))
    dpre = dw * w.to(acc_dt) * (1.0 - true_div(lmf, bound) ** 2) * leaky
    dar = torch.zeros(num_segments, dtype=acc_dt, device=dn_ext.device)
    dar.index_add_(0, receivers, dpre)
    return dpre, dar


def csr_att_bwd_edges(dn_ext: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                      lm: torch.Tensor, receivers: torch.Tensor, plan,
                      num_segments: int, bound: float,
                      negative_slope: float):
    """The attention backward's edge pass over receiver-sorted edges:

        dw_e   = <d_num[r_e], h_e> + d_den[r_e]
        dpre_e = dw_e · w_e · (1 − (lm_e / bound)²) · (lm_e ≥ 0 ? 1 : slope)
        d_alpha_r[r] = Σ_{e: r_e = r} dpre_e

    ``dn_ext: [N, F+1]`` f32 (d_num | d_den), ``h: [E, F]`` the residual
    sender rows (bf16 or f32), ``w``/``lm: [E]`` f32 (the forward's
    masked weights and bounded logits; ``w`` is 0 on padding).  The JAX
    function takes ``h`` with a ones column appended (``[E, F+1]``) for
    the d_den term; here the kernel adds that term itself.  Returns
    ``(dpre [E], d_alpha_r [N])``, f32.  CUDA tensors go through
    ``csrc/segment.cu``; CPU tensors through
    :func:`csr_att_bwd_edges_plain`."""
    del plan
    e, f = h.shape if h.ndim == 2 else (-1, -1)
    if (dn_ext.ndim != 2 or dn_ext.shape[1] != f + 1 or f < 1
            or not (w.shape == lm.shape == receivers.shape == (e,))):
        raise ValueError(
            f"csr_att_bwd_edges: want [N, F+1] dn_ext, [E, F] h and [E] "
            f"w, lm, receivers; got {tuple(dn_ext.shape)}, "
            f"{tuple(h.shape)}, {tuple(w.shape)}, {tuple(lm.shape)}, "
            f"{tuple(receivers.shape)}")
    if dn_ext.device.type == "cpu" and receivers.device.type == "cpu":
        return csr_att_bwd_edges_plain(dn_ext, h, w, lm, receivers,
                                       num_segments, bound, negative_slope)
    if dn_ext.device.type != "cuda":
        raise ValueError(f"csr_att_bwd_edges: unsupported device "
                         f"{dn_ext.device}")
    S.check_cuda("csr_att_bwd_edges", (torch.float32,), dn_ext, w, lm)
    S.check_cuda("csr_att_bwd_edges", CARD_DTYPES, h)
    S.check_cuda("csr_att_bwd_edges", (torch.int32,), receivers)
    if len({dn_ext.device, h.device, w.device, lm.device,
            receivers.device}) != 1:
        raise ValueError("csr_att_bwd_edges: tensors on several devices")
    if dn_ext.shape[0] != num_segments:
        raise ValueError(f"csr_att_bwd_edges: dn_ext has "
                         f"{dn_ext.shape[0]} rows, want {num_segments}")
    _check_width("csr_att_bwd_edges", f)
    dev = dn_ext.device
    dpre = torch.empty(e, dtype=torch.float32, device=dev)
    dar = torch.empty(num_segments, dtype=torch.float32, device=dev)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = S.function("segment", "hs_csr_att_bwd_edges",
                    [P, P, P, P, P, P, P, I, I, I, I, F, F, P])
    S.check(fn(dn_ext.data_ptr(), h.data_ptr(), w.data_ptr(), lm.data_ptr(),
               receivers.data_ptr(), dpre.data_ptr(), dar.data_ptr(), e, f,
               num_segments,
               int(h.dtype == torch.bfloat16), bound, negative_slope,
               S.stream_ptr(dn_ext)), "csr_att_bwd_edges")
    csr_att_bwd_edges.launches += 1
    return dpre, dar


csr_att_bwd_edges.launches = 0

"""Sorted segment sum (counterpart of ``hyperspace_tpu/kernels/segment.py``).

``csr_segment_sum(values, receivers, plan, n)`` is
``out[r] = Σ_{e: receivers_e = r} values_e`` over receiver-sorted edges,
accumulated in at least float32 and returned in the values' dtype.  For
tensors on a CUDA device it launches the hand-written kernel
``csrc/segment.cu`` (bf16 or f32 values); for tensors on the CPU it runs
:func:`csr_segment_sum_plain`.

The JAX kernel walks a host-built plan of (node block × edge chunk)
items; the CUDA kernel needs none (a warp owns a receiver row and walks
its contiguous edge range).  :func:`build_csr_plan` is ported all the
same, array-equal to the JAX one, because the JAX function and the
graph layout carry it; the wrapper takes it and ignores it.
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


def _launch(values: torch.Tensor, receivers: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    S.check_cuda("csr_segment_sum", CARD_DTYPES, values)
    S.check_cuda("csr_segment_sum", (torch.int32,), receivers)
    if receivers.device != values.device:
        raise ValueError("csr_segment_sum: values and receivers on "
                         f"{values.device} and {receivers.device}")
    e, f = values.shape
    rowptr = torch.empty(num_segments + 1, dtype=torch.int32,
                         device=values.device)
    out = torch.empty((num_segments, f), dtype=values.dtype,
                      device=values.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = S.function("segment", "hs_csr_segment_sum",
                    [P, P, P, P, I, I, I, I, P])
    S.check(fn(values.data_ptr(), receivers.data_ptr(), rowptr.data_ptr(),
               out.data_ptr(), e, f, num_segments,
               int(values.dtype == torch.bfloat16), S.stream_ptr(values)),
            "csr_segment_sum")
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

"""Sorted symmetric segment aggregation, mean path (counterpart of
``hyperspace_tpu/nn/scatter.py``).

1. **Sorted both ways.**  The forward aggregation

       out[r] = Σ_e  w_e · h[senders_e]        (receivers sorted ascending)

   scatters by receiver.  Its gradient scatters by sender, which is not
   sorted — but on a symmetric edge list the involution π (``rev_perm``,
   senders = receivers∘π) re-indexes it into another receiver scatter:
   ``dh = segment_sum(w[π] · ḡ[senders], receivers)``.  Only the scalar
   weights are permuted, never an [E, D] tensor.

2. **Cluster pairs.**  On graphs with a cluster split, block-dense edges
   go through ``kernels.cluster.cluster_aggregate`` (no [E, D] messages)
   and the stragglers through the sorted segment sum; the backward runs
   the same two-path program on (ḡ, reverse-edge weights), since both
   subsets are closed under edge reversal.

Every sorted scatter is ``kernels.segment.csr_segment_sum``: the CUDA
kernel on the card, its plain version on the CPU.  Attention partials,
picks and the scalar planned reductions are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hyperspace_torch.kernels.cluster import cluster_aggregate
from hyperspace_torch.kernels.segment import csr_segment_sum


def _sorted_segsum(vals: torch.Tensor, receivers: torch.Tensor, plan,
                   num_segments: int) -> torch.Tensor:
    """Receiver-sorted segment sum, accumulated in ≥ float32 and cast to
    the values' dtype (the JAX helper's contract with or without a
    plan: the CUDA kernel needs none)."""
    return csr_segment_sum(vals.contiguous(), receivers, plan, num_segments)


class _SymSegmentAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, senders, receivers, rev_perm, plan, num_segments,
                with_dw):
        ctx.save_for_backward(h, w, senders, receivers, rev_perm)
        ctx.plan, ctx.num_segments, ctx.with_dw = plan, num_segments, with_dw
        return _sorted_segsum(w[:, None] * h[senders], receivers, plan,
                              num_segments)

    @staticmethod
    def backward(ctx, g):
        h, w, senders, receivers, rev_perm = ctx.saved_tensors
        g_s = g[senders]
        dh = _sorted_segsum(w[rev_perm][:, None] * g_s, receivers, ctx.plan,
                            ctx.num_segments)
        dw = (torch.sum(g[receivers] * h[senders], dim=-1)
              if ctx.with_dw and ctx.needs_input_grad[1] else None)
        return dh, dw, None, None, None, None, None, None


def sym_segment_aggregate(h: torch.Tensor, w: torch.Tensor,
                          senders: torch.Tensor, receivers: torch.Tensor,
                          rev_perm: torch.Tensor, plan, num_segments: int,
                          with_dw: bool = True) -> torch.Tensor:
    """out[r] = Σ_{e: receivers_e = r} w_e · h[senders_e], with the
    involution backward (module doc).  ``with_dw=False`` skips the
    weight gradient (static weights)."""
    return _SymSegmentAggregate.apply(h, w, senders, receivers, rev_perm,
                                      plan, num_segments, with_dw)


@dataclasses.dataclass
class ClusterAgg:
    """Device tensors of a host ``kernels.cluster.ClusterSplit``: the
    clustered edges with their forward/backward weights and plan, and the
    stragglers with theirs."""

    c_recv: torch.Tensor
    c_send: torch.Tensor
    c_wf: torch.Tensor
    c_wb: torch.Tensor
    c_plan: tuple
    s_recv: torch.Tensor
    s_send: torch.Tensor
    s_wf: torch.Tensor
    s_wb: torch.Tensor
    s_plan: tuple
    s_rev_local: Optional[torch.Tensor] = None
    s_mask: Optional[torch.Tensor] = None

    @classmethod
    def from_host(cls, split, device) -> "ClusterAgg":
        def dev(a):
            return None if a is None else torch.as_tensor(a, device=device)

        return cls(dev(split.c_recv), dev(split.c_send), dev(split.c_wf),
                   dev(split.c_wb), tuple(dev(a) for a in split.c_plan),
                   dev(split.s_recv), dev(split.s_send), dev(split.s_wf),
                   dev(split.s_wb), tuple(dev(a) for a in split.s_plan),
                   dev(split.s_rev_local), dev(split.s_mask))


def _cluster_two_path(h: torch.Tensor, wf_c: torch.Tensor, wf_s: torch.Tensor,
                      agg: ClusterAgg, num_segments: int) -> torch.Tensor:
    out = cluster_aggregate(h, wf_c, agg.c_recv, agg.c_send, agg.c_plan,
                            num_segments)
    msgs = wf_s.to(h.dtype)[:, None] * h[agg.s_send]
    return out + _sorted_segsum(msgs, agg.s_recv, agg.s_plan,
                                num_segments).to(out.dtype)


class _ClusterSymAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, agg, num_segments):
        ctx.agg, ctx.num_segments = agg, num_segments
        return _cluster_two_path(h.contiguous(), agg.c_wf, agg.s_wf, agg,
                                 num_segments)

    @staticmethod
    def backward(ctx, g):
        # dh[i] = Σ_{e: r_e = i} w_{π(e)} ḡ[s_e]: the same program on
        # (ḡ, reverse-edge weights)
        agg = ctx.agg
        dh = _cluster_two_path(g.contiguous(), agg.c_wb, agg.s_wb, agg,
                               ctx.num_segments)
        return dh, None, None


def cluster_sym_aggregate(h: torch.Tensor, agg: ClusterAgg,
                          num_segments: int) -> torch.Tensor:
    """Mean aggregation through the cluster kernel plus the straggler
    segment sum: out[r] = Σ_e w_e h[senders_e] with the precomputed 1/deg
    weights.  ``h`` is already in the aggregation dtype (bf16 messages
    halve the straggler traffic)."""
    return _ClusterSymAggregate.apply(h, agg, num_segments)

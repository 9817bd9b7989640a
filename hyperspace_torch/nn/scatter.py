"""Sorted symmetric segment aggregation and planned attention
(counterpart of ``hyperspace_tpu/nn/scatter.py``).

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

3. **Attention partials.**  The attention arm sums unnormalised
   ``[N, F+1]`` (num | den) partials over edge subsets and divides once
   (:func:`att_combine`): :func:`att_partial_planned` over a receiver-
   sorted edge list (one gather of ``[h | α_s]``, one segment sum of
   ``w·[h | 1]``; its backward reuses the gathered rows and runs the
   fused edge pass ``csr_att_bwd_edges``), and :func:`cluster_att_partial`
   over the clustered edges, whose weights and whole backward are
   computed inside ``kernels.cluster``'s attention kernels.

Every sorted scatter is ``kernels.segment.csr_segment_sum`` (scalars:
``csr_segment_reduce_1d``): the CUDA kernel on the card, its plain
version on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from hyperspace_torch.kernels.cluster import (ClusterRows, cluster_aggregate,
                                              cluster_att_bwd,
                                              cluster_att_fwd, rows_on)
from hyperspace_torch.kernels.segment import (csr_att_bwd_edges,
                                              csr_segment_reduce_1d,
                                              csr_segment_sum)
from hyperspace_torch.manifolds import smath


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


# --- per-edge scalar picks with planned-scatter backward passes --------------
#
# GAT logits α_s[s_e] + α_r[r_e] send a per-edge gradient back to per-node
# scalars: a scatter, routed through the sorted scalar reduction in both
# directions (the sender direction via the involution, s∘π = r).


class _PickSenders(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alpha, senders, receivers, rev_perm, plan,
                num_segments):
        ctx.save_for_backward(receivers, rev_perm)
        ctx.plan, ctx.num_segments = plan, num_segments
        return alpha[senders]

    @staticmethod
    def backward(ctx, g):
        receivers, rev_perm = ctx.saved_tensors
        d = csr_segment_reduce_1d(g[rev_perm], receivers, ctx.plan,
                                  ctx.num_segments, op="sum")
        return d, None, None, None, None, None


def pick_senders(alpha: torch.Tensor, senders: torch.Tensor,
                 receivers: torch.Tensor, rev_perm: torch.Tensor, plan,
                 num_segments: int) -> torch.Tensor:
    """alpha[senders] with a receiver-sorted planned-scatter backward."""
    return _PickSenders.apply(alpha, senders, receivers, rev_perm, plan,
                              num_segments)


class _PickReceivers(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alpha, receivers, plan, num_segments):
        ctx.save_for_backward(receivers)
        ctx.plan, ctx.num_segments = plan, num_segments
        return alpha[receivers]

    @staticmethod
    def backward(ctx, g):
        (receivers,) = ctx.saved_tensors
        d = csr_segment_reduce_1d(g.contiguous(), receivers, ctx.plan,
                                  ctx.num_segments, op="sum")
        return d, None, None, None


def pick_receivers(alpha: torch.Tensor, receivers: torch.Tensor, plan,
                   num_segments: int) -> torch.Tensor:
    """alpha[receivers] with a planned-scatter backward (receivers
    sorted)."""
    return _PickReceivers.apply(alpha, receivers, plan, num_segments)


class _PlannedSegmentSum1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, receivers, plan, num_segments):
        ctx.save_for_backward(receivers)
        return csr_segment_reduce_1d(vals.contiguous(), receivers, plan,
                                     num_segments, op="sum")

    @staticmethod
    def backward(ctx, g):
        (receivers,) = ctx.saved_tensors
        return g[receivers], None, None, None


def planned_segment_sum_1d(vals: torch.Tensor, receivers: torch.Tensor,
                           plan, num_segments: int) -> torch.Tensor:
    """Differentiable per-segment scalar sum: ``csr_segment_reduce_1d``
    forward, a row gather ``ḡ[receivers]`` backward."""
    return _PlannedSegmentSum1d.apply(vals, receivers, plan, num_segments)


class _PlannedSegmentMax1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, receivers, plan, num_segments):
        ctx.n_edges = receivers.shape[0]
        return csr_segment_reduce_1d(vals.contiguous(), receivers, plan,
                                     num_segments, op="max")

    @staticmethod
    def backward(ctx, g):
        return g.new_zeros(ctx.n_edges), None, None, None


def planned_segment_max_1d(vals: torch.Tensor, receivers: torch.Tensor,
                           plan, num_segments: int) -> torch.Tensor:
    """Per-segment scalar max whose gradient is zero by construction: its
    only use is a softmax's max shift, which the softmax does not depend
    on."""
    return _PlannedSegmentMax1d.apply(vals, receivers, plan, num_segments)


@dataclasses.dataclass
class ClusterAgg:
    """Device tensors of a host ``kernels.cluster.ClusterSplit``: the
    clustered edges with their forward/backward weights, plan and row
    plan (``c_rows``, built once per graph, which the CUDA kernels read;
    the edges then in its row order), and the stragglers with theirs
    (and, for attention, their involution and validity mask).
    ``use_att_cluster`` is the attention gate, set by :meth:`from_host`
    from the clustered fraction."""

    # the attention arm takes the in-tile cluster kernels only when at
    # least this share of the edges is clustered: the JAX package's gate
    # (below it the kernels' fixed cost outweighs the edges they take)
    ATT_MIN_FRAC: ClassVar[float] = 0.15

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
    c_rows: Optional[ClusterRows] = None
    use_att_cluster: bool = False

    @property
    def att_ok(self) -> bool:
        """Whether attention takes the in-tile cluster path: the straggler
        involution is present and the gate is open."""
        return self.s_rev_local is not None and self.use_att_cluster

    @classmethod
    def from_host(cls, split, device) -> "ClusterAgg":
        """With a row plan, the clustered edges and their weights go to
        the device in its row order (each row's edges in their order), so
        the kernels read the weights without the permutation."""
        def dev(a):
            return None if a is None else torch.as_tensor(a, device=device)

        c_edges = (split.c_recv, split.c_send, split.c_wf, split.c_wb)
        rows = split.c_rows
        if rows is not None:
            rows = rows_on(rows._replace(perm=None), device)
            c_edges = (rows.recv, rows.send, split.c_wf[split.c_rows.perm],
                       split.c_wb[split.c_rows.perm])
        return cls(*(dev(a) for a in c_edges),
                   tuple(dev(a) for a in split.c_plan),
                   dev(split.s_recv), dev(split.s_send), dev(split.s_wf),
                   dev(split.s_wb), tuple(dev(a) for a in split.s_plan),
                   dev(split.s_rev_local), dev(split.s_mask), c_rows=rows,
                   use_att_cluster=split.frac_clustered >= cls.ATT_MIN_FRAC)


def _cluster_two_path(h: torch.Tensor, wf_c: torch.Tensor, wf_s: torch.Tensor,
                      agg: ClusterAgg, num_segments: int) -> torch.Tensor:
    out = cluster_aggregate(h, wf_c, agg.c_recv, agg.c_send, agg.c_plan,
                            num_segments, rows=agg.c_rows)
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


# --- planned attention partials ---------------------------------------------------


class _AttPartialPlanned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, alpha_s, alpha_r, senders, receivers, rev_perm,
                edge_mask, plan, num_segments, agg_dtype, negative_slope):
        from hyperspace_torch.nn.gcn import bounded_att_logits

        f = h.shape[1]
        # α_s rides as an extra column: one gather serves both
        hs_a = torch.cat([h, alpha_s[:, None].to(h.dtype)], 1)[senders]
        h_s, a_se = hs_a[:, :f], hs_a[:, f]
        lm = bounded_att_logits(a_se + alpha_r[receivers], negative_slope)
        w = torch.where(edge_mask, torch.exp(lm), torch.zeros_like(lm))
        h_in = (h_s.contiguous() if agg_dtype is None
                else h_s.to(agg_dtype))
        w_in = w if agg_dtype is None else w.to(agg_dtype)
        # num and den in one segment sum: the messages carry a 1-column
        msgs = torch.cat([w_in[:, None] * h_in, w_in[:, None]], 1)
        nd = _sorted_segsum(msgs, receivers, plan, num_segments).to(
            torch.float32)
        ctx.save_for_backward(h_in, w_in, lm, senders, receivers, rev_perm,
                              edge_mask)
        ctx.plan, ctx.num_segments = plan, num_segments
        ctx.agg_dtype, ctx.negative_slope = agg_dtype, negative_slope
        ctx.dtypes = (h.dtype, alpha_s.dtype, alpha_r.dtype)
        return nd

    @staticmethod
    def backward(ctx, g):
        from hyperspace_torch.nn.gcn import ATT_LOGIT_BOUND

        h_in, w_in, lm, senders, receivers, rev_perm, edge_mask = (
            ctx.saved_tensors)
        plan, n = ctx.plan, ctx.num_segments
        h_dt, as_dt, ar_dt = ctx.dtypes
        f = h_in.shape[1]
        # the cotangent is the fused (d_num | d_den) block
        dn_ext = g.to(torch.float32).contiguous()
        dn_dt = (dn_ext if ctx.agg_dtype is None
                 else dn_ext.to(ctx.agg_dtype))
        # dh via the involution: the sender scatter becomes a receiver one
        dh = _sorted_segsum(w_in[rev_perm][:, None] * dn_dt[:, :f][senders],
                            receivers, plan, n).to(h_dt)
        # dw, the softmax chain and d_alpha_r in one fused edge pass over
        # the saved rows
        w_m = torch.where(edge_mask, w_in.to(torch.float32),
                          torch.zeros_like(lm, dtype=torch.float32))
        dpre, d_alpha_r = csr_att_bwd_edges(
            dn_ext, h_in, w_m, lm.to(torch.float32).contiguous(), receivers,
            plan, n, float(ATT_LOGIT_BOUND), ctx.negative_slope)
        d_alpha_s = csr_segment_reduce_1d(dpre[rev_perm], receivers, plan, n,
                                          op="sum")
        return (dh, d_alpha_s.to(as_dt), d_alpha_r.to(ar_dt), None, None,
                None, None, None, None, None, None)


def att_partial_planned(h: torch.Tensor, alpha_s: torch.Tensor,
                        alpha_r: torch.Tensor, senders: torch.Tensor,
                        receivers: torch.Tensor, rev_perm: torch.Tensor,
                        edge_mask: torch.Tensor, plan, num_segments: int,
                        agg_dtype, negative_slope: float) -> torch.Tensor:
    """Unnormalised attention partials on a receiver-sorted edge list:
    ``out[r] = Σ_e w_e·[h[s_e] | 1]`` (f32 ``[N, F+1]``) with
    ``w_e = exp(bounded_att_logits(α_s[s_e] + α_r[r_e]))``, 0 where
    ``edge_mask`` is False.  Messages go in ``agg_dtype`` (None keeps
    h's); the backward returns (dh, dα_s, dα_r) through the involution
    ``rev_perm`` (module doc)."""
    return _AttPartialPlanned.apply(h, alpha_s, alpha_r, senders, receivers,
                                    rev_perm, edge_mask, plan, num_segments,
                                    agg_dtype, negative_slope)


def att_combine(nd: torch.Tensor, out_dtype) -> torch.Tensor:
    """num / den of an ``[N, F+1]`` attention partial sum: the one
    division, after every edge subset's partial is added."""
    num, den = nd[:, :-1], smath.clamp_min(nd[:, -1], 1e-15)
    return (num / den[:, None]).to(out_dtype)


def att_aggregate_planned(h: torch.Tensor, alpha_s: torch.Tensor,
                          alpha_r: torch.Tensor, senders: torch.Tensor,
                          receivers: torch.Tensor, rev_perm: torch.Tensor,
                          edge_mask: torch.Tensor, plan, num_segments: int,
                          agg_dtype, negative_slope: float) -> torch.Tensor:
    """Softmax-attention neighbour aggregation on the planned layout:
    :func:`att_partial_planned` over the whole edge list, then
    :func:`att_combine`."""
    nd = att_partial_planned(h, alpha_s, alpha_r, senders, receivers,
                             rev_perm, edge_mask, plan, num_segments,
                             agg_dtype, negative_slope)
    return att_combine(nd, h.dtype)


class _ClusterAttPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, alpha_s, alpha_r, agg, num_segments, negative_slope):
        from hyperspace_torch.nn.gcn import ATT_LOGIT_BOUND

        h, alpha_s, alpha_r = (t.contiguous() for t in (h, alpha_s, alpha_r))
        ctx.save_for_backward(h, alpha_s, alpha_r)
        ctx.agg, ctx.num_segments = agg, num_segments
        ctx.negative_slope = negative_slope
        return cluster_att_fwd(h, alpha_s, alpha_r, agg.c_recv, agg.c_send,
                               agg.c_plan, num_segments, negative_slope,
                               float(ATT_LOGIT_BOUND), rows=agg.c_rows)

    @staticmethod
    def backward(ctx, g):
        from hyperspace_torch.nn.gcn import ATT_LOGIT_BOUND

        h, alpha_s, alpha_r = ctx.saved_tensors
        agg = ctx.agg
        dh, da_s, da_r = cluster_att_bwd(
            g.to(torch.float32).contiguous(), h, alpha_s, alpha_r,
            agg.c_recv, agg.c_send, agg.c_plan, ctx.num_segments,
            ctx.negative_slope, float(ATT_LOGIT_BOUND), rows=agg.c_rows)
        return (dh.to(h.dtype), da_s.to(alpha_s.dtype),
                da_r.to(alpha_r.dtype), None, None, None)


def cluster_att_partial(h: torch.Tensor, alpha_s: torch.Tensor,
                        alpha_r: torch.Tensor, agg: ClusterAgg,
                        num_segments: int,
                        negative_slope: float = 0.2) -> torch.Tensor:
    """``[N, F+1]`` f32 unnormalised attention partials over the
    clustered edges, the weights computed inside the kernel; the backward
    returns (dh in h's dtype, dα_s, dα_r).  Meant for ``agg.att_ok``."""
    return _ClusterAttPartial.apply(h, alpha_s, alpha_r, agg, num_segments,
                                    negative_slope)

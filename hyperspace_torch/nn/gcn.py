"""Hyperbolic graph convolution (counterpart of
``hyperspace_tpu/nn/gcn.py``, Chami et al. NeurIPS 2019).

Each layer: logmap to the origin tangent chart → one [N, d] linear map
→ neighbour aggregation → activation → expmap at the output curvature.

Mean aggregation takes the graph's cluster split when it has one
(``nn.scatter.cluster_sym_aggregate``), else the sorted involution
aggregation (``nn.scatter.sym_segment_aggregate``).  Attention
(``use_att``) weighs neighbours by a softmax of bounded GAT logits
``α_s[s] + α_r[r]``: with a CSR plan, through the fused planned partial
(``nn.scatter.att_partial_planned``) — on a cluster split whose gate is
open, the clustered edges through the in-tile kernels
(``nn.scatter.cluster_att_partial``) and the stragglers through the
planned partial, one division for both; without a plan, through
:func:`segment_softmax` and the involution aggregation.

With ``learn_c`` a layer's output curvature is learned: a scalar
parameter ``c_raw`` (initialised at ``log(expm1(c_out))``) gives
``c_out = softplus(c_raw)``, a 0-d tensor on the parameters' device that
every manifold call takes as it is (no host read), and the encoder hands
it on as the next layer's input curvature (``forward(..., c_in=)``).

Not ported yet (each raises ``NotImplementedError``): node-sharded
graphs, and graphs without the symmetric layout of
``data.graphs.prepare``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from hyperspace_torch.manifolds import Lorentz, smath
from hyperspace_torch.nn.scatter import (att_combine, att_partial_planned,
                                         cluster_att_partial,
                                         cluster_sym_aggregate,
                                         sym_segment_aggregate)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask: Optional[torch.Tensor] = None,
                    indices_are_sorted: bool = False) -> torch.Tensor:
    """Softmax of ``logits`` within each segment; masked entries get 0.
    Max-shifted, safe for empty segments.  The shift is held constant
    (the softmax does not depend on it), so no gradient flows through
    the maximum.  ``indices_are_sorted`` is accepted for the JAX
    signature."""
    del indices_are_sorted
    neg_inf = torch.full_like(logits, -torch.inf)
    if mask is not None:
        logits = torch.where(mask, logits, neg_inf)
    seg_max = torch.full((num_segments,), -torch.inf, dtype=logits.dtype,
                         device=logits.device).scatter_reduce_(
        0, segment_ids.long(), logits.detach(), "amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    ex = torch.exp(logits - seg_max[segment_ids])
    if mask is not None:
        ex = torch.where(mask, ex, torch.zeros_like(ex))
    denom = torch.zeros(num_segments, dtype=ex.dtype,
                        device=ex.device).index_add(0, segment_ids, ex)
    return ex / smath.clamp_min(denom[segment_ids], 1e-15)


ATT_LOGIT_BOUND = 30.0


def bounded_att_logits(pre: torch.Tensor,
                       negative_slope: float = 0.2) -> torch.Tensor:
    """leaky_relu, then the smooth ±30 squash ``B·tanh(·/B)``: ``exp`` of
    the result cannot overflow in f32 or bf16, so the attention softmax
    needs no max shift.  The leaky ReLU is a ``where`` on ``pre >= 0``,
    whose gradient at 0 is 1, as JAX's (``F.leaky_relu``'s is the
    slope)."""
    lm = torch.where(pre >= 0, pre, negative_slope * pre)
    return ATT_LOGIT_BOUND * torch.tanh(lm / ATT_LOGIT_BOUND)


def tangent0_coords(manifold, x: torch.Tensor) -> torch.Tensor:
    """Origin-tangent coordinates of logmap0(x) as a d-vector (the space
    part on the hyperboloid, whose origin tangents have time lane 0)."""
    v = manifold.logmap0(x)
    if isinstance(manifold, Lorentz):
        return v[..., 1:]
    return v


def from_tangent0_coords(manifold, v: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`tangent0_coords` followed by expmap0."""
    if isinstance(manifold, Lorentz):
        v = manifold.tangent_from_origin_coords(v)
    return manifold.expmap0(v)


def make_manifold(kind: str, c):
    if kind == "lorentz":
        return Lorentz(c)
    if kind in ("poincare", "euclidean"):
        raise NotImplementedError(
            f"HGCN on the {kind!r} manifold is not ported yet (lorentz is)")
    raise ValueError(f"unknown manifold kind {kind!r}")


def dropout(h: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with an explicit generator: keep each entry with
    probability 1 − rate and scale kept entries by 1 / (1 − rate)."""
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros_like(h))


class HGCConv(nn.Module):
    """One hyperbolic graph-conv layer: points on ``(kind, c_in)`` in,
    points on ``(kind, c_out)`` out.  ``kernel`` keeps the JAX layout
    ``(d_in, d_out)``, and so do the attention vectors ``att_src`` and
    ``att_dst`` ``(d_out, 1)`` (``use_att``); ``learn_c`` adds the scalar
    ``c_raw`` and makes ``c_out = softplus(c_raw)``."""

    def __init__(self, in_features: int, features: int, *,
                 kind: str = "lorentz", c_in: float = 1.0,
                 c_out: float = 1.0, learn_c: bool = False,
                 use_att: bool = False, use_bias: bool = True,
                 activation: Callable = torch.relu,
                 dropout_rate: float = 0.0,
                 agg_dtype: Optional[torch.dtype] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kind, self.c_in, self.c_out = kind, c_in, c_out
        self.c_raw = (nn.Parameter(torch.tensor(
            math.log(math.expm1(c_out)), dtype=dtype)) if learn_c else None)
        self.use_att = use_att
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.agg_dtype = agg_dtype
        # glorot uniform, as flax's default kernel init
        self.kernel = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty(in_features, features, dtype=dtype),
            generator=generator))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=dtype))
                     if use_bias else None)
        if use_att:
            self.att_src, self.att_dst = (
                nn.Parameter(nn.init.xavier_uniform_(
                    torch.empty(features, 1, dtype=dtype),
                    generator=generator)) for _ in range(2))

    def out_curvature(self):
        """``c_out``: ``softplus(c_raw)`` (a 0-d tensor) with ``learn_c``,
        else the number given."""
        if self.c_raw is None:
            return self.c_out
        return nn.functional.softplus(self.c_raw)

    def forward(self, x: torch.Tensor, g, *, c_in=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """``c_in`` overrides the input curvature given at construction
        (the encoder passes the previous layer's, learned or not)."""
        m_in = make_manifold(self.kind, self.c_in if c_in is None else c_in)
        m_out = make_manifold(self.kind, self.out_curvature())
        n = x.shape[0]
        h = tangent0_coords(m_in, x) @ self.kernel
        if self.bias is not None:
            h = h + self.bias
        if self.dropout_rate > 0.0 and not deterministic:
            h = dropout(h, self.dropout_rate, generator)
        if hasattr(g, "w_fwd"):
            raise NotImplementedError("node-sharded graphs are not ported yet")
        h_in = h if self.agg_dtype is None else h.to(self.agg_dtype)
        if self.use_att:
            agg = self._attend(h, h_in, g, n)
        elif g.cluster is not None:
            agg = cluster_sym_aggregate(h_in, g.cluster, n)
        else:
            if g.rev_perm is None or g.deg is None:
                raise NotImplementedError(
                    "aggregation needs the symmetric layout of "
                    "data.graphs.prepare (rev_perm and deg)")
            # mean aggregation: 1/deg, degree static per graph
            w = g.edge_mask.to(h.dtype) / smath.clamp_min(
                g.deg.to(h.dtype)[g.receivers], 1.0)
            w_in = w if self.agg_dtype is None else w.to(self.agg_dtype)
            agg = sym_segment_aggregate(h_in, w_in, g.senders, g.receivers,
                                        g.rev_perm, g.plan, n, with_dw=False)
        agg = agg.to(h.dtype)
        return from_tangent0_coords(m_out, self.activation(agg)), m_out

    def _attend(self, h: torch.Tensor, h_in: torch.Tensor, g, n: int):
        """GAT-style attention aggregation in the tangent chart."""
        if g.rev_perm is None:
            raise NotImplementedError(
                "attention needs the symmetric layout of data.graphs.prepare "
                "(rev_perm)")
        alpha_s = (h @ self.att_src)[:, 0]
        alpha_r = (h @ self.att_dst)[:, 0]
        if g.plan is None:
            logits = bounded_att_logits(alpha_s[g.senders]
                                        + alpha_r[g.receivers])
            w = segment_softmax(logits, g.receivers, n, mask=g.edge_mask,
                                indices_are_sorted=True)
            w_in = w if self.agg_dtype is None else w.to(self.agg_dtype)
            return sym_segment_aggregate(h_in, w_in, g.senders, g.receivers,
                                         g.rev_perm, g.plan, n, with_dw=True)
        cl = g.cluster
        if cl is not None and cl.att_ok:
            nd = cluster_att_partial(h_in, alpha_s, alpha_r, cl, n, 0.2)
            nd = nd + att_partial_planned(
                h, alpha_s, alpha_r, cl.s_send, cl.s_recv, cl.s_rev_local,
                cl.s_mask, cl.s_plan, n, self.agg_dtype, 0.2)
        else:
            nd = att_partial_planned(h, alpha_s, alpha_r, g.senders,
                                     g.receivers, g.rev_perm, g.edge_mask,
                                     g.plan, n, self.agg_dtype, 0.2)
        return att_combine(nd, h.dtype)

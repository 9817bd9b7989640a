"""Hyperbolic graph convolution, mean aggregation (counterpart of
``hyperspace_tpu/nn/gcn.py``, Chami et al. NeurIPS 2019).

Each layer: logmap to the origin tangent chart → one [N, d] linear map
→ neighbour mean aggregation → activation → expmap at the output
curvature.  The aggregation takes the graph's cluster split when it has
one (``nn.scatter.cluster_sym_aggregate``), else the sorted involution
aggregation (``nn.scatter.sym_segment_aggregate``).

Not ported yet (each raises ``NotImplementedError``): attention
(``use_att``), learned curvature (``learn_c``), node-sharded graphs, and
graphs without the symmetric layout of ``data.graphs.prepare``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from hyperspace_torch.manifolds import Lorentz, smath
from hyperspace_torch.nn.scatter import (cluster_sym_aggregate,
                                         sym_segment_aggregate)


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
    ``(d_in, d_out)``."""

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
        if learn_c:
            raise NotImplementedError("learn_c=True is not ported yet")
        if use_att:
            raise NotImplementedError("use_att=True is not ported yet")
        self.kind, self.c_in, self.c_out = kind, c_in, c_out
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.agg_dtype = agg_dtype
        # glorot uniform, as flax's default kernel init
        self.kernel = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty(in_features, features, dtype=dtype),
            generator=generator))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=dtype))
                     if use_bias else None)

    def forward(self, x: torch.Tensor, g, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        m_in = make_manifold(self.kind, self.c_in)
        m_out = make_manifold(self.kind, self.c_out)
        n = x.shape[0]
        h = tangent0_coords(m_in, x) @ self.kernel
        if self.bias is not None:
            h = h + self.bias
        if self.dropout_rate > 0.0 and not deterministic:
            h = dropout(h, self.dropout_rate, generator)
        if hasattr(g, "w_fwd"):
            raise NotImplementedError("node-sharded graphs are not ported yet")
        h_in = h if self.agg_dtype is None else h.to(self.agg_dtype)
        if g.cluster is not None:
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

"""Pair distances with planned gradient scatters (counterpart of
``hyperspace_tpu/nn/edge_dist.py``).

The LP decoder's backward scatters a gradient row per pair into the
[N, D] embedding.  These functions keep the math of
``manifold.sqdist`` (the backward re-runs its autograd on the gathered
rows) and reorganise only the scatter:

- :func:`pair_sqdist_planned` — static pairs with both columns sorted
  once on the host: both endpoint scatters are sorted segment sums.
- :func:`pair_sqdist_semi_planned` — static sorted u, fresh random v
  each step: the u side is a sorted segment sum, the v side a plain
  scatter (``index_add_``) into a ≥ float32 accumulator, as the JAX
  package leaves it to XLA.

Both return the values and gradients of ``m.sqdist(z[a], z[b])``.
``graph_edge_sqdist`` is not ported yet.
"""

from __future__ import annotations

import torch

from hyperspace_torch.nn.gcn import make_manifold
from hyperspace_torch.nn.scatter import _sorted_segsum


def _sqdist(kind: str, a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    return make_manifold(kind, c).sqdist(a, b)


def _pair_grads(kind, z, u, v, c, gbar):
    """(∂/∂a, ∂/∂b) of Σ gbar·sqdist(a, b) at a = z[u], b = z[v]."""
    with torch.enable_grad():
        a = z[u].detach().requires_grad_()
        b = z[v].detach().requires_grad_()
        return torch.autograd.grad(_sqdist(kind, a, b, c), (a, b), gbar)


class _PairSqdistPlanned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, c, u, v, u_plan, v_perm, v_sorted, v_plan, kind):
        ctx.save_for_backward(z, u, v, v_perm, v_sorted)
        ctx.c, ctx.u_plan, ctx.v_plan, ctx.kind = c, u_plan, v_plan, kind
        return _sqdist(kind, z[u], z[v], c)

    @staticmethod
    def backward(ctx, gbar):
        z, u, v, v_perm, v_sorted = ctx.saved_tensors
        gu, gv = _pair_grads(ctx.kind, z, u, v, ctx.c, gbar)
        n = z.shape[0]
        dz = _sorted_segsum(gu, u, ctx.u_plan, n)
        dz = dz + _sorted_segsum(gv[v_perm], v_sorted, ctx.v_plan, n)
        return (dz.to(z.dtype),) + (None,) * 8


def pair_sqdist_planned(z, c, u, v, u_plan, v_perm, v_sorted, v_plan,
                        kind: str = "lorentz") -> torch.Tensor:
    """sqdist(z[u_p], z[v_p]) with both gradient scatters sorted: ``u``
    ascending with its plan, ``v_perm`` the static argsort of ``v`` and
    ``v_sorted = v[v_perm]`` with its plan (``models.hgcn.
    make_planned_pairs`` builds them).  ``c`` gets no gradient."""
    return _PairSqdistPlanned.apply(z, c, u, v, u_plan, v_perm, v_sorted,
                                    v_plan, kind)


class _PairSqdistSemiPlanned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, c, u, v, u_plan, kind):
        ctx.save_for_backward(z, u, v)
        ctx.c, ctx.u_plan, ctx.kind = c, u_plan, kind
        return _sqdist(kind, z[u], z[v], c)

    @staticmethod
    def backward(ctx, gbar):
        z, u, v = ctx.saved_tensors
        gu, gv = _pair_grads(ctx.kind, z, u, v, ctx.c, gbar)
        n = z.shape[0]
        acc_dt = torch.promote_types(gv.dtype, torch.float32)
        dz = _sorted_segsum(gu, u, ctx.u_plan, n).to(acc_dt)
        dz = dz + torch.zeros((n, gv.shape[1]), dtype=acc_dt,
                              device=gv.device).index_add_(0, v,
                                                           gv.to(acc_dt))
        return (dz.to(z.dtype),) + (None,) * 5


def pair_sqdist_semi_planned(z, c, u, v, u_plan,
                             kind: str = "lorentz") -> torch.Tensor:
    """sqdist(z[u_p], z[v_p]) with the u-side gradient scatter sorted
    (``u`` ascending with its plan) and the v side scattered plainly
    (fresh random v each step).  ``c`` gets no gradient."""
    return _PairSqdistSemiPlanned.apply(z, c, u, v, u_plan, kind)

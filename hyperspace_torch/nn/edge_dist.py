"""Pair distances with planned gradient scatters (counterpart of
``hyperspace_tpu/nn/edge_dist.py``).

The LP decoder's backward scatters a gradient row per pair into the
[N, D] embedding.  These functions keep the math of
``manifold.sqdist`` (the backward re-runs its autograd on the gathered
rows) and reorganise only the scatter:

- :func:`graph_edge_sqdist` — distances along the training graph's own
  edge list (receiver-sorted, with the reverse-edge involution π of
  ``data.graphs.prepare``): by the distance's symmetry the sender-side
  cotangent of edge e lands at π(e) as the receiver-side one scaled by
  the permuted scalar, so only the [E] cotangent is permuted
  (``ḡ + ḡ[π]``) and both endpoint scatters are one sorted segment sum
  over the receivers.
- :func:`pair_sqdist_planned` — static pairs with both columns sorted
  once on the host: both endpoint scatters are sorted segment sums.
- :func:`pair_sqdist_semi_planned` — static sorted u, fresh random v
  each step: the u side is a sorted segment sum, the v side a plain
  scatter (``index_add_``) into a ≥ float32 accumulator, as the JAX
  package leaves it to XLA.

All three return the values and gradients of ``m.sqdist(z[a], z[b])``,
the curvature's too when ``c`` is a tensor that needs one (a learned
curvature), summed over the pairs with the original cotangent as JAX's
VJPs do.
"""

from __future__ import annotations

import torch

from hyperspace_torch.nn.gcn import make_manifold
from hyperspace_torch.nn.scatter import _sorted_segsum


def _sqdist(kind: str, a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    return make_manifold(kind, c).sqdist(a, b)


def _save_c(ctx, c) -> tuple:
    """Record ``c``: a tensor goes to the saved tensors (returned, to be
    appended to them), a number to ``ctx``."""
    ctx.c_is_tensor = isinstance(c, torch.Tensor)
    ctx.c = None if ctx.c_is_tensor else c
    return (c,) if ctx.c_is_tensor else ()


def _saved_c(ctx, saved, index: int):
    """(c for the backward's autograd, whether dc is wanted): a tensor
    detached, a leaf needing grad if the input ``index`` does."""
    if not ctx.c_is_tensor:
        return ctx.c, False
    want = bool(ctx.needs_input_grad[index])
    return saved[-1].detach().requires_grad_(want), want


def _pair_grads(kind, z, u, v, c, want_c, gbar):
    """(∂/∂a, ∂/∂b, ∂/∂c or None) of Σ gbar·sqdist(a, b) at a = z[u],
    b = z[v]."""
    with torch.enable_grad():
        a = z[u].detach().requires_grad_()
        b = z[v].detach().requires_grad_()
        grads = torch.autograd.grad(_sqdist(kind, a, b, c),
                                    (a, b, c) if want_c else (a, b), gbar)
    return grads[0], grads[1], grads[2] if want_c else None


class _GraphEdgeSqdist(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, c, senders, receivers, rev_perm, plan, kind):
        ctx.save_for_backward(z, senders, receivers, rev_perm,
                              *_save_c(ctx, c))
        ctx.plan, ctx.kind = plan, kind
        return _sqdist(kind, z[senders], z[receivers], c)

    @staticmethod
    def backward(ctx, gbar):
        saved = ctx.saved_tensors
        z, s, r, rp = saved[:4]
        c, want_c = _saved_c(ctx, saved, 1)
        zs, zr = z[s], z[r]
        with torch.enable_grad():
            b = zr.detach().requires_grad_()
            (gr_both,) = torch.autograd.grad(
                _sqdist(ctx.kind, zs, b, c.detach() if want_c else c), b,
                gbar + gbar[rp])
            # the curvature's cotangent takes the original ḡ (c is not
            # edge-indexed)
            dc = (torch.autograd.grad(_sqdist(ctx.kind, zs, zr, c), c,
                                      gbar)[0] if want_c else None)
        dz = _sorted_segsum(gr_both, r, ctx.plan, z.shape[0])
        return dz.to(z.dtype), dc, None, None, None, None, None


def graph_edge_sqdist(z, c, senders, receivers, rev_perm, plan,
                      kind: str = "lorentz") -> torch.Tensor:
    """sqdist(z[s_e], z[r_e]) for every edge e of a symmetric,
    receiver-sorted layout (``rev_perm`` its involution, ``plan`` its
    CSR plan or None), with one sorted segment sum in the backward."""
    return _GraphEdgeSqdist.apply(z, c, senders, receivers, rev_perm, plan,
                                  kind)


class _PairSqdistPlanned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, c, u, v, u_plan, v_perm, v_sorted, v_plan, kind):
        ctx.save_for_backward(z, u, v, v_perm, v_sorted, *_save_c(ctx, c))
        ctx.u_plan, ctx.v_plan, ctx.kind = u_plan, v_plan, kind
        return _sqdist(kind, z[u], z[v], c)

    @staticmethod
    def backward(ctx, gbar):
        saved = ctx.saved_tensors
        z, u, v, v_perm, v_sorted = saved[:5]
        c, want_c = _saved_c(ctx, saved, 1)
        gu, gv, dc = _pair_grads(ctx.kind, z, u, v, c, want_c, gbar)
        n = z.shape[0]
        dz = _sorted_segsum(gu, u, ctx.u_plan, n)
        dz = dz + _sorted_segsum(gv[v_perm], v_sorted, ctx.v_plan, n)
        return (dz.to(z.dtype), dc) + (None,) * 7


def pair_sqdist_planned(z, c, u, v, u_plan, v_perm, v_sorted, v_plan,
                        kind: str = "lorentz") -> torch.Tensor:
    """sqdist(z[u_p], z[v_p]) with both gradient scatters sorted: ``u``
    ascending with its plan, ``v_perm`` the static argsort of ``v`` and
    ``v_sorted = v[v_perm]`` with its plan (``models.hgcn.
    make_planned_pairs`` builds them)."""
    return _PairSqdistPlanned.apply(z, c, u, v, u_plan, v_perm, v_sorted,
                                    v_plan, kind)


class _PairSqdistSemiPlanned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, c, u, v, u_plan, kind):
        ctx.save_for_backward(z, u, v, *_save_c(ctx, c))
        ctx.u_plan, ctx.kind = u_plan, kind
        return _sqdist(kind, z[u], z[v], c)

    @staticmethod
    def backward(ctx, gbar):
        saved = ctx.saved_tensors
        z, u, v = saved[:3]
        c, want_c = _saved_c(ctx, saved, 1)
        gu, gv, dc = _pair_grads(ctx.kind, z, u, v, c, want_c, gbar)
        n = z.shape[0]
        acc_dt = torch.promote_types(gv.dtype, torch.float32)
        dz = _sorted_segsum(gu, u, ctx.u_plan, n).to(acc_dt)
        dz = dz + torch.zeros((n, gv.shape[1]), dtype=acc_dt,
                              device=gv.device).index_add_(0, v,
                                                           gv.to(acc_dt))
        return (dz.to(z.dtype), dc) + (None,) * 4


def pair_sqdist_semi_planned(z, c, u, v, u_plan,
                             kind: str = "lorentz") -> torch.Tensor:
    """sqdist(z[u_p], z[v_p]) with the u-side gradient scatter sorted
    (``u`` ascending with its plan) and the v side scattered plainly
    (fresh random v each step)."""
    return _PairSqdistSemiPlanned.apply(z, c, u, v, u_plan, kind)

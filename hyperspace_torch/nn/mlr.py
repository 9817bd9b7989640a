"""Hyperbolic multinomial logistic regression, the hyperbolic softmax head
(counterpart of ``hyperspace_tpu/nn/mlr.py``; Ganea et al. 2018 eq. 25).

    logit_k(x) = (λ_{p_k}‖a_k‖/√c) · asinh( 2√c⟨z_k, a_k⟩
                                            / ((1 − c‖z_k‖²)‖a_k‖) ),
    z_k = (−p_k) ⊕_c x .

:func:`hyp_mlr_logits` is the naive Möbius form, the oracle; the heads
call the fused ``kernels.mlr.hyp_mlr``.  Hyperplane points are stored as
origin tangents ``p_tangent`` (zeros at init) and mapped by ``expmap0``;
the normals ``a`` start Glorot-uniform.  :class:`LorentzMLR` maps
hyperboloid points to the isometric Poincaré ball first.  Either head's
``forward`` takes the curvature of the points it is given (``c=``, a
number or a 0-d tensor such as a learned one), else its manifold's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hyperspace_torch.kernels.mlr import hyp_mlr
from hyperspace_torch.manifolds import PoincareBall, smath
from hyperspace_torch.manifolds.maps import lorentz_to_ball
from hyperspace_torch.nn.layers import glorot_uniform


def hyp_mlr_logits(x: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
                   c) -> torch.Tensor:
    """Naive Möbius-form logits [..., K]: x [..., d] ball points, p [K, d]
    hyperplane points, a [K, d] normals.  Materialises z [..., K, d]."""
    ball = PoincareBall(c)
    cc = smath.as_scalar(c, x)          # a fill: a graph can capture it
    sc = smath.clamp_min(smath.safe_sqrt(cc), smath.min_norm(x.dtype))
    z = ball.mobius_add(-p, x[..., None, :])                  # [..., K, d]
    z2 = smath.sq_norm(z)[..., 0]
    za = torch.sum(z * a, dim=-1)
    a_norm = smath.clamp_min(smath.safe_norm(a, keepdim=False),
                             smath.min_norm(x.dtype))
    lam_p = ball.lambda_x(p, keepdim=False)
    denom = smath.clamp_min(1.0 - cc * z2, smath.eps_for(x.dtype)) * a_norm
    return (lam_p * a_norm / sc) * torch.asinh(2.0 * sc * za / denom)


class HypMLR(nn.Module):
    """Hyperbolic softmax head for ball points [..., d] → logits [..., K]."""

    def __init__(self, d: int, num_classes: int, manifold: PoincareBall, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.manifold = manifold
        self.p_tangent = nn.Parameter(torch.zeros((num_classes, d),
                                                  dtype=dtype))
        self.a = nn.Parameter(glorot_uniform((num_classes, d), generator,
                                             dtype))

    def forward(self, xb: torch.Tensor, c=None) -> torch.Tensor:
        ball = self.manifold if c is None else PoincareBall(c)
        p = ball.expmap0(self.p_tangent)
        return hyp_mlr(xb, p, self.a, ball.c)


class LorentzMLR(HypMLR):
    """Hyperbolic softmax head for hyperboloid points [..., d + 1]: the
    ball MLR of their stereographic image."""

    def __init__(self, d: int, num_classes: int, manifold, **kw):
        super().__init__(d, num_classes, PoincareBall(manifold.c), **kw)

    def forward(self, x: torch.Tensor, c=None) -> torch.Tensor:
        c = self.manifold.c if c is None else c
        return super().forward(lorentz_to_ball(x, c), c)

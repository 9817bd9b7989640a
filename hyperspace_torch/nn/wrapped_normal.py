"""Wrapped normal distribution on hyperbolic manifolds (counterpart of
``hyperspace_tpu/nn/wrapped_normal.py``; Nagano et al. 2019 on the
hyperboloid, Mathieu et al. 2019 on the ball).

Sampling (reparameterised, differentiable):

    v ~ N(0, scale)        in orthonormal coordinates of T_origin
    u = PT_{origin→μ}(v)   (parallel transport)
    z = exp_μ(u)

Density with respect to the Riemannian volume:

    log p(z) = log N(v; 0, scale) − logdetexp(μ, z),

v recovered from z by the inverse path.  Draws come from an explicit
``torch.Generator``; ``eps=`` hands in the standard-normal draw instead
(the tests inject JAX's draws there).  Every map is the manifold's plain
method, differentiable by autograd: the HVAE back-propagates through
``expmap``, ``ptransp0`` and ``logmap``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch


def _log_normal(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Diagonal-Gaussian log density, summed over the last axis."""
    var = scale ** 2
    return torch.sum(-0.5 * (v ** 2 / var + torch.log(2.0 * math.pi * var)),
                     dim=-1)


@dataclasses.dataclass
class WrappedNormal:
    """WrappedNormal(manifold, loc, scale): ``loc`` [..., D] a point on the
    manifold (D the ambient width), ``scale`` [..., d] positive standard
    deviations in origin-tangent coordinates (d the manifold dimension:
    D = d + 1 on the hyperboloid, D = d on the ball)."""

    manifold: Any
    loc: torch.Tensor
    scale: torch.Tensor

    @property
    def dim(self) -> int:
        return self.scale.shape[-1]

    def rsample(self, generator: Optional[torch.Generator] = None,
                sample_shape: tuple = (), *,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._rsample_with_coords(generator, sample_shape, eps=eps)[0]

    def _rsample_with_coords(self, generator=None, sample_shape: tuple = (),
                             *, eps: Optional[torch.Tensor] = None):
        """(z, v): the sample and its origin-chart coordinates.  ``eps``
        [*sample_shape, ..., d] replaces the standard-normal draw."""
        m = self.manifold
        shape = tuple(sample_shape) + tuple(self.scale.shape)
        if eps is None:
            eps = torch.randn(shape, generator=generator,
                              dtype=self.scale.dtype,
                              device=self.scale.device)
        elif tuple(eps.shape) != shape:
            raise ValueError(f"eps has shape {tuple(eps.shape)}; the draw "
                             f"is {shape}")
        v = self.scale * eps
        u0 = m.tangent_from_origin_coords(v)
        loc = self.loc.expand(tuple(sample_shape) + tuple(self.loc.shape))
        u = m.ptransp0(loc, u0)
        return m.expmap(loc, u), v   # expmap ends in proj on every manifold

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        """Log density with respect to the Riemannian volume; shape [...]."""
        m = self.manifold
        u = m.logmap(self.loc, z)
        u0 = m.ptransp(self.loc, m.origin(u.shape, u.dtype, u.device), u)
        v = m.origin_coords_from_tangent(u0)
        return _log_normal(v, self.scale) - m.logdetexp(self.loc, z)

    def sample_and_log_prob(self, generator=None, sample_shape: tuple = (),
                            *, eps: Optional[torch.Tensor] = None):
        """A sample and its density in one pass: the drawn coordinates v
        give the density directly (‖v‖ is the geodesic radius and the
        transport an isometry), with no logmap/ptransp inverse chain."""
        z, v = self._rsample_with_coords(generator, sample_shape, eps=eps)
        m = self.manifold
        lp = _log_normal(v, self.scale) - m.logdetexp_from_coords(v)
        return z, lp

"""Sphere of curvature +c (c > 0): the radius-1/√c sphere in R^d
(counterpart of ``hyperspace_tpu/manifolds/sphere.py``), a factor of the
mixed-curvature products of ``models/product_embed.py`` (Gu et al. 2019).

``c`` may be a Python number or a 0-dim tensor (a learned curvature:
gradients flow to it); every method takes it in the points' dtype and on
their device, as ``PoincareBall`` does, so a CUDA graph captures it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from hyperspace_torch.manifolds import smath
from hyperspace_torch.manifolds.base import Manifold


@dataclasses.dataclass(frozen=True)
class Sphere(Manifold):
    c: Any = 1.0
    name = "sphere"

    def _c(self, like: torch.Tensor) -> torch.Tensor:
        return smath.as_scalar(self.c, like)

    def proj(self, x: torch.Tensor) -> torch.Tensor:
        mn = smath.min_norm(x.dtype)
        r = 1.0 / smath.clamp_min(smath.sqrt_c(self.c, x), mn)
        n = smath.clamp_min(smath.safe_norm(x), mn)
        return x / n * r

    def proju(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        c = self._c(x)
        return u - c * torch.sum(x * u, dim=-1, keepdim=True) * x

    def check_point(self, x: torch.Tensor) -> torch.Tensor:
        c = self._c(x)
        return torch.abs(c * smath.sq_norm(x, keepdim=False) - 1.0)

    def dist(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        # the chord form 2/√c·arcsin(√c‖x−y‖/2): exact at coincident
        # points, where arccos(c⟨x,y⟩) is floored by its clamp
        sc = smath.sqrt_c(self.c, x)
        chord = smath.safe_norm(x - y, keepdim=False)
        return 2.0 / sc * smath.arcsin_safe(sc * chord / 2.0)

    def sqdist(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.dist(x, y) ** 2

    def expmap(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        t = smath.sqrt_c(self.c, x) * smath.safe_norm(v)
        return self.proj(torch.cos(t) * x + smath.sinc_(t) * v)

    def logmap(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        w = self.proju(x, y - x)
        wn = smath.clamp_min(smath.safe_norm(w), smath.min_norm(x.dtype))
        d = self.dist(x, y)[..., None]
        return d * w / wn

    def inner(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              keepdim: bool = False) -> torch.Tensor:
        return torch.sum(u * v, dim=-1, keepdim=keepdim)

    def ptransp(self, x: torch.Tensor, y: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        """Transport along the geodesic x → y (Gram–Schmidt form)."""
        logxy = self.logmap(x, y)
        logyx = self.logmap(y, x)
        d2 = smath.clamp_min(self.sqdist(x, y)[..., None],
                             smath.eps_for(x.dtype))
        return v - torch.sum(logxy * v, dim=-1, keepdim=True) / d2 * (
            logxy + logyx)

    def egrad2rgrad(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return self.proju(x, g)

    def origin(self, shape, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
        """(1/√c, 0, …, 0) broadcast to ``shape``, filled on the device."""
        o = torch.zeros(shape, dtype=dtype, device=device)
        o[..., 0] = 1.0 / smath.sqrt_c(self.c, o)
        return o

    def logdetexp(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """log |det d exp_x| = (d − 1)·log(sin(√c r)/(√c r)), r = dist, d
        the manifold dimension (ambient − 1): the positive-curvature twin
        of the hyperbolic sinhc form."""
        d = x.shape[-1] - 1
        r = self.dist(x, y)
        return (d - 1) * torch.log(smath.clamp_min(
            smath.sinc_(smath.sqrt_c(self.c, x) * r), smath.eps_for(x.dtype)))

    def logdetexp_from_coords(self, v: torch.Tensor) -> torch.Tensor:
        r = smath.safe_norm(v, keepdim=False)
        return (v.shape[-1] - 1) * torch.log(smath.clamp_min(
            smath.sinc_(smath.sqrt_c(self.c, v) * r), smath.eps_for(v.dtype)))

    # --- origin coordinate chart ---------------------------------------------
    # tangents at the origin (1/√c, 0, …) have first coordinate 0 and the
    # standard metric on the rest: pad or strip the first coordinate

    def coord_dim(self, ambient_dim: int) -> int:
        return ambient_dim - 1

    def tangent_from_origin_coords(self, v: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)

    def origin_coords_from_tangent(self, u: torch.Tensor) -> torch.Tensor:
        return u[..., 1:]

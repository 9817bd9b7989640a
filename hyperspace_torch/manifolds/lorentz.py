"""Lorentz (hyperboloid) model of curvature -c (c > 0) — counterpart of
``hyperspace_tpu/manifolds/lorentz.py``.

Points live on { x ∈ R^{d+1} : ⟨x,x⟩_L = -1/c, x_0 > 0 } with
⟨x,y⟩_L = -x_0 y_0 + Σ_{i≥1} x_i y_i; lane 0 is the time coordinate.
``Lorentz`` implements the whole :class:`Manifold` contract of JAX
``lorentz.py`` (projections, the relative constraint residual, metric,
transport, gradient conversion, exp/log, the origin chart and the
expmap Jacobian) plus ``centroid``.  ``c`` may be a Python number or a
tensor (which may require grad); every method works in float64, float32
and bfloat16, with ``c`` taken in the points' dtype as the JAX methods
take it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from hyperspace_torch.manifolds import smath
from hyperspace_torch.manifolds.base import Manifold


def minkowski_dot(x: torch.Tensor, y: torch.Tensor,
                  keepdim: bool = True) -> torch.Tensor:
    """⟨x, y⟩_L over the last axis."""
    res = (torch.sum(x[..., 1:] * y[..., 1:], dim=-1, keepdim=True)
           - x[..., :1] * y[..., :1])
    return res if keepdim else res[..., 0]


def _inv_c(c, dtype: torch.dtype):
    """1 / max(c, min_norm) in ``dtype``."""
    mn = smath.min_norm(dtype)
    if isinstance(c, torch.Tensor):
        return 1.0 / smath.clamp_min(c.to(dtype), mn)
    return float(1.0 / torch.clamp_min(torch.tensor(float(c), dtype=dtype),
                                       smath.scalar(mn, dtype)))


def with_time_coordinate(space: torch.Tensor, c) -> torch.Tensor:
    """Hyperboloid point from space coordinates: t = sqrt(1/c + ‖space‖²)."""
    t = smath.safe_sqrt(_inv_c(c, space.dtype) + smath.sq_norm(space))
    return torch.cat([t, space], dim=-1)


@dataclasses.dataclass(frozen=True)
class Lorentz(Manifold):
    c: Any = 1.0
    name = "lorentz"

    def ambient_dim(self, dim: int) -> int:
        return dim + 1

    # --- constraint / projections --------------------------------------------

    def proj(self, x: torch.Tensor) -> torch.Tensor:
        """Fix the time coordinate from the space coordinates."""
        return with_time_coordinate(x[..., 1:], self.c)

    def proju(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Tangent projection: u + c⟨x,u⟩_L x (⟨x,x⟩_L = -1/c)."""
        c = smath.curvature(self.c, x.dtype)
        return u + c * minkowski_dot(x, u) * x

    def check_point(self, x: torch.Tensor) -> torch.Tensor:
        """|⟨x,x⟩_L + 1/c| relative to 1/c + ‖x‖²: hyperboloid coordinates
        grow like e^dist, so the raw residual scales with ‖x‖²."""
        inv = 1.0 / smath.curvature(self.c, x.dtype)
        scale = inv + smath.sq_norm(x, keepdim=False)
        return torch.abs(minkowski_dot(x, x, keepdim=False) + inv) / scale

    def health_stats(self, x: torch.Tensor) -> dict:
        """The relative residual (max, mean) and the largest scaled time
        coordinate √c·x₀ = cosh(√c·dist0), how far out the sheet the
        batch reaches."""
        v = self.check_point(x)
        sc = smath.sqrt_curvature(self.c, x.dtype)
        return {"violation_max": torch.max(v), "violation_mean": torch.mean(v),
                "time_coord_max": torch.max(sc * x[..., 0])}

    def origin(self, shape, dtype, device) -> torch.Tensor:
        """(1/√c, 0, …, 0) broadcast to ``shape``.  A Python curvature is
        filled in on the device (an item assignment would copy a host
        scalar, which a CUDA graph cannot capture)."""
        t = 1.0 / smath.sqrt_curvature(self.c, dtype)
        out = torch.zeros(shape, dtype=dtype, device=device)
        if isinstance(t, torch.Tensor):
            out[..., 0] = t
        else:
            out.narrow(-1, 0, 1).fill_(smath.scalar(t, dtype))
        return out

    # --- distance ------------------------------------------------------------

    def dist(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """arcosh(1 + u)/√c with u = -c⟨x,y⟩_L - 1 (the stable form)."""
        c = smath.curvature(self.c, x.dtype)
        u = (-c * minkowski_dot(x, y) - 1.0)[..., 0]
        return smath.arcosh1p(u) / smath.sqrt_curvature(self.c, x.dtype)

    def sqdist(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.dist(x, y) ** 2

    # --- exp / log -----------------------------------------------------------

    def expmap(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """proj(cosh(t)·x + sinhc(t)·v), t = √c‖v‖_L."""
        sc = smath.sqrt_curvature(self.c, x.dtype)
        vn = smath.safe_sqrt(smath.clamp_min(minkowski_dot(v, v), 0.0))
        t = sc * vn
        return self.proj(smath.safe_cosh(t) * x + smath.sinhc(t) * v)

    def logmap(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """d(x,y) · w / ‖w‖_L with w = y + c⟨x,y⟩_L x (⟨x,w⟩_L = 0)."""
        c = smath.curvature(self.c, x.dtype)
        w = y + c * minkowski_dot(x, y) * x
        wn = smath.safe_sqrt(smath.clamp_min(minkowski_dot(w, w), 0.0))
        d = self.dist(x, y)[..., None]
        return d * w / smath.clamp_min(wn, smath.min_norm(x.dtype))

    # --- transport / metric --------------------------------------------------

    def inner(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              keepdim: bool = False) -> torch.Tensor:
        return minkowski_dot(u, v, keepdim=keepdim)

    def ptransp(self, x: torch.Tensor, y: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        """P_{x→y}(v) = v + c⟨y,v⟩_L / (1 - c⟨x,y⟩_L) (x + y)."""
        c = smath.curvature(self.c, x.dtype)
        num = c * minkowski_dot(y, v)
        den = smath.clamp_min(1.0 - c * minkowski_dot(x, y),
                              smath.eps_for(x.dtype))
        return v + num / den * (x + y)

    def egrad2rgrad(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """Flip the time lane (the Minkowski metric's inverse), then
        ``proju``."""
        return self.proju(x, torch.cat([-g[..., :1], g[..., 1:]], dim=-1))

    def logdetexp(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """(d−1)·log(sinh(√c r)/(√c r)) at r = dist(x, y), d = the
        manifold dimension (ambient − 1)."""
        sc = smath.sqrt_curvature(self.c, x.dtype)
        r = self.dist(x, y)
        return (x.shape[-1] - 2) * torch.log(smath.clamp_min(
            smath.sinhc(sc * r), smath.eps_for(x.dtype)))

    def logdetexp_from_coords(self, v: torch.Tensor) -> torch.Tensor:
        """The same from origin coordinates (the space part)."""
        sc = smath.sqrt_curvature(self.c, v.dtype)
        r = smath.safe_norm(v, keepdim=False)
        return (v.shape[-1] - 1) * torch.log(smath.clamp_min(
            smath.sinhc(sc * r), smath.eps_for(v.dtype)))

    # --- origin coordinate chart ---------------------------------------------
    # Tangents at the origin have time coordinate 0 and carry the standard
    # Euclidean metric on the space part, so the chart is pad/strip time.

    def coord_dim(self, ambient_dim: int) -> int:
        return ambient_dim - 1

    def tangent_from_origin_coords(self, v: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(v, (1, 0))

    def origin_coords_from_tangent(self, u: torch.Tensor) -> torch.Tensor:
        return u[..., 1:]

    # --- aggregation ---------------------------------------------------------

    def centroid(self, x: torch.Tensor,
                 w: torch.Tensor | None = None) -> torch.Tensor:
        """Lorentz centroid (Law et al. 2019) of x [..., n, d+1] under
        weights w [..., n] (uniform if None): s / (√c·√(-⟨s,s⟩_L)) with
        s = Σ w_i x_i."""
        s = torch.sum(x if w is None else w[..., None] * x, dim=-2)
        nrm = smath.safe_sqrt(smath.clamp_min(-minkowski_dot(s, s),
                                              smath.eps_for(x.dtype)))
        return s / (smath.sqrt_curvature(self.c, x.dtype) * nrm)

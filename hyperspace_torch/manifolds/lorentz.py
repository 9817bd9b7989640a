"""Lorentz (hyperboloid) model of curvature -c (c > 0) — counterpart of
``hyperspace_tpu/manifolds/lorentz.py``.

Points live on { x ∈ R^{d+1} : ⟨x,x⟩_L = -1/c, x_0 > 0 } with
⟨x,y⟩_L = -x_0 y_0 + Σ_{i≥1} x_i y_i; lane 0 is the time coordinate.
Ported: ``proj``, ``dist``/``sqdist``, ``expmap``/``logmap`` and their
origin forms, ``origin`` and the origin coordinate chart — what serving
and HGCN training use.  ``c`` may be a Python number or a tensor; every
method works in float64, float32 and bfloat16, with ``c`` taken in the
points' dtype as the JAX methods take it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from hyperspace_torch.manifolds import smath


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
class Lorentz:
    c: Any = 1.0
    name = "lorentz"

    def proj(self, x: torch.Tensor) -> torch.Tensor:
        """Fix the time coordinate from the space coordinates."""
        return with_time_coordinate(x[..., 1:], self.c)

    def origin(self, shape, dtype, device) -> torch.Tensor:
        """(1/√c, 0, …, 0) broadcast to ``shape``."""
        t = 1.0 / smath.sqrt_curvature(self.c, dtype)
        if not isinstance(t, torch.Tensor):
            t = smath.scalar(t, dtype)
        out = torch.zeros(shape, dtype=dtype, device=device)
        out[..., 0] = t
        return out

    # --- distance -------------------------------------------------------------

    def dist(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """arcosh(1 + u)/√c with u = -c⟨x,y⟩_L - 1 (the stable form)."""
        c = smath.curvature(self.c, x.dtype)
        u = (-c * minkowski_dot(x, y) - 1.0)[..., 0]
        return smath.arcosh1p(u) / smath.sqrt_curvature(self.c, x.dtype)

    def sqdist(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.dist(x, y) ** 2

    # --- exp / log ------------------------------------------------------------

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

    def expmap0(self, v: torch.Tensor) -> torch.Tensor:
        """Exponential map at the origin (tangent v has time lane 0)."""
        return self.expmap(self.origin(v.shape, v.dtype, v.device), v)

    def logmap0(self, y: torch.Tensor) -> torch.Tensor:
        """Logarithm map at the origin."""
        return self.logmap(self.origin(y.shape, y.dtype, y.device), y)

    # --- origin coordinate chart ---------------------------------------------
    # Tangents at the origin have time coordinate 0 and carry the standard
    # Euclidean metric on the space part, so the chart is pad/strip time.

    def tangent_from_origin_coords(self, v: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(v, (1, 0))

    def origin_coords_from_tangent(self, u: torch.Tensor) -> torch.Tensor:
        return u[..., 1:]

"""Lorentz (hyperboloid) model of curvature -c (c > 0) — counterpart of
``hyperspace_tpu/manifolds/lorentz.py``.

Points live on { x ∈ R^{d+1} : ⟨x,x⟩_L = -1/c, x_0 > 0 } with
⟨x,y⟩_L = -x_0 y_0 + Σ_{i≥1} x_i y_i; lane 0 is the time coordinate.
Only ``proj``, ``expmap0`` and ``dist`` are ported (the serving path).
"""

from __future__ import annotations

import dataclasses

import torch

from hyperspace_torch.manifolds import smath


def minkowski_dot(x: torch.Tensor, y: torch.Tensor,
                  keepdim: bool = True) -> torch.Tensor:
    """⟨x, y⟩_L over the last axis."""
    res = (torch.sum(x[..., 1:] * y[..., 1:], dim=-1, keepdim=True)
           - x[..., :1] * y[..., :1])
    return res if keepdim else res[..., 0]


def with_time_coordinate(space: torch.Tensor, c) -> torch.Tensor:
    """Hyperboloid point from space coordinates: t = sqrt(1/c + ‖space‖²)."""
    c = torch.as_tensor(c, dtype=space.dtype, device=space.device)
    t = smath.safe_sqrt(1.0 / smath.clamp_min(c, smath.min_norm(space.dtype))
                        + smath.sq_norm(space))
    return torch.cat([t, space], dim=-1)


@dataclasses.dataclass(frozen=True)
class Lorentz:
    c: float = 1.0
    name = "lorentz"

    def _c(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.c, dtype=like.dtype, device=like.device)

    def proj(self, x: torch.Tensor) -> torch.Tensor:
        """Fix the time coordinate from the space coordinates."""
        return with_time_coordinate(x[..., 1:], self.c)

    def origin(self, shape, dtype, device) -> torch.Tensor:
        out = torch.zeros(shape, dtype=dtype, device=device)
        out[..., 0] = 1.0 / float(self.c) ** 0.5
        return out

    def expmap0(self, v: torch.Tensor) -> torch.Tensor:
        """exp at the origin o for a tangent v (time lane 0):
        proj(cosh(t)·o + sinhc(t)·v), t = √c‖v‖_L."""
        sc = smath.sqrt_c(self.c, v)
        vn = smath.safe_sqrt(smath.clamp_min(minkowski_dot(v, v), 0.0))
        t = sc * vn
        o = self.origin(v.shape, v.dtype, v.device)
        return self.proj(smath.safe_cosh(t) * o + smath.sinhc(t) * v)

    def dist(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        c = self._c(x)
        u = (-c * minkowski_dot(x, y) - 1.0)[..., 0]
        return smath.arcosh1p(u) / smath.sqrt_c(c, x)

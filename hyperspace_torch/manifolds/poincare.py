"""Poincaré ball of curvature -c (c > 0) — counterpart of
``hyperspace_tpu/manifolds/poincare.py``.

Ported: ``proj``, ``expmap0``, ``mobius_add`` and ``dist`` (the edge
scorer's distance), and ``lambda_x`` (the MLR head's oracle).  The ball of
curvature -c is { x : c‖x‖² < 1 }.
"""

from __future__ import annotations

import dataclasses

import torch

from hyperspace_torch.manifolds import smath


@dataclasses.dataclass(frozen=True)
class PoincareBall:
    c: float = 1.0
    name = "poincare"

    def _c(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.c, dtype=like.dtype, device=like.device)

    def lambda_x(self, x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
        """Conformal factor 2 / (1 − c‖x‖²), the denominator clamped."""
        denom = smath.clamp_min(1.0 - self._c(x) * smath.sq_norm(x),
                                smath.eps_for(x.dtype))
        out = 2.0 / denom
        return out if keepdim else out[..., 0]

    def proj(self, x: torch.Tensor) -> torch.Tensor:
        c = self._c(x)
        sc = smath.sqrt_c(c, x)
        mn = smath.min_norm(x.dtype)
        norm = smath.clamp_min(smath.safe_norm(x), mn)
        max_norm = (1.0 - smath.ball_eps(x.dtype)) / smath.clamp_min(sc, mn)
        return torch.where(norm > max_norm, x / norm * max_norm, x)

    def mobius_add(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        c = self._c(x)
        x2 = smath.sq_norm(x)
        y2 = smath.sq_norm(y)
        xy = torch.sum(x * y, dim=-1, keepdim=True)
        num = (1.0 + 2.0 * c * xy + c * y2) * x + (1.0 - c * x2) * y
        denom = 1.0 + 2.0 * c * xy + (c ** 2) * x2 * y2
        return num / smath.clamp_min(denom, smath.eps_for(x.dtype))

    def expmap0(self, v: torch.Tensor) -> torch.Tensor:
        sc = smath.sqrt_c(self.c, v)
        return self.proj(smath.tanc(sc * smath.safe_norm(v)) * v)

    def dist(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        sc = smath.sqrt_c(self.c, x)
        diff_norm = smath.safe_norm(self.mobius_add(-x, y), keepdim=False)
        return (2.0 / smath.clamp_min(sc, smath.min_norm(x.dtype))
                * smath.artanh(sc * diff_norm))

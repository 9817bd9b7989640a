"""Flat Euclidean space (curvature 0) — counterpart of
``hyperspace_tpu/manifolds/euclidean.py``: the factor of mixed-curvature
products and the ``None``-free way to tag a flat parameter."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hyperspace_torch.manifolds import smath
from hyperspace_torch.manifolds.base import Manifold


@dataclasses.dataclass(frozen=True)
class Euclidean(Manifold):
    name = "euclidean"
    c = 0.0  # curvature, for API uniformity with the curved manifolds

    def proj(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def proju(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return u

    def expmap(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return x + v

    def logmap(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return y - x

    def sqdist(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return smath.sq_norm(y - x, keepdim=False)

    def dist(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return smath.safe_norm(y - x, keepdim=False)

    def inner(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              keepdim: bool = False) -> torch.Tensor:
        return torch.sum(u * v, dim=-1, keepdim=keepdim)

    def ptransp(self, x: torch.Tensor, y: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        return v

    def egrad2rgrad(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return g

    def origin(self, shape, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=device)

    def random_normal(self, generator: Optional[torch.Generator], shape,
                      dtype: torch.dtype = torch.float32, std: float = 1.0,
                      device=None) -> torch.Tensor:
        return std * torch.randn(shape, generator=generator, dtype=dtype,
                                 device=device)

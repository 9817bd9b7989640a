"""Cartesian product of manifolds with per-factor (learnable) curvature
(counterpart of ``hyperspace_tpu/manifolds/product.py``; Gu et al. 2019,
the geometry of ``BASELINE.json`` configs[4]).

Points are stored concatenated along the last axis: factor i holds the
slice ``[offset_i, offset_i + dim_i)``.  A factor's curvature may be a
0-dim device tensor, so a product rebuilt every step from
``softplus(c_raw)`` is differentiable end to end and stays on the
device.
"""

from __future__ import annotations

from typing import Optional

import torch

from hyperspace_torch.manifolds import smath
from hyperspace_torch.manifolds.base import Manifold, reduce_health_stats


class Product(Manifold):
    name = "product"

    def __init__(self, factors, dims):
        """``factors``: manifold instances; ``dims``: the ambient width of
        each slice."""
        if len(factors) != len(dims):
            raise ValueError("factors and dims must have equal length")
        self.factors = tuple(factors)
        self.dims = tuple(int(d) for d in dims)
        offs, acc = [], 0
        for d in self.dims:
            offs.append(acc)
            acc += d
        self.offsets = tuple(offs)
        self.total_dim = acc

    # --- slicing -------------------------------------------------------------

    def split(self, x: torch.Tensor) -> list:
        return [x.narrow(-1, o, d) for o, d in zip(self.offsets, self.dims)]

    def _join(self, parts) -> torch.Tensor:
        return torch.cat(parts, dim=-1)

    def _map(self, fn_name: str, *arrays) -> torch.Tensor:
        parts = [self.split(a) for a in arrays]
        return self._join([getattr(m, fn_name)(*[p[i] for p in parts])
                           for i, m in enumerate(self.factors)])

    # --- Manifold interface --------------------------------------------------

    def proj(self, x):
        return self._map("proj", x)

    def proju(self, x, u):
        return self._map("proju", x, u)

    def expmap(self, x, v):
        return self._map("expmap", x, v)

    def logmap(self, x, y):
        return self._map("logmap", x, y)

    def ptransp(self, x, y, v):
        return self._map("ptransp", x, y, v)

    def egrad2rgrad(self, x, g):
        return self._map("egrad2rgrad", x, g)

    def sqdist(self, x, y):
        """The sum of the factors' squared distances."""
        return sum(m.sqdist(xi, yi) for m, xi, yi in
                   zip(self.factors, self.split(x), self.split(y)))

    def dist(self, x, y):
        return smath.safe_sqrt(self.sqdist(x, y))

    def inner(self, x, u, v, keepdim: bool = False):
        out = sum(m.inner(xi, ui, vi, keepdim=True) for m, xi, ui, vi in
                  zip(self.factors, self.split(x), self.split(u),
                      self.split(v)))
        return out if keepdim else out[..., 0]

    def origin(self, shape, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
        if shape[-1] != self.total_dim:
            raise ValueError(f"shape {tuple(shape)}: the last axis must be "
                             f"{self.total_dim}")
        return self._join([m.origin(tuple(shape[:-1]) + (d,), dtype, device)
                           for m, d in zip(self.factors, self.dims)])

    def check_point(self, x):
        return sum(m.check_point(xi)
                   for m, xi in zip(self.factors, self.split(x)))

    def health_stats(self, x) -> dict:
        """Each factor's own stats on its slice, keyed
        ``f<i>_<name>/<stat>``, and their merge under the bare names
        (min of margins, max of violations and norms, mean of means), so
        the monitor's suffix thresholds fire without knowing the
        layout."""
        out, per_factor = {}, []
        for i, (m, xi) in enumerate(zip(self.factors, self.split(x))):
            stats = m.health_stats(xi)
            per_factor.append(stats)
            out.update({f"f{i}_{m.name}/{k}": v for k, v in stats.items()})
        out.update(reduce_health_stats(per_factor))
        return out

    def logdetexp(self, x, y):
        """The exp of a product is the product of the factors' exps, so
        its log-Jacobian is their sum."""
        return sum(m.logdetexp(xi, yi) for m, xi, yi in
                   zip(self.factors, self.split(x), self.split(y)))

    def _coord_split(self, v: torch.Tensor) -> list:
        parts, o = [], 0
        for m, d in zip(self.factors, self.dims):
            cd = m.coord_dim(d)
            parts.append(v.narrow(-1, o, cd))
            o += cd
        return parts

    def logdetexp_from_coords(self, v: torch.Tensor) -> torch.Tensor:
        return sum(m.logdetexp_from_coords(vi)
                   for m, vi in zip(self.factors, self._coord_split(v)))

    def coord_dim(self, ambient_dim: int) -> int:
        if ambient_dim != self.total_dim:
            raise ValueError(f"ambient width {ambient_dim}, want "
                             f"{self.total_dim}")
        return sum(m.coord_dim(d) for m, d in zip(self.factors, self.dims))

    def tangent_from_origin_coords(self, v: torch.Tensor) -> torch.Tensor:
        return self._join([m.tangent_from_origin_coords(vi) for m, vi in
                           zip(self.factors, self._coord_split(v))])

    def origin_coords_from_tangent(self, u: torch.Tensor) -> torch.Tensor:
        return self._join([m.origin_coords_from_tangent(ui)
                           for m, ui in zip(self.factors, self.split(u))])

    def random_normal(self, generator: Optional[torch.Generator], shape,
                      dtype: torch.dtype = torch.float32, std: float = 1.0,
                      device=None) -> torch.Tensor:
        """A wrapped-normal sample a factor, drawn in factor order from one
        generator (other bits than JAX's split keys)."""
        if shape[-1] != self.total_dim:
            raise ValueError(f"shape {tuple(shape)}: the last axis must be "
                             f"{self.total_dim}")
        return self._join([
            m.random_normal(generator, tuple(shape[:-1]) + (d,), dtype, std,
                            device)
            for m, d in zip(self.factors, self.dims)])

"""The Manifold interface every geometry implements (counterpart of
``hyperspace_tpu/manifolds/base.py``).

A subclass supplies the abstract core — ``proj``, ``proju``, ``expmap``,
``logmap``, ``sqdist``, ``inner``, ``ptransp``, ``egrad2rgrad`` and
``origin`` — and the defaults here are written in terms of it;
``check_point`` and ``health_stats`` are defaults that curved manifolds
override with their own residual.  ``origin`` takes ``(shape, dtype, device)``, the port's
explicit device, and ``random_normal`` a ``torch.Generator`` where JAX
takes a key.
"""

from __future__ import annotations

from typing import Optional

import torch

from hyperspace_torch.manifolds import smath


class Manifold:
    """A Riemannian manifold: the core that a subclass must supply raises
    ``NotImplementedError`` here (JAX's abstract methods); the flat
    (Euclidean) forms of the origin chart, of ``logdetexp`` and of the
    constraint residual are defaults that curved manifolds override.
    Points and tangents are batched over leading axes, the manifold
    dimension the last axis."""

    name: str = "manifold"

    # --- core geometry --------------------------------------------------------

    def proj(self, x: torch.Tensor) -> torch.Tensor:
        """Project an ambient point onto the manifold (numerical guard)."""
        raise NotImplementedError(type(self).__name__ + ".proj")

    def proju(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Project an ambient vector onto the tangent space at ``x``."""
        raise NotImplementedError(type(self).__name__ + ".proju")

    def expmap(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Exponential map of tangent ``v`` at point ``x``."""
        raise NotImplementedError(type(self).__name__ + ".expmap")

    def logmap(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Logarithm map of ``y`` at base point ``x``."""
        raise NotImplementedError(type(self).__name__ + ".logmap")

    def sqdist(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Squared geodesic distance over the last axis."""
        raise NotImplementedError(type(self).__name__ + ".sqdist")

    def inner(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              keepdim: bool = False) -> torch.Tensor:
        """Riemannian inner product of tangents ``u``, ``v`` at ``x``."""
        raise NotImplementedError(type(self).__name__ + ".inner")

    def ptransp(self, x: torch.Tensor, y: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        """Parallel transport of tangent ``v`` from ``x`` to ``y``."""
        raise NotImplementedError(type(self).__name__ + ".ptransp")

    def egrad2rgrad(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """Euclidean gradient → Riemannian gradient at ``x``."""
        raise NotImplementedError(type(self).__name__ + ".egrad2rgrad")

    def origin(self, shape, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
        """The canonical base point broadcast to ``shape``."""
        raise NotImplementedError(type(self).__name__ + ".origin")

    # --- defaults -------------------------------------------------------------

    def dist(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return smath.safe_sqrt(self.sqdist(x, y))

    def norm_t(self, x: torch.Tensor, u: torch.Tensor,
               keepdim: bool = False) -> torch.Tensor:
        """‖u‖ at x in the Riemannian metric."""
        return smath.safe_sqrt(self.inner(x, u, u, keepdim=keepdim))

    def expmap0(self, v: torch.Tensor) -> torch.Tensor:
        """Exponential map at the origin."""
        return self.expmap(self.origin(v.shape, v.dtype, v.device), v)

    def logmap0(self, y: torch.Tensor) -> torch.Tensor:
        """Logarithm map at the origin."""
        return self.logmap(self.origin(y.shape, y.dtype, y.device), y)

    def ptransp0(self, y: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Parallel transport from the origin to ``y``."""
        return self.ptransp(self.origin(y.shape, y.dtype, y.device), y, v)

    def retr(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """First-order retraction (a cheap expmap): proj(x + v)."""
        return self.proj(x + v)

    def zero_tangent(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(x)

    def random_normal(self, generator: Optional[torch.Generator], shape,
                      dtype: torch.dtype = torch.float32, std: float = 1.0,
                      device=None) -> torch.Tensor:
        """A wrapped-normal sample: N(0, std) in the origin tangent space,
        mapped by ``expmap0`` (other bits than JAX's from the same seed)."""
        v = std * torch.randn(shape, generator=generator, dtype=dtype,
                              device=device)
        v = self.proju(self.origin(v.shape, dtype, v.device), v)
        return self.proj(self.expmap0(v))

    def check_point(self, x: torch.Tensor) -> torch.Tensor:
        """Residual of the manifold constraint (0 on the manifold)."""
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def health_stats(self, x: torch.Tensor) -> dict:
        """Numerical-health scalars of a batch of points: the generic form
        reports the ``check_point`` residual."""
        v = self.check_point(x)
        return {"violation_max": torch.max(v),
                "violation_mean": torch.mean(v)}

    def ambient_dim(self, dim: int) -> int:
        """The storage width of a ``dim``-dimensional manifold."""
        return dim

    # --- origin coordinate chart (flat defaults) ------------------------------

    def coord_dim(self, ambient_dim: int) -> int:
        """Intrinsic dimension of the origin tangent space."""
        return ambient_dim

    def tangent_from_origin_coords(self, v: torch.Tensor) -> torch.Tensor:
        """Orthonormal origin coordinates → tangent vector at the origin."""
        return v

    def origin_coords_from_tangent(self, u: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`tangent_from_origin_coords`."""
        return u

    # --- expmap Jacobian (flat default 0) -------------------------------------

    def logdetexp(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """log |det d exp_x| at log_x(y); shape [...]."""
        shape = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1])
        return torch.zeros(shape, dtype=x.dtype, device=x.device)

    def logdetexp_from_coords(self, v: torch.Tensor) -> torch.Tensor:
        """The same from origin-chart coordinates whose norm is the
        geodesic radius."""
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)

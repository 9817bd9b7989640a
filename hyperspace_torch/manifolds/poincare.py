"""Poincaré ball of curvature -c (c > 0) with Möbius gyrovector operations
— counterpart of ``hyperspace_tpu/manifolds/poincare.py``.

Math follows Ganea et al. 2018 and Ungar's gyrovector calculus.  The ball
of curvature -c is { x : c‖x‖² < 1 } with conformal factor
λ_x = 2 / (1 − c‖x‖²).  ``c`` may be a Python number or a 0-dim tensor
(which may require grad: gradients flow to it); every method takes it in
the points' dtype, as the JAX methods do.  These methods are also the
plain versions of the row-wise and gyro-linear kernels
(``kernels/pointwise.py``, ``kernels/hyplinear.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from hyperspace_torch.manifolds import smath
from hyperspace_torch.manifolds.base import Manifold


@dataclasses.dataclass(frozen=True)
class PoincareBall(Manifold):
    c: Any = 1.0
    name = "poincare"

    def _c(self, like: torch.Tensor) -> torch.Tensor:
        return smath.as_scalar(self.c, like)

    def lambda_x(self, x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
        """Conformal factor 2 / (1 − c‖x‖²), the denominator clamped."""
        denom = smath.clamp_min(1.0 - self._c(x) * smath.sq_norm(x),
                                smath.eps_for(x.dtype))
        out = 2.0 / denom
        return out if keepdim else out[..., 0]

    # --- constraint / projections --------------------------------------------

    def proj(self, x: torch.Tensor) -> torch.Tensor:
        c = self._c(x)
        sc = smath.sqrt_c(c, x)
        mn = smath.min_norm(x.dtype)
        norm = smath.clamp_min(smath.safe_norm(x), mn)
        max_norm = (1.0 - smath.ball_eps(x.dtype)) / smath.clamp_min(sc, mn)
        return torch.where(norm > max_norm, x / norm * max_norm, x)

    def proju(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return u  # the tangent space is all of R^d

    def check_point(self, x: torch.Tensor) -> torch.Tensor:
        c = self._c(x)
        return smath.clamp_min(c * smath.sq_norm(x, keepdim=False) - 1.0,
                               0.0)

    def health_stats(self, x: torch.Tensor) -> dict:
        """Boundary drift: the scaled radius r = √c‖x‖ (max and mean) and
        the smallest margin 1 − r (``proj`` pins f32 points at 4e-3)."""
        r = smath.sqrt_c(self.c, x) * smath.safe_norm(x, keepdim=False)
        r_max = torch.max(r)
        return {"norm_max": r_max, "norm_mean": torch.mean(r),
                "boundary_margin_min": 1.0 - r_max}

    # --- Möbius gyrovector ops --------------------------------------------------

    def mobius_add(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x ⊕_c y."""
        c = self._c(x)
        x2 = smath.sq_norm(x)
        y2 = smath.sq_norm(y)
        xy = torch.sum(x * y, dim=-1, keepdim=True)
        num = (1.0 + 2.0 * c * xy + c * y2) * x + (1.0 - c * x2) * y
        denom = 1.0 + 2.0 * c * xy + (c ** 2) * x2 * y2
        return num / smath.clamp_min(denom, smath.eps_for(x.dtype))

    def mobius_neg(self, x: torch.Tensor) -> torch.Tensor:
        return -x

    def mobius_scalar_mul(self, r, x: torch.Tensor) -> torch.Tensor:
        """r ⊗_c x."""
        sc = smath.sqrt_c(self.c, x)
        mn = smath.min_norm(x.dtype)
        norm = smath.clamp_min(smath.safe_norm(x), mn)
        t = smath.safe_tanh(r * smath.artanh(sc * norm))
        return t * x / smath.clamp_min(sc * norm, mn)

    def mobius_matvec(self, m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """M ⊗_c x, the linear part of the gyro-linear layer; ``m`` is
        [d_in, d_out], applied on the last axis of ``x``.  The product is a
        full-float32 matmul (the caller keeps TF32 off): tanh∘artanh
        amplifies its error.  Rows with Mx = 0 map to the origin."""
        sc = smath.sqrt_c(self.c, x)
        mn = smath.min_norm(x.dtype)
        x_norm = smath.clamp_min(smath.safe_norm(x), mn)
        dt = torch.promote_types(x.dtype, m.dtype)   # as jnp.matmul
        mx = torch.matmul(x.to(dt), m.to(dt))
        mx_norm = smath.clamp_min(smath.safe_norm(mx), mn)
        sc = smath.clamp_min(sc, mn)               # guards a learned c → 0
        res = (smath.safe_tanh(mx_norm / x_norm * smath.artanh(sc * x_norm))
               * mx / (mx_norm * sc))
        zero = torch.all(mx == 0.0, dim=-1, keepdim=True)
        return torch.where(zero, torch.zeros_like(res), res)

    def gyration(self, u: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
        """gyr[u, v] w in Ungar's closed form."""
        c = self._c(u)
        u2 = smath.sq_norm(u)
        v2 = smath.sq_norm(v)
        uv = torch.sum(u * v, dim=-1, keepdim=True)
        uw = torch.sum(u * w, dim=-1, keepdim=True)
        vw = torch.sum(v * w, dim=-1, keepdim=True)
        c2 = c ** 2
        a = -c2 * uw * v2 + c * vw + 2.0 * c2 * uv * vw
        b = -c2 * vw * u2 - c * uw
        d = 1.0 + 2.0 * c * uv + c2 * u2 * v2
        return w + 2.0 * (a * u + b * v) / smath.clamp_min(
            d, smath.eps_for(u.dtype))

    # --- exp / log / distance ---------------------------------------------------

    def expmap(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        sc = smath.sqrt_c(self.c, x)
        lam = self.lambda_x(x)
        t = sc * lam * smath.safe_norm(v) / 2.0
        second = smath.tanc(t) * lam / 2.0 * v   # smooth at v = 0
        return self.proj(self.mobius_add(x, second))

    def logmap(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        sc = smath.sqrt_c(self.c, x)
        sub = self.mobius_add(-x, y)
        lam = self.lambda_x(x)
        # (2/(√c λ)) artanh(√c‖sub‖) sub/‖sub‖, smooth at y = x
        return (2.0 / lam) * smath.artanc(sc * smath.safe_norm(sub)) * sub

    def expmap0(self, v: torch.Tensor) -> torch.Tensor:
        sc = smath.sqrt_c(self.c, v)
        return self.proj(smath.tanc(sc * smath.safe_norm(v)) * v)

    def logmap0(self, y: torch.Tensor) -> torch.Tensor:
        sc = smath.sqrt_c(self.c, y)
        return smath.artanc(sc * smath.safe_norm(y)) * y

    def sqdist(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.dist(x, y) ** 2

    def dist(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        sc = smath.sqrt_c(self.c, x)
        diff_norm = smath.safe_norm(self.mobius_add(-x, y), keepdim=False)
        return (2.0 / smath.clamp_min(sc, smath.min_norm(x.dtype))
                * smath.artanh(sc * diff_norm))

    def dist0(self, x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
        sc = smath.clamp_min(smath.sqrt_c(self.c, x), smath.min_norm(x.dtype))
        return 2.0 / sc * smath.artanh(sc * smath.safe_norm(x,
                                                            keepdim=keepdim))

    # --- transport / metric -----------------------------------------------------

    def inner(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              keepdim: bool = False) -> torch.Tensor:
        lam = self.lambda_x(x)
        out = lam ** 2 * torch.sum(u * v, dim=-1, keepdim=True)
        return out if keepdim else out[..., 0]

    def ptransp(self, x: torch.Tensor, y: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        """P_{x→y}(v) = (λ_x / λ_y) gyr[y, −x] v."""
        return self.gyration(y, -x, v) * self.lambda_x(x) / self.lambda_x(y)

    def egrad2rgrad(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return g / self.lambda_x(x) ** 2

    def origin(self, shape, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=device)

    # --- origin coordinate chart --------------------------------------------
    # The metric at 0 is λ₀² δ = 4 δ (whatever c), so orthonormal
    # coordinates differ from ambient tangents by the factor λ₀ = 2.

    def tangent_from_origin_coords(self, v: torch.Tensor) -> torch.Tensor:
        return v / 2.0

    def origin_coords_from_tangent(self, u: torch.Tensor) -> torch.Tensor:
        return u * 2.0

    def logdetexp(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """(d−1)·log(sinh(√c r)/(√c r)) at r = dist(x, y): the Jacobian
        correction of the wrapped-normal density."""
        r = self.dist(x, y)
        return (x.shape[-1] - 1) * torch.log(smath.clamp_min(
            smath.sinhc(smath.sqrt_c(self.c, x) * r),
            smath.eps_for(x.dtype)))

    def logdetexp_from_coords(self, v: torch.Tensor) -> torch.Tensor:
        r = smath.safe_norm(v, keepdim=False)
        return (v.shape[-1] - 1) * torch.log(smath.clamp_min(
            smath.sinhc(smath.sqrt_c(self.c, v) * r),
            smath.eps_for(v.dtype)))

    # --- gyro extras ------------------------------------------------------------

    def gyromidpoint(self, x: torch.Tensor,
                     w: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Möbius gyromidpoint over the second-to-last axis: x [..., n, d],
        weights w [..., n] (uniform if None)."""
        lam = self.lambda_x(x)                          # [..., n, 1]
        if w is None:
            w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
        w = w[..., None]
        num = torch.sum(w * lam * x, dim=-2)
        den = smath.clamp_min(torch.abs(torch.sum(w * (lam - 1.0), dim=-2)),
                              smath.eps_for(x.dtype))
        return self.proj(self.mobius_scalar_mul(0.5, num / den))

"""Ball ↔ hyperboloid isometry and its differential — counterpart of
``hyperspace_tpu/manifolds/maps.py``.

The tangent maps are the pushforwards of the point maps (JAX takes them
by ``jax.jvp``); here they are the closed-form differentials, with each
clamp's derivative 0 where the clamp holds, as ``jnp.maximum``'s."""

from __future__ import annotations

import torch

from hyperspace_torch.manifolds import smath


def lorentz_to_ball(x: torch.Tensor, c) -> torch.Tensor:
    """y = x_space / (1 + √c · x_0)."""
    sc = smath.sqrt_c(c, x)
    denom = smath.clamp_min(1.0 + sc * x[..., :1], smath.eps_for(x.dtype))
    return x[..., 1:] / denom


def ball_to_lorentz(y: torch.Tensor, c) -> torch.Tensor:
    """x_0 = (1/√c)(1 + c‖y‖²)/(1 − c‖y‖²),  x_space = 2y/(1 − c‖y‖²)."""
    c = smath.as_scalar(c, y)
    sc = smath.sqrt_c(c, y)
    y2 = smath.sq_norm(y)
    denom = smath.clamp_min(1.0 - c * y2, smath.eps_for(y.dtype))
    x0 = (1.0 + c * y2) / (sc * denom)
    return torch.cat([x0, 2.0 * y / denom], dim=-1)


def lorentz_tangent_to_ball(x: torch.Tensor, v: torch.Tensor,
                            c) -> torch.Tensor:
    """d(lorentz_to_ball)_x applied to the tangent v:
    v_space / D − x_space · √c v_0 / D², D = 1 + √c x_0."""
    sc = smath.sqrt_c(c, x)
    raw = 1.0 + sc * x[..., :1]
    denom = smath.clamp_min(raw, smath.eps_for(x.dtype))
    d_denom = torch.where(raw > smath.eps_for(x.dtype), sc * v[..., :1],
                          torch.zeros_like(raw))
    return v[..., 1:] / denom - x[..., 1:] * d_denom / denom ** 2


def ball_tangent_to_lorentz(y: torch.Tensor, u: torch.Tensor,
                            c) -> torch.Tensor:
    """d(ball_to_lorentz)_y applied to the tangent u."""
    c = smath.as_scalar(c, y)
    sc = smath.sqrt_c(c, y)
    y2 = smath.sq_norm(y)
    dy2 = 2.0 * torch.sum(y * u, dim=-1, keepdim=True)
    raw = 1.0 - c * y2
    denom = smath.clamp_min(raw, smath.eps_for(y.dtype))
    d_denom = torch.where(raw > smath.eps_for(y.dtype), -c * dy2,
                          torch.zeros_like(raw))
    dx0 = (c * dy2 * denom - (1.0 + c * y2) * d_denom) / (sc * denom ** 2)
    dxs = 2.0 * u / denom - 2.0 * y * d_denom / denom ** 2
    return torch.cat([dx0, dxs], dim=-1)

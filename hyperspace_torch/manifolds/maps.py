"""Ball ↔ hyperboloid isometry — counterpart of
``hyperspace_tpu/manifolds/maps.py`` (points only)."""

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
    c = torch.as_tensor(c, dtype=y.dtype, device=y.device)
    sc = smath.sqrt_c(c, y)
    y2 = smath.sq_norm(y)
    denom = smath.clamp_min(1.0 - c * y2, smath.eps_for(y.dtype))
    x0 = (1.0 + c * y2) / (sc * denom)
    return torch.cat([x0, 2.0 * y / denom], dim=-1)

"""Numerically-stable scalar math shared by the manifolds (counterpart of
``hyperspace_tpu/manifolds/smath.py``).

Only the helpers the serving path uses are ported, with the same
dtype-dependent epsilon tiers: float64 keeps tight guards, float32 the
looser ones the kernels also use.  Curvature ``c`` is the positive
magnitude (sectional curvature ``-c``).
"""

from __future__ import annotations

import torch

_MIN_NORM = 1e-15


def eps_for(dtype: torch.dtype) -> float:
    """A general-purpose small epsilon for the given float dtype."""
    if dtype == torch.float64:
        return 1e-12
    if dtype == torch.float32:
        return 1e-7
    return 1e-4  # bfloat16 / float16


def ball_eps(dtype: torch.dtype) -> float:
    """Distance kept between a projected point and the ball boundary."""
    if dtype == torch.float64:
        return 1e-5
    if dtype == torch.float32:
        return 4e-3
    return 1e-2


def min_norm(dtype: torch.dtype) -> float:
    """Smallest norm used as a division guard."""
    if dtype == torch.float64:
        return _MIN_NORM
    if dtype == torch.float32:
        return 1e-12
    return 1e-7


def _artanh_eps(dtype: torch.dtype) -> float:
    if dtype == torch.float64:
        return 1e-12
    if dtype == torch.float32:
        return 3e-7
    return 1e-2


def clamp_min(x: torch.Tensor, m) -> torch.Tensor:
    return torch.clamp_min(x, m)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero-clamped argument."""
    return torch.sqrt(torch.clamp_min(x, 0.0))


def sq_norm(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return torch.sum(x * x, dim=-1, keepdim=keepdim)


def safe_norm(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return safe_sqrt(sq_norm(x, keepdim=keepdim))


def sqrt_c(c, like: torch.Tensor) -> torch.Tensor:
    """sqrt of the curvature magnitude, as a scalar tensor of ``like``'s
    dtype and device."""
    return safe_sqrt(torch.as_tensor(c, dtype=like.dtype, device=like.device))


def artanh(x: torch.Tensor) -> torch.Tensor:
    """arctanh with the argument clamped into the open interval (-1, 1)."""
    e = _artanh_eps(x.dtype)
    return torch.atanh(torch.clamp(x, -1.0 + e, 1.0 - e))


def arcosh1p(u: torch.Tensor) -> torch.Tensor:
    """arcosh(1 + u) for u >= 0: log1p(u + sqrt(u (u + 2))), stable near 0."""
    u = torch.clamp_min(u, 0.0)
    return torch.log1p(u + safe_sqrt(u * (u + 2.0)))


def safe_tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(torch.clamp(x, -20.0, 20.0))


def _exp_arg_max(dtype: torch.dtype) -> float:
    return 350.0 if dtype == torch.float64 else 40.0


def safe_cosh(x: torch.Tensor) -> torch.Tensor:
    m = _exp_arg_max(x.dtype)
    return torch.cosh(torch.clamp(x, -m, m))


def safe_sinh(x: torch.Tensor) -> torch.Tensor:
    m = _exp_arg_max(x.dtype)
    return torch.sinh(torch.clamp(x, -m, m))


def tanc(x: torch.Tensor) -> torch.Tensor:
    """tanh(x)/x, smooth at x = 0."""
    small = torch.abs(x) < 1e-3
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 3.0, safe_tanh(xs) / xs)


def sinhc(x: torch.Tensor) -> torch.Tensor:
    """sinh(x)/x, smooth at x = 0."""
    m = _exp_arg_max(x.dtype)
    small = torch.abs(x) < 1e-3
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 + x * x / 6.0,
                       safe_sinh(xs) / torch.clamp(xs, -m, m))

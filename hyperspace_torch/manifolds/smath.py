"""Numerically-stable scalar math shared by the manifolds (counterpart of
``hyperspace_tpu/manifolds/smath.py``).

The same dtype-dependent epsilon tiers as the JAX module: float64 keeps
tight guards, float32 the looser ones the kernels also use, bfloat16
the loosest.  Curvature ``c`` is the positive magnitude (sectional
curvature ``-c``).

Gradients follow JAX's: ``clamp_min`` and ``clip`` pass half the
gradient to each side of a tie (``jnp.maximum``/``jnp.minimum``), and
``safe_sqrt`` has a derivative bounded by ``1 / (2·sqrt(eps))`` at 0
(the JAX ``custom_jvp``).
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


def _like(m, x: torch.Tensor) -> torch.Tensor:
    """``m`` as a tensor that broadcasts against ``x`` (a Python number
    becomes a 0-dim tensor of ``x``'s dtype, rounded as JAX rounds a
    weakly typed scalar)."""
    if isinstance(m, torch.Tensor):
        return m
    return torch.full((), m, dtype=x.dtype, device=x.device)


def clamp_min(x: torch.Tensor, m) -> torch.Tensor:
    """max(x, m); at a tie each side gets half the gradient."""
    return torch.maximum(x, _like(m, x))


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """min(max(x, lo), hi), with ``jnp.clip``'s gradient at the ends."""
    return torch.minimum(torch.maximum(x, _like(lo, x)), _like(hi, x))


class _SafeSqrt(torch.autograd.Function):
    """sqrt(max(x, 0)) whose derivative is t / max(2y, 2·sqrt(eps))."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(torch.clamp_min(x, 0.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        eps = torch.tensor(eps_for(y.dtype), dtype=y.dtype)
        return g / torch.clamp_min(2.0 * y, 2.0 * float(torch.sqrt(eps)))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero-clamped primal and a bounded gradient at 0."""
    return _SafeSqrt.apply(x)


def scalar(v: float, dtype: torch.dtype) -> float:
    """The Python number ``v`` rounded to ``dtype`` (a constant that a
    tensor op of that dtype then uses exactly)."""
    return float(torch.tensor(float(v), dtype=dtype))


def sq_norm(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return torch.sum(x * x, dim=-1, keepdim=keepdim)


def safe_norm(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return safe_sqrt(sq_norm(x, keepdim=keepdim))


def sqrt_c(c, like: torch.Tensor) -> torch.Tensor:
    """sqrt of the curvature magnitude, as a scalar tensor of ``like``'s
    dtype and device."""
    return safe_sqrt(torch.as_tensor(c, dtype=like.dtype, device=like.device))


def curvature(c, dtype: torch.dtype):
    """``c`` in ``dtype``: a tensor is cast, a Python number is rounded to
    the dtype and stays a number (no device tensor, so no host-device
    copy on the card)."""
    if isinstance(c, torch.Tensor):
        return c.to(dtype)
    return scalar(c, dtype)


def sqrt_curvature(c, dtype: torch.dtype):
    """sqrt of :func:`curvature`, taken in ``dtype`` (JAX's
    ``sqrt_c(jnp.asarray(c, dtype))``)."""
    if isinstance(c, torch.Tensor):
        return safe_sqrt(c.to(dtype))
    return float(torch.sqrt(torch.tensor(max(scalar(c, dtype), 0.0),
                                         dtype=dtype)))


def artanh(x: torch.Tensor) -> torch.Tensor:
    """arctanh with the argument clamped into the open interval (-1, 1)."""
    e = _artanh_eps(x.dtype)
    return torch.atanh(clip(x, -1.0 + e, 1.0 - e))


def arcosh1p(u: torch.Tensor) -> torch.Tensor:
    """arcosh(1 + u) for u >= 0: log1p(u + sqrt(u (u + 2))), stable near 0
    (``safe_sqrt`` keeps the gradient finite at u = 0)."""
    u = clamp_min(u, 0.0)
    return torch.log1p(u + safe_sqrt(u * (u + 2.0)))


def safe_tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(clip(x, -20.0, 20.0))


def _exp_arg_max(dtype: torch.dtype) -> float:
    return 350.0 if dtype == torch.float64 else 40.0


def safe_cosh(x: torch.Tensor) -> torch.Tensor:
    m = _exp_arg_max(x.dtype)
    return torch.cosh(clip(x, -m, m))


def safe_sinh(x: torch.Tensor) -> torch.Tensor:
    m = _exp_arg_max(x.dtype)
    return torch.sinh(clip(x, -m, m))


def tanc(x: torch.Tensor) -> torch.Tensor:
    """tanh(x)/x, smooth at x = 0."""
    small = torch.abs(x) < 1e-3
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 3.0, safe_tanh(xs) / xs)


def sinhc(x: torch.Tensor) -> torch.Tensor:
    """sinh(x)/x, smooth at x = 0 (the double ``where`` keeps the
    gradient free of NaN)."""
    m = _exp_arg_max(x.dtype)
    small = torch.abs(x) < 1e-3
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 + x * x / 6.0,
                       safe_sinh(xs) / clip(xs, -m, m))

"""Shared optimizer plumbing (counterpart of
``hyperspace_tpu/optim/common.py``): optax's transformation pair and
``apply_updates``, the learning rate at a step count, and the ball's exp
map and transport through the hand kernels."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

ScalarOrSchedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class Transformation(NamedTuple):
    """optax's ``GradientTransformation``: ``init(params) -> state``,
    ``update(grads, state, params) -> (updates, state)``."""

    init: Callable
    update: Callable


def first_leaf(params: Any) -> torch.Tensor:
    """The first tensor of a tensor or (nested) dict of tensors."""
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params


def apply_updates(params, updates):
    """optax's ``apply_updates``: ``p + u`` cast back to p's dtype."""
    if isinstance(params, dict):
        return {k: apply_updates(params[k], updates[k]) for k in params}
    return (params + updates).to(params.dtype)


def lr_at(learning_rate: ScalarOrSchedule,
          count: torch.Tensor) -> torch.Tensor:
    """A constant-or-schedule learning rate at a step count, as a 0-dim
    float64 tensor on the count's device (a weakly typed scalar in JAX's
    terms: it multiplies a float32 tensor in float32).  A schedule is
    called with the count tensor and computes on the device, so a CUDA
    graph replays it."""
    if callable(learning_rate):
        return learning_rate(count)
    return torch.full((), float(learning_rate), dtype=torch.float64,
                      device=count.device)


def _is_ball(tag) -> bool:
    from hyperspace_torch.manifolds.poincare import PoincareBall

    return isinstance(tag, PoincareBall)


def expmap_of(tag, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``tag.expmap(x, v)``; on the ball through ``kernels.expmap``, which
    launches ``csrc/pointwise.cu`` for CUDA tensors and runs the same
    ``PoincareBall`` method on the CPU."""
    if _is_ball(tag):
        from hyperspace_torch import kernels as K

        return K.expmap(x, v, tag.c)
    return tag.expmap(x, v)


def ptransp_of(tag, x: torch.Tensor, y: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """``tag.ptransp(x, y, v)``; on the ball through ``kernels.ptransp``."""
    if _is_ball(tag):
        from hyperspace_torch import kernels as K

        return K.ptransp(x, y, v, tag.c)
    return tag.ptransp(x, y, v)


def step_counter(step, device) -> torch.Tensor:
    """A step count as a 0-dim int64 tensor on ``device`` (``None`` is 0,
    a number is filled in, a tensor is kept), so that a CUDA graph of a
    step advances it."""
    if isinstance(step, torch.Tensor):
        return step
    return torch.full((), 0 if step is None else int(step),
                      dtype=torch.int64, device=device)

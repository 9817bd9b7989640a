"""Riemannian SGD (counterpart of ``hyperspace_tpu/optim/rsgd.py``).

Bonnabel 2013 / Nickel & Kiela 2017: the Euclidean gradient is rescaled
by the inverse metric (``egrad2rgrad``), the step taken with the
exponential map (or the first-order retraction), which ends in ``proj``.
As the optax transform, ``update`` returns ``new_point - old_point`` and
``common.apply_updates`` adds it back, so the two packages round alike.

The state is a tensor (``count``), and every quantity is computed on the
device from it, burn-in included, so a CUDA graph of a step replays
correctly.  Rows outside a batch get a zero gradient and
``expmap(x, 0) = x`` leaves them unchanged; duplicate rows sum their
cotangents before the metric rescale (autograd of the gather does)."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from hyperspace_torch.optim.common import (ScalarOrSchedule, Transformation,
                                           expmap_of, first_leaf, lr_at)
from hyperspace_torch.optim.tags import map_tagged


class RSGDState(NamedTuple):
    count: torch.Tensor  # 0-dim int64


def riemannian_sgd(learning_rate: ScalarOrSchedule, tags: Any, *,
                   use_expmap: bool = True, burnin_steps: int = 0,
                   burnin_factor: float = 0.1) -> Transformation:
    """Riemannian SGD.

    ``learning_rate`` a number or a schedule of the count tensor;
    ``tags`` the parameters' tag structure (:mod:`optim.tags`);
    ``use_expmap`` the exact exponential map if True, else ``retr``;
    the first ``burnin_steps`` updates use ``lr * burnin_factor``."""

    def init(params):
        return RSGDState(count=torch.zeros(
            (), dtype=torch.int64, device=first_leaf(params).device))

    def update(grads, state, params):
        if params is None:
            raise ValueError("riemannian_sgd requires params")
        lr = lr_at(learning_rate, state.count)
        if burnin_steps > 0:
            lr = torch.where(state.count < burnin_steps, lr * burnin_factor,
                             lr)

        def one(tag, g, p):
            if tag is None:
                return -lr * g
            step = -lr * tag.egrad2rgrad(p, g)
            new_p = expmap_of(tag, p, step) if use_expmap else tag.retr(
                p, step)
            return new_p - p

        return (map_tagged(one, tags, grads, params),
                RSGDState(count=state.count + 1))

    return Transformation(init, update)

"""Riemannian Adam (Bécigneul & Ganea 2019; counterpart of
``hyperspace_tpu/optim/radam.py``).

- the Euclidean gradient becomes a Riemannian one;
- the first moment is a tangent vector, parallel-transported to the new
  point after every update;
- the second moment is the row scalar ``inner(p, rg, rg)`` clamped at 0,
  elementwise for ``None`` (Euclidean) leaves, which makes them plain
  Adam;
- the new point is ``expmap`` (or ``retr``); every ``stabilize_every``
  updates it is re-projected and the moment projected onto its tangent
  space.

The bias corrections ``1 − b^count`` are taken in the parameter's dtype
(JAX takes them in its default float type).  The state (``count``,
``mu``, ``nu``) is tensors, so the sparse and packed steps gather and
scatter the moments by rows; everything is computed on the device, so a
CUDA graph of a step replays correctly."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from hyperspace_torch.manifolds import smath
from hyperspace_torch.optim.common import (ScalarOrSchedule, Transformation,
                                           expmap_of, first_leaf, lr_at,
                                           ptransp_of)
from hyperspace_torch.optim.tags import map_tagged


class RAdamState(NamedTuple):
    count: torch.Tensor  # 0-dim int64
    mu: Any  # first moment: tangent vectors (manifold) / elementwise (None)
    nu: Any  # second moment: [..., 1] row scalars (manifold) / elementwise


def riemannian_adam(learning_rate: ScalarOrSchedule, tags: Any, *,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                    use_expmap: bool = True,
                    stabilize_every: int = 0) -> Transformation:
    """Riemannian Adam; ``tags`` the parameters' tag structure."""

    def init(params):
        mu = map_tagged(lambda t, p: torch.zeros_like(p), tags, params)
        nu = map_tagged(
            lambda t, p: torch.zeros_like(p) if t is None
            else torch.zeros(p.shape[:-1] + (1,), dtype=p.dtype,
                             device=p.device), tags, params)
        return RAdamState(count=torch.zeros(
            (), dtype=torch.int64, device=first_leaf(params).device),
            mu=mu, nu=nu)

    def update(grads, state, params):
        if params is None:
            raise ValueError("riemannian_adam requires params")
        count = state.count + 1
        lr = lr_at(learning_rate, state.count)
        do_stab = (count % stabilize_every == 0) if stabilize_every > 0 \
            else None

        def one(tag, g, p, mu, nu):
            n = count.to(p.dtype)
            c1 = 1.0 - torch.pow(b1, n)
            c2 = 1.0 - torch.pow(b2, n)
            if tag is None:
                mu_n = b1 * mu + (1.0 - b1) * g
                nu_n = b2 * nu + (1.0 - b2) * g * g
                step = -lr * (mu_n / c1) / (torch.sqrt(nu_n / c2) + eps)
                return step, mu_n, nu_n
            rg = tag.egrad2rgrad(p, g)
            mu_n = b1 * mu + (1.0 - b1) * rg
            nu_n = b2 * nu + (1.0 - b2) * tag.inner(p, rg, rg, keepdim=True)
            nu_n = smath.clamp_min(nu_n, 0.0)
            step = -lr * ((mu_n / c1) / (torch.sqrt(nu_n / c2) + eps))
            new_p = expmap_of(tag, p, step) if use_expmap else tag.retr(
                p, step)
            mu_t = ptransp_of(tag, p, new_p, mu_n)
            if do_stab is not None:
                q = tag.proj(new_p)
                mu_t = torch.where(do_stab, tag.proju(q, mu_t), mu_t)
                new_p = torch.where(do_stab, q, new_p)
            return new_p - p, mu_t, nu_n

        out = map_tagged(one, tags, grads, params, state.mu, state.nu)
        pick = lambda i: map_tagged(lambda t, x: x[i], tags, out)  # noqa: E731
        return pick(0), RAdamState(count=count, mu=pick(1), nu=pick(2))

    return Transformation(init, update)

"""The port's Riemannian SGD and Adam (``hyperspace_torch/optim``) against
the JAX package's optax transforms, on the CPU.

One parameter set holds a ball leaf, a hyperboloid leaf and a Euclidean
(``None``) leaf; the same numpy gradients feed both packages, which then
apply ``update`` and ``apply_updates``.  Cases: RSGD with the exponential
map, with burn-in (the lr drops by its factor for the first steps) and
with the retraction; RAdam with the exponential map, the retraction,
``stabilize_every`` and a burn-in schedule.  One step is held at float64
(JAX under scoped x64) within rtol 1e-10, and at float32 (JAX without
x64, as on the TPU) within rtol 1e-5; five float32 steps within rtol
5e-5, atol 1e-6 (two float32 chains, each step's rounding carried into
the next and the bias corrections' powers taken by two libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperspace_tpu.manifolds import Lorentz as JL
from hyperspace_tpu.manifolds import PoincareBall as JB
from hyperspace_tpu.optim import radam as jradam
from hyperspace_tpu.optim import rsgd as jrsgd
from hyperspace_torch.manifolds import Lorentz as TL
from hyperspace_torch.manifolds import PoincareBall as TB
from hyperspace_torch.optim import radam as tradam
from hyperspace_torch.optim import rsgd as trsgd
from hyperspace_torch.optim.common import apply_updates
from hyperspace_torch.optim.metrics import ChunkMetrics
from hyperspace_torch.optim.tags import (map_tagged, name_contains,
                                         tags_from_names)

C = 0.9
D = 4


def _params(rng):
    v = rng.standard_normal((6, D))
    ball = v / np.linalg.norm(v, axis=1, keepdims=True) * rng.uniform(
        0.1, 0.7, (6, 1))
    s = rng.standard_normal((5, D)) * 0.5
    lor = np.concatenate([np.sqrt(1 / C + np.sum(s * s, 1, keepdims=True)),
                          s], 1)
    return {"ball": ball, "flat": rng.standard_normal((3, 4)), "lor": lor}


def _grads(rng, params):
    return {k: rng.standard_normal(v.shape) * 0.3 for k, v in params.items()}


def _burnin_schedule_jax(n):
    return 0.05 * jnp.where(n < 2, 0.1, 1.0)


def _burnin_schedule_torch(n):
    base = torch.full((), 0.05, dtype=torch.float64, device=n.device)
    return torch.where(n < 2, base * 0.1, base)


# case → (JAX transform, port transform) given (JAX tags, port tags)
CASES = {
    "rsgd": (lambda t: jrsgd.riemannian_sgd(0.05, t),
             lambda t: trsgd.riemannian_sgd(0.05, t)),
    "rsgd_burnin": (
        lambda t: jrsgd.riemannian_sgd(0.05, t, burnin_steps=3,
                                       burnin_factor=0.1),
        lambda t: trsgd.riemannian_sgd(0.05, t, burnin_steps=3,
                                       burnin_factor=0.1)),
    "rsgd_retr": (lambda t: jrsgd.riemannian_sgd(0.05, t, use_expmap=False),
                  lambda t: trsgd.riemannian_sgd(0.05, t, use_expmap=False)),
    "radam": (lambda t: jradam.riemannian_adam(0.05, t),
              lambda t: tradam.riemannian_adam(0.05, t)),
    "radam_retr": (
        lambda t: jradam.riemannian_adam(0.05, t, use_expmap=False),
        lambda t: tradam.riemannian_adam(0.05, t, use_expmap=False)),
    "radam_stabilize": (
        lambda t: jradam.riemannian_adam(0.05, t, stabilize_every=2),
        lambda t: tradam.riemannian_adam(0.05, t, stabilize_every=2)),
    "radam_burnin": (
        lambda t: jradam.riemannian_adam(_burnin_schedule_jax, t),
        lambda t: tradam.riemannian_adam(_burnin_schedule_torch, t)),
}


def _run(case, dt, steps):
    """(JAX params, port params, JAX count, port count) after ``steps``."""
    rng = np.random.default_rng(11)
    params = {k: v.astype(dt) for k, v in _params(rng).items()}
    grads = [{k: v.astype(dt) for k, v in _grads(rng, params).items()}
             for _ in range(steps)]
    jmake, tmake = CASES[case]
    with jax.enable_x64(dt == np.float64):
        jtags = {"ball": JB(C), "flat": None, "lor": JL(C)}
        jopt = jmake(jtags)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        js = jopt.init(jp)
        for g in grads:
            u, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                js, jp)
            jp = optax.apply_updates(jp, u)
        jp = {k: np.asarray(v) for k, v in jp.items()}
        jcount = int(js.count)
    ttags = {"ball": TB(C), "flat": None, "lor": TL(C)}
    topt = tmake(ttags)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    ts = topt.init(tp)
    for g in grads:
        u, ts = topt.update({k: torch.as_tensor(v) for k, v in g.items()},
                            ts, tp)
        tp = apply_updates(tp, u)
    return jp, {k: v.numpy() for k, v in tp.items()}, jcount, int(ts.count)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dt,steps,tol", [
    (np.float64, 1, dict(rtol=1e-10, atol=1e-12)),
    (np.float32, 1, dict(rtol=1e-5, atol=1e-7)),
    (np.float32, 5, dict(rtol=5e-5, atol=1e-6)),
])
def test_update_matches_jax(case, dt, steps, tol):
    jp, tp, jc, tc = _run(case, dt, steps)
    assert tc == jc == steps
    for k in jp:
        assert tp[k].dtype == dt
        np.testing.assert_allclose(tp[k], jp[k], err_msg=k, **tol)


def test_burnin_scales_the_first_steps():
    """A zero-lr burn-in leaves the points where they are for exactly
    ``burnin_steps`` updates, then moves them."""
    ball = TB(1.0)
    p = torch.tensor([[0.1, 0.2], [0.3, -0.1]], dtype=torch.float64)
    opt = trsgd.riemannian_sgd(0.1, ball, burnin_steps=2, burnin_factor=0.0)
    st = opt.init(p)
    g = torch.ones_like(p)
    for i in range(3):
        u, st = opt.update(g, st, p)
        moved = bool(torch.any(u != 0))
        assert moved == (i == 2)
        p = apply_updates(p, u)


def test_radam_second_moment_is_a_row_scalar_and_mu_is_transported():
    ball = TB(1.0)
    p = ball.expmap0(torch.randn(5, 3, dtype=torch.float64,
                                 generator=torch.Generator().manual_seed(0))
                     * 0.3)
    opt = tradam.riemannian_adam(0.1, ball)
    st = opt.init(p)
    assert st.nu.shape == (5, 1) and st.mu.shape == (5, 3)
    g = torch.randn(5, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    u, st2 = opt.update(g, st, p)
    q = apply_updates(p, u)
    mu = (1 - 0.9) * ball.egrad2rgrad(p, g)
    np.testing.assert_allclose(st2.mu.numpy(),
                               ball.ptransp(p, q, mu).numpy(), rtol=1e-10)
    assert torch.all(st2.nu >= 0)


def test_tags_by_name_and_metrics():
    params = {"emb": {"table": torch.zeros(2, 2)}, "bias": torch.zeros(2)}
    tags = tags_from_names(params, lambda n: TB(1.0) if name_contains(
        n, "table") else None)
    assert isinstance(tags["emb"]["table"], TB) and tags["bias"] is None
    shapes = map_tagged(lambda t, p: tuple(p.shape), tags, params)
    assert shapes == {"emb": {"table": (2, 2)}, "bias": (2,)}
    assert not name_contains("emb.tables", "table")
    m = ChunkMetrics()
    assert m.flush() is None
    m.add(torch.tensor(3.0))
    m.add(torch.tensor([1.0, 2.0]))
    assert m.flush() == {"loss_mean": 2.0, "loss_last": 2.0,
                         "loss_min": 1.0, "loss_max": 3.0}
    assert m.flush() is None

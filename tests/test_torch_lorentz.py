"""The port's Lorentz hyperboloid (the methods of the ``Manifold``
contract) and flat ``Euclidean`` against the JAX package, on the CPU.

Each method gets the same numpy inputs on both sides: hyperboloid points
lifted from the origin tangent (distances ≲ 2, where ``logmap`` is well
conditioned), ambient tangents projected at their base point.  Values and
gradients (of a weighted tanh of the output, to every tensor input and to
a tensor curvature) are compared in float64 under JAX's scoped
``enable_x64`` at rtol 1e-10, and in float32 at rtol 1e-5 (gradients atol
1e-5).  The mpmath constants of ``tests/manifolds/test_golden.py`` hold
the float64 methods to the published closed forms.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.manifolds import Euclidean as JE
from hyperspace_tpu.manifolds import Lorentz as JL
from hyperspace_torch.manifolds import Euclidean as TE
from hyperspace_torch.manifolds import Lorentz as TL
from hyperspace_torch.manifolds import Manifold
from tests.manifolds.test_golden import (LORENTZ_DIST_C07, LORENTZ_DIST_C1,
                                         LORENTZ_EXPMAP_C1,
                                         LORENTZ_TANGENT_C1, LORENTZ_X_C1,
                                         LORENTZ_Y_C1, X, Y)

TIERS = {np.float64: dict(rtol=1e-10, atol=1e-12),
         np.float32: dict(rtol=1e-5, atol=1e-6)}
GRAD_TIERS = {np.float64: dict(rtol=1e-10, atol=1e-12),
              np.float32: dict(rtol=1e-5, atol=1e-5)}
D = 4  # manifold dimension; ambient D + 1


def point(rng, c, scale=0.5, n=5):
    """Hyperboloid points exp_0(v) of origin tangents ‖v‖ ≲ scale·√D."""
    v = rng.standard_normal((n, D)) * scale
    r = np.linalg.norm(v, axis=-1, keepdims=True)
    sc = np.sqrt(c)
    return np.concatenate([np.cosh(sc * r) / sc,
                           np.sinh(sc * r) / (sc * r) * v], axis=-1)


def ambient(rng, c, n=5):
    return rng.standard_normal((n, D + 1)) * 0.4


def tangent_at(pts):
    """A tangent at the points made by ``pts`` (projected in numpy)."""
    def mk(rng, c):
        x = pts(rng, c)
        u = rng.standard_normal(x.shape) * 0.3
        mdot = -x[:, :1] * u[:, :1] + np.sum(x[:, 1:] * u[:, 1:], -1,
                                               keepdims=True)
        return x, u + c * mdot * x
    return mk


PT = lambda rng, c: point(rng, c)                       # noqa: E731
PT2 = lambda rng, c: point(rng, c, 0.35)                # noqa: E731
COORD = lambda rng, c: rng.standard_normal((5, D)) * 0.5  # noqa: E731

# name → (argument makers, call on either manifold); a maker returning a
# tuple supplies several arguments
METHODS = {
    "proju": ((PT, ambient), lambda m, x, u: m.proju(x, u)),
    "check_point": ((lambda rng, c: point(rng, c) * np.array(
        [1.0] + [1.01] * D),), lambda m, x: m.check_point(x)),
    "inner": ((PT, ambient, ambient),
              lambda m, x, u, v: m.inner(x, u, v)),
    "ptransp": ((tangent_at(PT), PT2),
                lambda m, x, v, y: m.ptransp(x, y, v)),
    "egrad2rgrad": ((PT, ambient), lambda m, x, g: m.egrad2rgrad(x, g)),
    "retr": ((tangent_at(PT),), lambda m, x, v: m.retr(x, v)),
    "logdetexp": ((PT, PT2), lambda m, x, y: m.logdetexp(x, y)),
    "logdetexp_from_coords": ((COORD,),
                              lambda m, v: m.logdetexp_from_coords(v)),
    "norm_t": ((tangent_at(PT),), lambda m, x, u: m.norm_t(x, u)),
    "ptransp0": ((PT, lambda rng, c: np.concatenate(
        [np.zeros((5, 1)), rng.standard_normal((5, D)) * 0.3], -1)),
        lambda m, y, v: m.ptransp0(y, v)),
    "expmap": ((tangent_at(PT),), lambda m, x, v: m.expmap(x, v)),
    "logmap": ((PT, PT2), lambda m, x, y: m.logmap(x, y)),
    "dist": ((PT, PT2), lambda m, x, y: m.dist(x, y)),
}


def _args(name, c, dt):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    out = []
    for mk in METHODS[name][0]:
        a = mk(rng, c)
        out += list(a) if isinstance(a, tuple) else [a]
    return [a.astype(dt) for a in out]


def _run(name, c, dt):
    """(JAX value, port value, JAX grads, port grads) of a method."""
    args = _args(name, c, dt)
    fn = METHODS[name][1]
    with jax.enable_x64(True):
        jargs = [jnp.asarray(a) for a in args]
        jc = jnp.asarray(c, dt)
        want = np.asarray(fn(JL(jc), *jargs))
        w = np.random.default_rng(7).standard_normal(want.shape).astype(dt)

        def loss(cc, *zs):
            return jnp.sum(jnp.tanh(fn(JL(cc), *zs)) * w)

        jg = jax.grad(loss, argnums=tuple(range(len(args) + 1)))(jc, *jargs)
    targs = [torch.as_tensor(a).requires_grad_() for a in args]
    tc = torch.tensor(c, dtype=targs[0].dtype, requires_grad=True)
    got = fn(TL(tc), *targs)
    loss_t = torch.sum(torch.tanh(got) * torch.as_tensor(w))
    tg = torch.autograd.grad(loss_t, [tc] + targs, allow_unused=True)
    return want, got.detach().numpy(), jg, tg


@pytest.mark.parametrize("name", sorted(METHODS))
@pytest.mark.parametrize("c", [1.0, 0.7])
def test_lorentz_method_matches_jax_f64(name, c):
    want, got, jg, tg = _run(name, c, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TIERS[np.float64])
    for a, b in zip(tg, jg):
        a = np.zeros(np.shape(b)) if a is None else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TIERS[np.float64])


@pytest.mark.parametrize("name", sorted(METHODS))
def test_lorentz_method_matches_jax_f32(name):
    want, got, jg, tg = _run(name, 0.8, np.float32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TIERS[np.float32])
    for a, b in zip(tg, jg):
        a = np.zeros(np.shape(b)) if a is None else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TIERS[np.float32])


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_lorentz_health_stats_match_jax(dt):
    x = point(np.random.default_rng(3), 0.7).astype(dt)
    x[:, 1] *= 1.001                                    # a little off
    with jax.enable_x64(True):
        want = JL(0.7).health_stats(jnp.asarray(x))
        want = {k: float(v) for k, v in want.items()}
    got = {k: float(v) for k, v in
           TL(0.7).health_stats(torch.as_tensor(x)).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TIERS[dt])


def test_lorentz_is_a_manifold_with_its_own_residual():
    m = TL(1.0)
    assert isinstance(m, Manifold)
    assert m.ambient_dim(10) == 11 and m.coord_dim(11) == 10
    x = torch.as_tensor(point(np.random.default_rng(0), 1.0))
    assert float(m.check_point(x).max()) < 1e-14
    off = x.clone()
    off[:, 0] *= 1.1
    assert float(m.check_point(off).min()) > 1e-3   # not the flat default
    with pytest.raises(NotImplementedError):
        Manifold().proju(x, x)                          # the core is abstract


def test_lorentz_golden_constants():
    m = TL(1.0)
    lx = torch.tensor(LORENTZ_X_C1, dtype=torch.float64)
    ly = torch.tensor(LORENTZ_Y_C1, dtype=torch.float64)
    np.testing.assert_allclose(float(m.dist(lx, ly)), LORENTZ_DIST_C1,
                               rtol=1e-12)
    got = m.expmap(lx, torch.tensor(LORENTZ_TANGENT_C1, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), LORENTZ_EXPMAP_C1, rtol=1e-12,
                               atol=1e-12)
    # the golden tangent lies in T_x: proju leaves it, the inner of x with
    # it is 0, and egrad2rgrad of the time-flipped vector returns it
    t = torch.tensor(LORENTZ_TANGENT_C1, dtype=torch.float64)
    np.testing.assert_allclose(m.proju(lx, t).numpy(), t.numpy(), atol=1e-15)
    assert abs(float(m.inner(lx, lx, t))) < 1e-15
    flipped = torch.cat([-t[:1], t[1:]])
    np.testing.assert_allclose(m.egrad2rgrad(lx, flipped).numpy(),
                               t.numpy(), atol=1e-15)
    # transport along a geodesic keeps the tangent's norm
    u = m.ptransp(lx, ly, m.proju(lx, t))
    np.testing.assert_allclose(float(m.inner(ly, u, u)),
                               float(m.inner(lx, t, t)), rtol=1e-12)
    assert abs(float(m.inner(ly, ly, u))) < 1e-14
    m2 = TL(0.7)
    lift = lambda s: torch.cat([torch.sqrt(                # noqa: E731
        1 / torch.tensor(0.7, dtype=torch.float64) + torch.sum(s * s))[None],
        s])
    np.testing.assert_allclose(
        float(m2.dist(lift(torch.tensor(X)), lift(torch.tensor(Y)))),
        LORENTZ_DIST_C07, rtol=1e-12)


EUCLID = {
    "proj": ((ambient,), lambda m, x: m.proj(x)),
    "proju": ((ambient, ambient), lambda m, x, u: m.proju(x, u)),
    "expmap": ((ambient, ambient), lambda m, x, v: m.expmap(x, v)),
    "logmap": ((ambient, ambient), lambda m, x, y: m.logmap(x, y)),
    "sqdist": ((ambient, ambient), lambda m, x, y: m.sqdist(x, y)),
    "dist": ((ambient, ambient), lambda m, x, y: m.dist(x, y)),
    "inner": ((ambient, ambient, ambient),
              lambda m, x, u, v: m.inner(x, u, v)),
    "inner_keep": ((ambient, ambient, ambient),
                   lambda m, x, u, v: m.inner(x, u, v, True)),
    "ptransp": ((ambient, ambient, ambient),
                lambda m, x, y, v: m.ptransp(x, y, v)),
    "egrad2rgrad": ((ambient, ambient), lambda m, x, g: m.egrad2rgrad(x, g)),
    "retr": ((ambient, ambient), lambda m, x, v: m.retr(x, v)),
    "expmap0": ((ambient,), lambda m, v: m.expmap0(v)),
    "logdetexp": ((ambient, ambient), lambda m, x, y: m.logdetexp(x, y)),
    "check_point": ((ambient,), lambda m, x: m.check_point(x)),
}


@pytest.mark.parametrize("name", sorted(EUCLID))
def test_euclidean_matches_jax(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    makers, fn = EUCLID[name]
    args = [mk(rng, 1.0) for mk in makers]
    with jax.enable_x64(True):
        want = np.asarray(fn(JE(), *[jnp.asarray(a) for a in args]))
    got = fn(TE(), *[torch.as_tensor(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, **TIERS[np.float64])
    assert TE().origin((2, 3)).shape == (2, 3) and TE().c == 0.0

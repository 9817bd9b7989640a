"""The port's Poincaré ball, its manifold defaults, the ball ↔ hyperboloid
tangent maps and the new ``smath`` helpers against the JAX package, on
the CPU.

Each method gets the same numpy inputs on both sides; values and
gradients (of a weighted tanh of the output, to every tensor input and to
a tensor curvature) are compared in float64 under JAX's scoped
``enable_x64`` at rtol 1e-10 (the same formulas, summed in other
orders), and in float32 at rtol 1e-5, atol 1e-6 (gradients atol 1e-5:
two float32 backward passes that round apart).  The mpmath constants of
``tests/manifolds/test_golden.py`` hold the float64 methods to the
published closed forms.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.manifolds import PoincareBall as JB
from hyperspace_tpu.manifolds import maps as JMAPS
from hyperspace_tpu.manifolds import smath as js
from hyperspace_torch.manifolds import Manifold
from hyperspace_torch.manifolds import PoincareBall as TB
from hyperspace_torch.manifolds import maps as TMAPS
from hyperspace_torch.manifolds import smath as ts
from tests.manifolds.test_golden import (POINCARE_DIST_C07, POINCARE_DIST_C1,
                                         POINCARE_EXPMAP_C07,
                                         POINCARE_EXPMAP_C1,
                                         POINCARE_PTRANSP_C1, V, X, Y)

TIERS = {np.float64: dict(rtol=1e-10, atol=1e-12),
         np.float32: dict(rtol=1e-5, atol=1e-6)}
GRAD_TIERS = {np.float64: dict(rtol=1e-10, atol=1e-12),
              np.float32: dict(rtol=1e-5, atol=1e-5)}


def ball(rng, shape, c, scale=0.8):
    v = rng.standard_normal(shape)
    r = rng.uniform(0.05, scale, shape[:-1] + (1,)) / np.sqrt(c)
    return v / np.linalg.norm(v, axis=-1, keepdims=True) * r


def tangent(rng, shape, scale=0.4):
    return rng.standard_normal(shape) * scale


# name → (argument makers, JAX call, port call); an argument maker takes
# (rng, c) and returns a numpy array, or a Python number left as is
D = 5
PT = lambda rng, c: ball(rng, (4, D), c)               # noqa: E731
PT2 = lambda rng, c: ball(rng, (4, D), c, 0.6)         # noqa: E731
TAN = lambda rng, c: tangent(rng, (4, D))               # noqa: E731
OUT = lambda rng, c: ball(rng, (4, D), c, 1.6)          # noqa: E731
MAT = lambda rng, c: rng.standard_normal((D, 3)) * 0.4  # noqa: E731

METHODS = {
    "lambda_x": ((PT,), lambda m, x: m.lambda_x(x),
                 lambda m, x: m.lambda_x(x)),
    "lambda_x_flat": ((PT,), lambda m, x: m.lambda_x(x, keepdims=False),
                      lambda m, x: m.lambda_x(x, keepdim=False)),
    "proj": ((OUT,), lambda m, x: m.proj(x), lambda m, x: m.proj(x)),
    "proju": ((PT, TAN), lambda m, x, u: m.proju(x, u),
              lambda m, x, u: m.proju(x, u)),
    "check_point": ((OUT,), lambda m, x: m.check_point(x),
                    lambda m, x: m.check_point(x)),
    "mobius_add": ((PT, PT2), lambda m, x, y: m.mobius_add(x, y),
                   lambda m, x, y: m.mobius_add(x, y)),
    "mobius_neg": ((PT,), lambda m, x: m.mobius_neg(x),
                   lambda m, x: m.mobius_neg(x)),
    "mobius_scalar_mul": ((PT,), lambda m, x: m.mobius_scalar_mul(-1.7, x),
                          lambda m, x: m.mobius_scalar_mul(-1.7, x)),
    "mobius_matvec": ((MAT, PT), lambda m, a, x: m.mobius_matvec(a, x),
                      lambda m, a, x: m.mobius_matvec(a, x)),
    "gyration": ((PT, PT2, TAN), lambda m, u, v, w: m.gyration(u, v, w),
                 lambda m, u, v, w: m.gyration(u, v, w)),
    "expmap": ((PT, TAN), lambda m, x, v: m.expmap(x, v),
               lambda m, x, v: m.expmap(x, v)),
    "logmap": ((PT, PT2), lambda m, x, y: m.logmap(x, y),
               lambda m, x, y: m.logmap(x, y)),
    "expmap0": ((TAN,), lambda m, v: m.expmap0(v),
                lambda m, v: m.expmap0(v)),
    "logmap0": ((PT,), lambda m, y: m.logmap0(y),
                lambda m, y: m.logmap0(y)),
    "sqdist": ((PT, PT2), lambda m, x, y: m.sqdist(x, y),
               lambda m, x, y: m.sqdist(x, y)),
    "dist": ((PT, PT2), lambda m, x, y: m.dist(x, y),
             lambda m, x, y: m.dist(x, y)),
    "dist0": ((PT,), lambda m, x: m.dist0(x), lambda m, x: m.dist0(x)),
    "dist0_keep": ((PT,), lambda m, x: m.dist0(x, keepdims=True),
                   lambda m, x: m.dist0(x, keepdim=True)),
    "inner": ((PT, TAN, TAN), lambda m, x, u, v: m.inner(x, u, v),
              lambda m, x, u, v: m.inner(x, u, v)),
    "norm_t": ((PT, TAN), lambda m, x, u: m.norm_t(x, u),
               lambda m, x, u: m.norm_t(x, u)),
    "ptransp": ((PT, PT2, TAN), lambda m, x, y, v: m.ptransp(x, y, v),
                lambda m, x, y, v: m.ptransp(x, y, v)),
    "ptransp0": ((PT, TAN), lambda m, y, v: m.ptransp0(y, v),
                 lambda m, y, v: m.ptransp0(y, v)),
    "egrad2rgrad": ((PT, TAN), lambda m, x, g: m.egrad2rgrad(x, g),
                    lambda m, x, g: m.egrad2rgrad(x, g)),
    "retr": ((PT, TAN), lambda m, x, v: m.retr(x, v),
             lambda m, x, v: m.retr(x, v)),
    "tangent_from_origin_coords": (
        (TAN,), lambda m, v: m.tangent_from_origin_coords(v),
        lambda m, v: m.tangent_from_origin_coords(v)),
    "origin_coords_from_tangent": (
        (TAN,), lambda m, u: m.origin_coords_from_tangent(u),
        lambda m, u: m.origin_coords_from_tangent(u)),
    "logdetexp": ((PT, PT2), lambda m, x, y: m.logdetexp(x, y),
                  lambda m, x, y: m.logdetexp(x, y)),
    "logdetexp_from_coords": ((TAN,), lambda m, v: m.logdetexp_from_coords(v),
                              lambda m, v: m.logdetexp_from_coords(v)),
    "gyromidpoint": ((lambda rng, c: ball(rng, (3, 4, D), c),),
                     lambda m, x: m.gyromidpoint(x),
                     lambda m, x: m.gyromidpoint(x)),
    "gyromidpoint_w": ((lambda rng, c: ball(rng, (3, 4, D), c),
                        lambda rng, c: rng.uniform(0.1, 1.0, (3, 4))),
                       lambda m, x, w: m.gyromidpoint(x, w),
                       lambda m, x, w: m.gyromidpoint(x, w)),
}


def _run(name, c, dt, c_tensor, grads=True):
    """(JAX value, port value, JAX grads, port grads) of a method."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    makers, jf, tf = METHODS[name]
    args = [mk(rng, c).astype(dt) for mk in makers]
    out_shape = None
    with jax.enable_x64(True):
        jargs = [jnp.asarray(a) for a in args]
        jc = jnp.asarray(c, dt) if c_tensor else c
        want = np.asarray(jf(JB(jc), *jargs))
        out_shape = want.shape
        w = np.random.default_rng(7).standard_normal(out_shape).astype(dt)

        def loss(cc, *zs):
            return jnp.sum(jnp.tanh(jf(JB(cc), *zs)) * w)

        argnums = tuple(range(len(args) + 1)) if c_tensor else tuple(
            range(1, len(args) + 1))
        jg = jax.grad(loss, argnums=argnums)(jc, *jargs) if grads else ()
    targs = [torch.as_tensor(a).requires_grad_() for a in args]
    tc = torch.tensor(c, dtype=targs[0].dtype, requires_grad=True) \
        if c_tensor else c
    got = tf(TB(tc), *targs)
    tg = ()
    if grads:
        loss_t = torch.sum(torch.tanh(got) * torch.as_tensor(w))
        wrt = ([tc] if c_tensor else []) + targs
        tg = torch.autograd.grad(loss_t, wrt, allow_unused=True)
    return want, got.detach().numpy(), jg, tg


@pytest.mark.parametrize("name", sorted(METHODS))
@pytest.mark.parametrize("c", [1.0, 0.7, 2.3])
def test_method_matches_jax_f64(name, c):
    want, got, jg, tg = _run(name, c, np.float64, c_tensor=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TIERS[np.float64])
    for a, b in zip(tg, jg):
        a = np.zeros(np.shape(b)) if a is None else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TIERS[np.float64])


@pytest.mark.parametrize("name", sorted(METHODS))
def test_method_matches_jax_f32(name):
    want, got, jg, tg = _run(name, 0.8, np.float32, c_tensor=True)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TIERS[np.float32])
    for a, b in zip(tg, jg):
        a = np.zeros(np.shape(b)) if a is None else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TIERS[np.float32])


def test_number_and_tensor_curvature_agree():
    for name in ("expmap", "logmap", "ptransp", "mobius_matvec"):
        a = _run(name, 1.3, np.float64, c_tensor=False)
        b = _run(name, 1.3, np.float64, c_tensor=True)
        np.testing.assert_array_equal(a[1], b[1])


def test_mobius_matvec_zero_rows_go_to_the_origin():
    rng = np.random.default_rng(3)
    x = ball(rng, (6, 4), 1.0)
    x[2] = 0.0
    m = rng.standard_normal((4, 3))
    m[:, :] *= 0.5
    x[4] = [1e-3, 0.0, 0.0, 0.0]
    m[0, :] = 0.0                      # M x = 0 on row 4 (and row 2)
    with jax.enable_x64(True):
        want = np.asarray(JB(1.0).mobius_matvec(jnp.asarray(m),
                                                jnp.asarray(x)))
    got = TB(1.0).mobius_matvec(torch.as_tensor(m), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-14)
    assert np.all(got.numpy()[[2, 4]] == 0.0)


def test_health_stats_and_defaults_match_jax():
    rng = np.random.default_rng(4)
    x = ball(rng, (9, 6), 0.5, 0.999)
    with jax.enable_x64(True):
        m = JB(0.5)
        want = {k: float(v) for k, v in m.health_stats(jnp.asarray(x)).items()}
        jz = np.asarray(m.zero_tangent(jnp.asarray(x)))
        jo = np.asarray(m.origin((2, 6), jnp.float64))
        dims = (m.ambient_dim(6), m.coord_dim(6))
    tm = TB(0.5)
    got = {k: float(v) for k, v in tm.health_stats(torch.as_tensor(x)).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    np.testing.assert_array_equal(tm.zero_tangent(torch.as_tensor(x)).numpy(),
                                  jz)
    np.testing.assert_array_equal(tm.origin((2, 6), torch.float64).numpy(),
                                  jo)
    assert (tm.ambient_dim(6), tm.coord_dim(6)) == dims
    assert isinstance(tm, Manifold)


def test_random_normal_is_the_wrapped_normal_of_its_draws():
    """Other bits than JAX's from one seed; the same map of the same
    draws: proj(expmap0(std · N(0, 1)))."""
    g1 = torch.Generator().manual_seed(5)
    got = TB(0.7).random_normal(g1, (50, 4), torch.float64, std=0.3)
    g2 = torch.Generator().manual_seed(5)
    v = 0.3 * torch.randn((50, 4), generator=g2, dtype=torch.float64)
    with jax.enable_x64(True):
        m = JB(0.7)
        want = np.asarray(m.proj(m.expmap0(jnp.asarray(v.numpy()))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    assert np.all(np.linalg.norm(got.numpy(), axis=-1) < 1 / np.sqrt(0.7))


def test_manifold_flat_defaults():
    x = torch.zeros((3, 4), dtype=torch.float64)
    y = torch.zeros((2, 1, 4), dtype=torch.float64)
    base = Manifold()
    assert base.check_point(x).shape == (3,)
    assert base.logdetexp(x, y).shape == (2, 3)
    assert base.logdetexp_from_coords(x).shape == (3,)
    stats = base.health_stats(x)
    assert float(stats["violation_max"]) == 0.0


def _golden(m, fn, *args):
    return fn(m, *[torch.as_tensor(np.asarray(a, np.float64)) for a in args])


def test_golden_constants():
    tol = dict(rtol=1e-12, atol=1e-14)
    for c, want in ((1.0, POINCARE_DIST_C1), (0.7, POINCARE_DIST_C07)):
        np.testing.assert_allclose(
            float(_golden(TB(c), lambda m, x, y: m.dist(x, y), X, Y)), want,
            **tol)
    for c, want in ((1.0, POINCARE_EXPMAP_C1), (0.7, POINCARE_EXPMAP_C07)):
        np.testing.assert_allclose(
            _golden(TB(c), lambda m, x, v: m.expmap(x, v), X, V).numpy(),
            want, **tol)
    np.testing.assert_allclose(
        _golden(TB(1.0), lambda m, x, y, v: m.ptransp(x, y, v), X, Y,
                V).numpy(), POINCARE_PTRANSP_C1, **tol)


@pytest.mark.parametrize("fn", ["arcsin_safe", "sinc_", "artanc"])
@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_smath_helpers_match_jax(fn, dt):
    x = np.array([0.0, 1e-5, -4e-4, 0.3, -0.9, 0.999999, -1.0, 1.0, 2.5])
    if fn == "sinc_":
        x = np.concatenate([x, [12.0, -40.0]])
    x = x.astype(dt)
    with jax.enable_x64(True):
        want = np.asarray(getattr(js, fn)(jnp.asarray(x)))
        jg = np.asarray(jax.grad(lambda z: jnp.sum(getattr(js, fn)(z)))(
            jnp.asarray(x)))
    t = torch.as_tensor(x).requires_grad_()
    got = getattr(ts, fn)(t)
    (tg,) = torch.autograd.grad(got.sum(), t)
    tier = TIERS[dt]
    np.testing.assert_allclose(got.detach().numpy(), want, **tier)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=tier["rtol"],
                               atol=1e-5 if dt == np.float32 else 1e-12)


@pytest.mark.parametrize("c", [1.0, 0.6])
@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_tangent_maps_match_jax_pushforwards(c, dt):
    rng = np.random.default_rng(8)
    y = ball(rng, (7, 4), c).astype(dt)
    u = tangent(rng, (7, 4)).astype(dt)
    with jax.enable_x64(True):
        jl = JMAPS.ball_to_lorentz(jnp.asarray(y), c)
        jv = JMAPS.ball_tangent_to_lorentz(jnp.asarray(y), jnp.asarray(u), c)
        back = JMAPS.lorentz_tangent_to_ball(jl, jv, c)
        want = [np.asarray(jv), np.asarray(back)]
    tl = TMAPS.ball_to_lorentz(torch.as_tensor(y), c)
    tv = TMAPS.ball_tangent_to_lorentz(torch.as_tensor(y), torch.as_tensor(u),
                                       c)
    tb = TMAPS.lorentz_tangent_to_ball(tl, tv, c)
    tier = TIERS[dt]
    np.testing.assert_allclose(tv.numpy(), want[0], **tier)
    np.testing.assert_allclose(tb.numpy(), want[1], **tier)
    np.testing.assert_allclose(tb.numpy(), u, rtol=tier["rtol"] * 10,
                               atol=tier["atol"] * 10)


def test_tangent_maps_carry_a_curvature_gradient():
    rng = np.random.default_rng(9)
    y, u = ball(rng, (5, 3), 1.0), tangent(rng, (5, 3))
    with jax.enable_x64(True):
        want = jax.grad(lambda cc: jnp.sum(JMAPS.lorentz_tangent_to_ball(
            JMAPS.ball_to_lorentz(jnp.asarray(y), cc),
            JMAPS.ball_tangent_to_lorentz(jnp.asarray(y), jnp.asarray(u), cc),
            cc) ** 3) + jnp.sum(JMAPS.ball_tangent_to_lorentz(
            jnp.asarray(y), jnp.asarray(u), cc)))(0.9)
    c = torch.tensor(0.9, dtype=torch.float64, requires_grad=True)
    ty, tu = torch.as_tensor(y), torch.as_tensor(u)
    val = torch.sum(TMAPS.lorentz_tangent_to_ball(
        TMAPS.ball_to_lorentz(ty, c), TMAPS.ball_tangent_to_lorentz(ty, tu, c),
        c) ** 3) + torch.sum(TMAPS.ball_tangent_to_lorentz(ty, tu, c))
    (g,) = torch.autograd.grad(val, c)
    np.testing.assert_allclose(float(g), float(want), rtol=1e-10)

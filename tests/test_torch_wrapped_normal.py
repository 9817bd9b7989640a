"""The port's wrapped normal (``nn/wrapped_normal.py``) against the JAX
package's on both latent geometries, on the CPU.

Both sides take the same standard-normal draw: JAX draws it from its
key inside ``rsample``, and the test draws the same numbers from the
same key and hands them to the port as ``eps``.  The locations sit at
geodesic radius ≲ 1.2 and the samples within about 2 of them, where the
hyperboloid's ``logmap`` (which ``log_prob`` takes) does not cancel in
float32.  Tolerances: float64 rtol 1e-10 (atol 1e-12), float32 rtol
1e-5 (atol 1e-6).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.manifolds import Lorentz as JL
from hyperspace_tpu.manifolds import PoincareBall as JP
from hyperspace_tpu.nn import wrapped_normal as jwn
from hyperspace_torch.manifolds import Lorentz as TL
from hyperspace_torch.manifolds import PoincareBall as TP
from hyperspace_torch.nn import wrapped_normal as twn

B, D = 24, 4
DTYPES = {"f64": (jnp.float64, torch.float64, dict(rtol=1e-10, atol=1e-12)),
          "f32": (jnp.float32, torch.float32, dict(rtol=1e-5, atol=1e-6))}


def _case(kind, c, dt, sample_shape=()):
    """(JAX distribution, port distribution, JAX key, the draw)."""
    jdt, tdt, _ = DTYPES[dt]
    rng = np.random.default_rng(zlib.crc32(f"{kind}{c}{dt}".encode()))
    jm, tm = (JP(c), TP(c)) if kind == "poincare" else (JL(c), TL(c))
    loc_coords = rng.standard_normal((B, D)) * 0.3
    scale = rng.uniform(0.2, 0.6, (B, D))
    with jax.enable_x64(True):
        loc = np.asarray(jm.expmap0(jm.tangent_from_origin_coords(
            jnp.asarray(loc_coords))))
        jq = jwn.WrappedNormal(jm, jnp.asarray(loc, jdt),
                               jnp.asarray(scale, jdt))
        key = jax.random.PRNGKey(zlib.crc32(kind.encode()) % 1000)
        eps = np.asarray(jax.random.normal(key, tuple(sample_shape) + (B, D),
                                           jdt))
    tq = twn.WrappedNormal(tm, torch.as_tensor(loc).to(tdt),
                           torch.as_tensor(scale).to(tdt))
    return jq, tq, key, torch.as_tensor(eps)


def _close(got, want, dt, what):
    np.testing.assert_allclose(got.detach().double().numpy(),
                               np.asarray(want, np.float64), err_msg=what,
                               **DTYPES[dt][2])


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("c", [1.0, 0.7])
@pytest.mark.parametrize("kind", ["poincare", "lorentz"])
def test_rsample_and_log_prob_match_jax(kind, c, dt):
    jq, tq, key, eps = _case(kind, c, dt)
    with jax.enable_x64(True):
        jz = jq.rsample(key)
        jlp = jq.log_prob(jz)
        jz2, jlp2 = jq.sample_and_log_prob(key)
    z = tq.rsample(eps=eps)
    assert z.dtype == DTYPES[dt][1] and tq.dim == D
    _close(z, jz, dt, "rsample")
    _close(tq.log_prob(torch.as_tensor(np.asarray(jz))), jlp, dt, "log_prob")
    z2, lp2 = tq.sample_and_log_prob(eps=eps)
    _close(z2, jz2, dt, "sample_and_log_prob z")
    _close(lp2, jlp2, dt, "sample_and_log_prob lp")


@pytest.mark.parametrize("kind", ["poincare", "lorentz"])
def test_sample_shape_and_prior_match_jax(kind):
    """Three samples a location, and the prior WrappedNormal(origin, 1)
    of the HVAE evaluated at them (float64)."""
    jq, tq, key, eps = _case(kind, 1.0, "f64", sample_shape=(3,))
    with jax.enable_x64(True):
        jz = jq.rsample(key, (3,))
        jm = jq.manifold
        amb = jz.shape[-1]
        jprior = jwn.WrappedNormal(jm, jm.origin((amb,), jnp.float64),
                                   jnp.ones((D,), jnp.float64))
        jlp = jprior.log_prob(jz)
    z = tq.rsample(None, (3,), eps=eps)
    assert tuple(z.shape) == (3, B, amb)
    _close(z, jz, "f64", "rsample (3,)")
    tm = tq.manifold
    prior = twn.WrappedNormal(tm, tm.origin((amb,), torch.float64, "cpu"),
                              torch.ones(D, dtype=torch.float64))
    _close(prior.log_prob(torch.as_tensor(np.asarray(jz))), jlp, "f64",
           "prior log_prob")


def test_rsample_draws_from_the_generator_and_checks_eps():
    _, tq, _, eps = _case("poincare", 1.0, "f32")
    a = tq.rsample(torch.Generator().manual_seed(4))
    b = tq.rsample(torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tq.rsample(eps=eps[:3])


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_log_normal_matches_jax(dt):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(11)
    v = rng.standard_normal((7, 5)) * 2.0
    s = rng.uniform(0.01, 3.0, (7, 5))
    with jax.enable_x64(True):
        want = np.asarray(jwn._log_normal(jnp.asarray(v, jdt),
                                          jnp.asarray(s, jdt)))
    got = twn._log_normal(torch.as_tensor(v).to(tdt),
                          torch.as_tensor(s).to(tdt))
    assert got.shape == (7,) and got.dtype == tdt
    _close(got, want, dt, "_log_normal")

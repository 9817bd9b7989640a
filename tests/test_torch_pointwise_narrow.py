"""The seven row-wise Poincaré ops on narrow rows against the JAX
package's twins, on the CPU (the port's plain versions).

The widths are the ones the packed kernel (``csrc/pointwise.cu``, d ≤ 16)
serves on the card: d = 10, the WordNet table's (``configs/
poincare_wordnet.yaml``), and d = 8, the HVAE latent's (``configs/
hvae_mnist.yaml``), at row counts below and off a warp's 32 rows.

Tolerances: float64 against the twins (``_t_<op>``, under JAX's scoped
``enable_x64``): rtol 1e-10, atol 1e-12 (the same formulas, other
libraries' transcendentals); float32: rtol 2e-5, atol 2e-6, a tenth of
the kernels' tier (both sides evaluate the same f32 chain, in other
orders and libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.kernels import pointwise as JPW
from hyperspace_torch import kernels as TK

OPS = ["mobius_add", "mobius_scalar_mul", "expmap", "logmap", "expmap0",
       "logmap0", "ptransp"]


def ball_points(rng, shape, c, scale=0.8):
    v = rng.standard_normal(shape)
    v = v / (1.0 + np.linalg.norm(v, axis=-1, keepdims=True))
    return v * scale / np.sqrt(c)


def op_args(rng, op, shape, c):
    x = ball_points(rng, shape, c)
    y = ball_points(rng, shape, c, scale=0.5)
    v = rng.standard_normal(shape) * 0.3
    return {"mobius_add": [x, y], "mobius_scalar_mul": [x],
            "expmap": [x, v], "logmap": [x, y], "expmap0": [v],
            "logmap0": [y], "ptransp": [x, y, v]}[op]


def twin(op, tensors, c, r):
    fn = getattr(JPW, f"_t_{op}")
    jt = [jnp.asarray(t) for t in tensors]
    return np.asarray(fn(jt[0], r, c) if op == "mobius_scalar_mul"
                      else fn(*jt, c))


def port(op, tensors, c, r):
    fn = getattr(TK, op)
    ts = [torch.as_tensor(t) for t in tensors]
    return (fn(r, *ts, c) if op == "mobius_scalar_mul" else fn(*ts, c))


@pytest.mark.parametrize("c", [1.0, 0.5, 2.3])
@pytest.mark.parametrize("d", [8, 10])
@pytest.mark.parametrize("op", OPS)
def test_narrow_rows_match_jax_twins_f64(op, d, c):
    rng = np.random.default_rng(10 * d + int(10 * c))
    for n in (5, 33, 100):
        tensors = op_args(rng, op, (n, d), c)
        with jax.enable_x64(True):
            want = twin(op, tensors, c, 0.7)
        got = port(op, tensors, c, 0.7)
        assert got.dtype == torch.float64 and got.shape == (n, d)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("d", [8, 10])
@pytest.mark.parametrize("op", OPS)
def test_narrow_rows_match_jax_twins_f32(op, d):
    rng = np.random.default_rng(d)
    tensors = [t.astype(np.float32) for t in op_args(rng, op, (70, d), 1.0)]
    want = twin(op, tensors, 1.0, 0.7)
    got = port(op, tensors, 1.0, 0.7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("d", [8, 10])
def test_narrow_rows_edge_cases_match_jax_twins(d):
    """Zero rows, points past the proj margin, x = y, and a [d] operand
    broadcast against [n, d], in float64."""
    rng = np.random.default_rng(d + 1)
    x = ball_points(rng, (40, d), 1.3)
    x[3] = 0.0
    big = rng.standard_normal((40, d)) * 40.0
    big[7] = 0.0
    b = ball_points(rng, (d,), 1.3, 0.3)
    cases = [("expmap", [x, big]), ("expmap0", [big]), ("logmap0", [x]),
             ("logmap", [x, x]), ("ptransp", [x, x, big]),
             ("mobius_add", [x, np.broadcast_to(b, x.shape)]),
             ("mobius_scalar_mul", [x])]
    for op, tensors in cases:
        with jax.enable_x64(True):
            want = twin(op, tensors, 1.3, -1.5)
        got = port(op, [np.ascontiguousarray(t) for t in tensors], 1.3, -1.5)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12,
                                   err_msg=op)
    got = port("mobius_add", [x, b], 1.3, None).numpy()
    with jax.enable_x64(True):
        want = twin("mobius_add", [x, np.broadcast_to(b, x.shape)], 1.3, None)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)

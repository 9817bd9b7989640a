"""The port's kernel modules against the JAX package, on the CPU.

Both sides get the same numpy inputs made from a seed.  On a CPU tensor
the port's wrappers run their plain PyTorch versions; the JAX side runs
its Pallas kernels in interpret mode or through its XLA twin (bitwise
equal to interpret mode for ``scan_topk``).

Tolerances:
- float32 distances: rtol 1e-5, atol 1e-4 — the two sides sum the Gram
  products in different orders.
- Near the ball boundary and on duplicate rows the Gram form cancels,
  so those rows are compared through the arcosh argument
  u = cosh(√c·d) − 1 within twice the Gram form's forward-error bound
  (``u_bound``: the cancelling numerator plus the denominator factors'
  relative error; hyperboloid: (D + 2)·eps·c·Σ|x_i y_i|), in float32
  and in float64.
- ids are equal wherever neighbouring distances differ by more than the
  distance tolerance; inside a run of near-ties the id sets are equal.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hyperspace_tpu.kernels import distmat as jdist
from hyperspace_tpu.kernels import scan_topk as jscan
from hyperspace_torch.kernels import distmat, scan_topk
from hyperspace_torch.kernels._support import topk_disagreements

RTOL, ATOL = 1e-5, 1e-4
C = 1.3


def ball_rows(rng, n, d, c=C, r_max=0.9):
    """Points with scaled radius uniform in [0, r_max)."""
    v = rng.standard_normal((n, d))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * rng.uniform(0.0, r_max, (n, 1)) / np.sqrt(c)


def to_lorentz(y, c=C):
    """The ball → hyperboloid isometry, in float64 numpy."""
    y2 = np.sum(y * y, axis=1, keepdims=True)
    den = 1.0 - c * y2
    return np.concatenate([(1.0 + c * y2) / (np.sqrt(c) * den),
                           2.0 * y / den], axis=1)


def hard_rows(rng, d, c=C):
    """Rows at scaled radius 1 − 1e-3, interior rows, and duplicates."""
    edge = ball_rows(rng, 12, d, c)
    edge *= (1.0 - 1e-3) / np.sqrt(c) / np.linalg.norm(edge, axis=1,
                                                       keepdims=True)
    inner = ball_rows(rng, 20, d, c)
    return np.concatenate([edge, inner, edge[:4], inner[:4]])


def u_bound(x, y, c, manifold, eps, u):
    """Forward-error bound of the Gram form's arcosh argument ``u``
    ([n, m]): the cancelling numerator and, on the ball, the relative
    error of each (1 − c‖·‖²) factor of the denominator."""
    d = x.shape[1]
    ax, ay = np.abs(x), np.abs(y)
    if manifold == "lorentz":
        return (d + 2) * eps * c * (ax @ ay.T)
    xx = np.sum(x * x, 1)[:, None]
    yy = np.sum(y * y, 1)[None, :]
    fx, fy = np.abs(1.0 - c * xx), np.abs(1.0 - c * yy)
    num = (d + 2) * eps * (xx + yy + 2.0 * (ax @ ay.T)) * 2.0 * c / (fx * fy)
    return num + (d + 2) * eps * c * (xx / fx + yy / fy) * u


def assert_u_close(d_port, d_ref, x, y, c, manifold, eps, rtol):
    sc = np.sqrt(c)
    u_p = 2.0 * np.sinh(sc * np.asarray(d_port, np.float64) / 2.0) ** 2
    u_r = 2.0 * np.sinh(sc * np.asarray(d_ref, np.float64) / 2.0) ** 2
    tol = rtol * np.abs(u_r) + 2.0 * u_bound(x, y, c, manifold, eps, u_r)
    assert np.all(np.abs(u_p - u_r) <= tol)


def _rows(rng, manifold, n, d):
    y = ball_rows(rng, n, d)
    return to_lorentz(y) if manifold == "lorentz" else y


CASES = [("poincare", 3), ("poincare", 10), ("lorentz", 10)]


@pytest.mark.parametrize("manifold,d", CASES)
@pytest.mark.parametrize("ref", ["interpret", "xla"])
def test_pdist_matches_jax_f32(monkeypatch, manifold, d, ref):
    """Well-conditioned rows in float32 against the Pallas kernel run
    by the interpreter and against the XLA twin."""
    monkeypatch.setenv("HYPERSPACE_KERNELS", ref)
    rng = np.random.default_rng(1)
    x = _rows(rng, manifold, 37, d).astype(np.float32)
    y = _rows(rng, manifold, 300, d).astype(np.float32)
    want = np.asarray(jdist.pdist(jnp.asarray(x), jnp.asarray(y), C,
                                  manifold=manifold))
    got = distmat.pdist(torch.from_numpy(x), torch.from_numpy(y), C,
                        manifold=manifold)
    assert got.dtype == torch.float32 and got.shape == (37, 300)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("manifold,d", CASES)
@pytest.mark.parametrize("dtype,eps,rtol", [
    (np.float32, 2.0 ** -24, 1e-5), (np.float64, 2.0 ** -53, 1e-12)])
def test_pdist_boundary_and_duplicates(manifold, d, dtype, eps, rtol):
    """Rows at radius 1 − 1e-3 and duplicate rows against the XLA twin,
    in the arcosh argument within the Gram form's error bound."""
    rng = np.random.default_rng(2)
    y = hard_rows(rng, d)
    x = to_lorentz(y) if manifold == "lorentz" else y
    x = x.astype(dtype)
    want = np.asarray(jdist.pdist(jnp.asarray(x), jnp.asarray(x), C,
                                  manifold=manifold))
    got = distmat.pdist(torch.from_numpy(x), torch.from_numpy(x), C,
                        manifold=manifold).numpy()
    assert got.dtype == dtype and np.all(np.isfinite(got))
    x64 = x.astype(np.float64)
    assert_u_close(got, want, x64, x64, C, manifold, eps, rtol)


def test_pdist_f64_matches_twin_tightly():
    """float64 interior rows: the same closed form to 1e-12."""
    rng = np.random.default_rng(3)
    x, y = ball_rows(rng, 20, 10), ball_rows(rng, 50, 10)
    want = np.asarray(jdist.pdist(jnp.asarray(x), jnp.asarray(y), C,
                                  manifold="poincare"))
    got = distmat.pdist(torch.from_numpy(x), torch.from_numpy(y), C,
                        manifold="poincare").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_pdist_rejects_unknown_manifold():
    x = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="unknown manifold"):
        distmat.pdist(x, x, 1.0, manifold="sphere")


SCAN_KINDS = [("poincare", 10, C), ("lorentz", 10, C), ("euclidean", 3, 0.0)]


def _scan_inputs(rng, kind, d, m, b):
    if kind == "euclidean":
        slab = rng.standard_normal((m, d))
        q = rng.standard_normal((b, d))
    else:
        slab, q = _rows(rng, kind, m, d), _rows(rng, kind, b, d)
    return slab.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("kind,d,c", SCAN_KINDS)
@pytest.mark.parametrize("k", [1, 10, 256])
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("col0,n_cut", [(0, 0), (700, 93)])
def test_scan_topk_matches_jax(kind, d, c, k, exclude_self, col0, n_cut):
    """Several 128-row tiles on the JAX side; ``n`` below the slab end
    and a shard offset ``col0`` on half the cases."""
    rng = np.random.default_rng(4)
    m, b = 1200, 37
    slab, q = _scan_inputs(rng, kind, d, m, b)
    qi = rng.integers(col0, col0 + m, b).astype(np.int32)
    n = col0 + m - n_cut
    spec = (kind, c)
    wd, wi = jscan.scan_topk(jnp.asarray(slab), jnp.asarray(q),
                             jnp.asarray(qi), col0, spec=spec, k=k, n=n,
                             exclude_self=exclude_self, tile_rows=128)
    gd, gi = scan_topk.scan_topk(torch.from_numpy(slab), torch.from_numpy(q),
                                 torch.from_numpy(qi), col0, spec=spec, k=k,
                                 n=n, exclude_self=exclude_self)
    assert gd.shape == gi.shape == (b, k)
    assert gd.dtype == torch.float32 and gi.dtype == torch.int32
    assert topk_disagreements(gi.numpy(), gd.numpy(), np.asarray(wi),
                              np.asarray(wd), rtol=RTOL, atol=ATOL) == 0
    ids = gi.numpy()
    assert ids.min() >= col0 and ids.max() < n
    if exclude_self:
        assert not np.any(ids == qi[:, None])


@pytest.mark.parametrize("kind,d,c", SCAN_KINDS)
def test_scan_topk_narrow_slab_fills_inf(kind, d, c):
    """A slab narrower than k returns (+inf, -1) beyond its rows."""
    rng = np.random.default_rng(5)
    slab, q = _scan_inputs(rng, kind, d, 100, 9)
    qi = np.arange(9, dtype=np.int32)
    spec = (kind, c)
    wd, wi = jscan.scan_topk(jnp.asarray(slab), jnp.asarray(q),
                             jnp.asarray(qi), 0, spec=spec, k=256, n=100,
                             exclude_self=True, tile_rows=128)
    gd, gi = scan_topk.scan_topk(torch.from_numpy(slab), torch.from_numpy(q),
                                 torch.from_numpy(qi), 0, spec=spec, k=256,
                                 n=100, exclude_self=True)
    gd, gi = gd.numpy(), gi.numpy()
    assert np.all(np.isfinite(gd[:, :99])) and np.all(np.isinf(gd[:, 99:]))
    assert np.all(gi[:, 99:] == -1)
    np.testing.assert_array_equal(np.asarray(wi)[:, 99:], gi[:, 99:])
    assert topk_disagreements(gi, gd, np.asarray(wi), np.asarray(wd),
                              rtol=RTOL, atol=ATOL) == 0


def test_scan_topk_ties_go_to_lowest_column():
    """Duplicate slab rows tie exactly: the lower global column wins, as
    in the JAX kernel's merge."""
    rng = np.random.default_rng(6)
    base = ball_rows(rng, 50, 10).astype(np.float32)
    slab = np.concatenate([base, base, base])          # 3 copies
    q = base[:5] * 0.5
    qi = np.zeros(5, np.int32)
    spec = ("poincare", C)
    wd, wi = jscan.scan_topk(jnp.asarray(slab), jnp.asarray(q),
                             jnp.asarray(qi), 10, spec=spec, k=9, n=10 + 150,
                             tile_rows=128)
    gd, gi = scan_topk.scan_topk(torch.from_numpy(slab), torch.from_numpy(q),
                                 torch.from_numpy(qi), 10, spec=spec, k=9,
                                 n=160)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    # each tie triple comes back in column order
    assert np.all(np.diff(gi.numpy()[:, :3], axis=1) == 50)


@pytest.mark.parametrize("spec,k,dim,ok", [
    (("poincare", 1.0), 10, 10, True), (("lorentz", 1.0), 256, 11, True),
    (("euclidean", 0.0), 1, 1024, True), (("poincare", 1.0), 257, 10, False),
    (("poincare", 1.0), 0, 10, False), (("poincare", 1.0), 10, 1025, False),
    (("sphere", 1.0), 10, 10, False),
    (("product", (("poincare", 5, 1.0),)), 10, 5, False)])
def test_supports_matches_jax(spec, k, dim, ok):
    assert scan_topk.supports(spec, k=k, dim=dim) is ok
    assert jscan.supports(spec, k=k, dim=dim) is ok
    assert scan_topk.kind_supported(spec) is jscan.kind_supported(spec)


def test_scan_topk_rejects_unsupported():
    x = torch.zeros((4, 3))
    qi = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported"):
        scan_topk.scan_topk(x, x, qi, 0, spec=("poincare", 1.0), k=300, n=4)
    with pytest.raises(ValueError, match="does not match"):
        scan_topk.scan_topk(x, torch.zeros((4, 5)), qi, 0,
                            spec=("poincare", 1.0), k=1, n=4)


def test_wrappers_count_no_launch_on_cpu():
    """The launch counters move only where a CUDA kernel launches."""
    before = (distmat.pdist.launches, scan_topk.scan_topk.launches)
    x = torch.zeros((4, 3))
    distmat.pdist(x, x, 1.0, manifold="poincare")
    scan_topk.scan_topk(x, x, torch.zeros(4, dtype=torch.int32), 0,
                        spec=("poincare", 1.0), k=2, n=4)
    assert (distmat.pdist.launches, scan_topk.scan_topk.launches) == before

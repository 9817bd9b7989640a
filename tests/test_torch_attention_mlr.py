"""The port's hyperbolic attention, MLR head and Lorentz layers against the
JAX package, on the CPU (the kernels' plain versions).

The JAX side runs its Pallas kernels in interpret mode where a test says
so (``HYPERSPACE_KERNELS=interpret``), else its XLA twins; float64 runs
under JAX's scoped ``enable_x64``.

Tolerances:
- float64 twins and oracles: rtol 1e-10 (the same formulas, summed in
  other orders);
- ``hyp_mlr`` against JAX's kernel (f32, interpret): rtol 2e-5;
- flash attention against JAX's kernel (f32, interpret): 2e-4, as the
  JAX package holds its own kernel to its twin; its gradients: error
  scaled by the largest entry < 2e-3, and dβ exactly 0 on both sides;
- layers (f32, from the same flax parameters): rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.kernels import _support as JS
from hyperspace_tpu.kernels import attention as JA
from hyperspace_tpu.kernels import mlr as JM
from hyperspace_tpu.manifolds import Lorentz as JL
from hyperspace_tpu.manifolds import PoincareBall as JB
from hyperspace_tpu.nn import attention as JNA
from hyperspace_tpu.nn import layers as JNL
from hyperspace_tpu.nn import mlr as JNM
from hyperspace_torch.kernels import attention as TA
from hyperspace_torch.kernels import mlr as TM
from hyperspace_torch.manifolds import Lorentz as TL
from hyperspace_torch.manifolds import PoincareBall as TB
from hyperspace_torch.manifolds import smath as ts
from hyperspace_torch.models.hybonet import params_from_jax
from hyperspace_torch.nn import attention as TNA
from hyperspace_torch.nn import layers as TNL
from hyperspace_torch.nn import mlr as TNM


@pytest.fixture
def interp(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_KERNELS", "interpret")


def hyperboloid(rng, shape, c=1.0, scale=1.0):
    sp = rng.standard_normal(shape) * scale
    t = np.sqrt(1.0 / c + np.sum(sp * sp, axis=-1, keepdims=True))
    return np.concatenate([t, sp], axis=-1)


def ball(rng, shape, c=1.0, scale=0.9):
    v = rng.standard_normal(shape)
    r = rng.uniform(0.0, scale, shape[:-1] + (1,)) / np.sqrt(c)
    return v / np.linalg.norm(v, axis=-1, keepdims=True) * r


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# --- manifold pieces --------------------------------------------------------


def test_kasinh_matches_jax():
    x = np.array([0.0, -0.0, 1e-8, -3e-4, 0.5, -2.0, 40.0, -1e6, 1e15])
    for dt, tol in ((np.float64, 1e-15), (np.float32, 1e-6)):
        with jax.enable_x64(True):
            want = np.asarray(JS.kasinh(jnp.asarray(x.astype(dt))))
        got = ts.kasinh(torch.as_tensor(x.astype(dt))).numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=0)
        np.testing.assert_allclose(got, np.arcsinh(x.astype(dt)),
                                   rtol=10 * tol, atol=0)


@pytest.mark.parametrize("c", [1.0, 0.7])
def test_centroid_and_lambda_match_jax(c):
    rng = np.random.default_rng(0)
    x = hyperboloid(rng, (3, 5, 4), c, 0.7)
    w = rng.random((3, 5))
    y = ball(rng, (6, 4), c)
    with jax.enable_x64(True):
        m = JL(c)
        want = [m.centroid(jnp.asarray(x)), m.centroid(jnp.asarray(x),
                                                       jnp.asarray(w)),
                JB(c).lambda_x(jnp.asarray(y)),
                JB(c).lambda_x(jnp.asarray(y), keepdims=False)]
    got = [TL(c).centroid(t64(x)), TL(c).centroid(t64(x), t64(w)),
           TB(c).lambda_x(t64(y)), TB(c).lambda_x(t64(y), keepdim=False)]
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-12)


# --- hyp_mlr -----------------------------------------------------------------


def _mlr_case(rng, lead, k, d, c):
    return (ball(rng, lead + (d,), c), ball(rng, (k, d), c, 0.5),
            rng.standard_normal((k, d)))


@pytest.mark.parametrize("c", [1.0, 0.5, 2.0])
def test_hyp_mlr_plain_matches_twin_and_naive_f64(c):
    rng = np.random.default_rng(1)
    x, p, a = _mlr_case(rng, (4, 5), 6, 10, c)
    with jax.enable_x64(True):
        args = [jnp.asarray(z) for z in (x, p, a)]
        twin = np.asarray(JM._t_hyp_mlr(*args, c))
        naive = np.asarray(JNM.hyp_mlr_logits(*args, c))
    targs = [t64(z) for z in (x, p, a)]
    for got in (TM.hyp_mlr_plain(*targs, c), TM.hyp_mlr(*targs, c),
                TNM.hyp_mlr_logits(*targs, c)):
        assert got.shape == (4, 5, 6)
        np.testing.assert_allclose(got.numpy(), twin, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(twin, naive, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("n,k,d", [(17, 5, 10), (64, 4, 128), (9, 8, 33)])
def test_hyp_mlr_matches_jax_kernel(interp, n, k, d):
    rng = np.random.default_rng(n + k + d)
    x, p, a = (z.astype(np.float32) for z in _mlr_case(rng, (n,), k, d, 1.0))
    want = np.asarray(JM.hyp_mlr(jnp.asarray(x), jnp.asarray(p),
                                 jnp.asarray(a), 1.0))
    got = TM.hyp_mlr(t32(x), t32(p), t32(a), 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_hyp_mlr_gradients_match_jax():
    rng = np.random.default_rng(2)
    x, p, a = _mlr_case(rng, (7,), 4, 6, 1.0)
    g_out = rng.standard_normal((7, 4))
    with jax.enable_x64(True):
        want = jax.grad(lambda *z: jnp.sum(JM.hyp_mlr(*z, 1.0) * g_out),
                        argnums=(0, 1, 2))(*[jnp.asarray(z) for z in
                                             (x, p, a)])
    ins = [t64(z).requires_grad_() for z in (x, p, a)]
    (TM.hyp_mlr(*ins, 1.0) * t64(g_out)).sum().backward()
    for t, w in zip(ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)


# --- flash attention -------------------------------------------------------


def _attn_case(rng, lead, nq, nk, d, c=1.0, masked=True, empty_rows=()):
    q = hyperboloid(rng, lead + (nq, d - 1), c, 0.7)
    k = hyperboloid(rng, lead + (nk, d - 1), c, 0.7)
    v = hyperboloid(rng, lead + (nk, d - 1), c, 0.7)
    mask = None
    if masked:
        mask = rng.random(lead[:-1] + (1, nq, nk)) > 0.3
        for r in empty_rows:
            mask[..., r, :] = False
    return q, k, v, mask


def test_flash_plain_matches_twin_and_dense_f64():
    rng = np.random.default_rng(3)
    c = 0.8
    q, k, v, mask = _attn_case(rng, (2, 3), 9, 14, 6, c, empty_rows=(4,))
    beta = rng.standard_normal((3, 1, 1)) * 0.3
    tau = 1.0 + rng.random((3, 1, 1))
    with jax.enable_x64(True):
        J = [jnp.asarray(z) for z in (q, k, v, beta, tau)]
        jm = jnp.asarray(mask)
        twin = np.asarray(JA._t_flash_attention(
            J[0], J[1], J[2], c, J[3], J[4], jm.astype(jnp.float64)))
        dense = np.asarray(JNA.lorentz_attention(
            J[0], J[1], J[2], JL(c), beta=J[3], tau=J[4], mask=jm))
        tiled = np.asarray(JNA.lorentz_attention_tiled(
            J[0], J[1], J[2], JL(c), beta=J[3], tau=J[4], mask=jm,
            block_size=4))
    T = [t64(z) for z in (q, k, v, beta, tau)]
    tm = torch.as_tensor(mask)
    got = TA.flash_attention_plain(T[0], T[1], T[2], c, T[3], T[4], tm)
    np.testing.assert_allclose(got.numpy(), twin, rtol=1e-10, atol=1e-12)
    assert np.all(got.numpy()[..., 4, :] == 0)
    got = TNA.lorentz_attention(T[0], T[1], T[2], TL(c), beta=T[3],
                                tau=T[4], mask=tm)
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-10, atol=1e-12)
    for bs in (4, 128):
        got = TNA.lorentz_attention_tiled(T[0], T[1], T[2], TL(c), beta=T[3],
                                          tau=T[4], mask=tm, block_size=bs)
        np.testing.assert_allclose(got.numpy(), tiled, rtol=1e-10,
                                   atol=1e-12)
    np.testing.assert_allclose(twin, dense, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tiled, dense, rtol=1e-10, atol=1e-12)


# lead, nq, nk, d, masked, empty query rows, per-head β/τ
_FLASH_CASES = {
    "plain": ((2,), 16, 16, 8, False, (), False),
    "masked": ((2,), 24, 40, 6, True, (), False),
    "empty_rows": ((1, 2), 9, 16, 5, True, (0, 3, 8), True),
    "heads": ((2, 3), 16, 12, 7, True, (5,), True),
    "tiles": ((1,), 300, 520, 9, True, (299,), False),
}


@pytest.mark.parametrize("case", sorted(_FLASH_CASES))
def test_flash_matches_jax_kernel(interp, case):
    lead, nq, nk, d, masked, empty, heads = _FLASH_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v, mask = _attn_case(rng, lead, nq, nk, d, masked=masked,
                               empty_rows=empty)
    h = lead[-1]
    beta, tau = ((rng.standard_normal((h, 1, 1)) * 0.3,
                  1.0 + rng.random((h, 1, 1))) if heads else (0.3, 1.5))
    J = [jnp.asarray(np.asarray(z, np.float32)) for z in (q, k, v)]
    jb, jt = (jnp.asarray(np.asarray(z, np.float32)) for z in (beta, tau))
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(JA.flash_attention(*J, 1.0, beta=jb, tau=jt,
                                         mask=jmask))
    T = [t32(z) for z in (q, k, v)]
    tb, tt = (t32(z) if heads else z for z in (beta, tau))
    got = TA.flash_attention(*T, 1.0, beta=tb, tau=tt,
                             mask=None if mask is None else
                             torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    for r in empty:
        assert np.all(got[..., r, :] == 0)

    # the forward kernel's residuals: lse (1e30 on empty rows) and nrm
    bsz = int(np.prod(lead))
    q3, k3, v3 = (z.reshape(bsz, z.shape[-2], d) for z in J)
    b3 = JA._scalar_per_batch(jb, lead, jnp.float32)
    t3 = JA._scalar_per_batch(jt, lead, jnp.float32)
    mf = None if mask is None else jnp.broadcast_to(
        jmask, lead + (nq, nk)).reshape(bsz, nq, nk).astype(jnp.float32)
    _, lse_j, nrm_j = JA._launch(q3, k3, v3, 1.0, b3, t3, mf, "interpret")
    m3, group = (None, 1) if mask is None else TA._mask_rows(
        torch.as_tensor(mask), lead, nq, nk)
    _, lse_t, nrm_t = TA.flash_fwd(
        *(torch.as_tensor(np.asarray(z)) for z in (q3, k3, v3)), 1.0,
        torch.as_tensor(np.asarray(b3)), torch.as_tensor(np.asarray(t3)), m3,
        group)
    lse_j = np.asarray(lse_j)[:, :nq]
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(nrm_t.numpy(), np.asarray(nrm_j)[:, :nq],
                               rtol=2e-4, atol=1e-6)
    for r in empty:
        assert np.all(lse_t.numpy().reshape(lead + (nq,))[..., r] == 1e30)


def test_flash_per_position_beta_tau_run_the_plain_version_on_the_cpu(
        interp):
    """Per-position β and τ (not [..., 1, 1]): JAX routes them to its
    twin, the port to its plain version on CPU tensors (CUDA tensors
    raise: the kernels take β and τ per (batch, head) only)."""
    rng = np.random.default_rng(6)
    q, k, v, mask = _attn_case(rng, (2, 3), 10, 14, 5, masked=True)
    beta = rng.standard_normal((2, 3, 10, 14)) * 0.3
    tau = 1.0 + rng.random((2, 3, 10, 1))
    J = [jnp.asarray(np.asarray(z, np.float32)) for z in (q, k, v, beta,
                                                           tau)]
    want = np.asarray(JA.flash_attention(*J[:3], 1.0, beta=J[3], tau=J[4],
                                         mask=jnp.asarray(mask)))
    T = [t32(z) for z in (q, k, v, beta, tau)]
    got = TA.flash_attention(*T[:3], 1.0, beta=T[3], tau=T[4],
                             mask=torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("masked", [True, False])
def test_flash_gradients_match_jax_kernel(interp, masked):
    """The Function's backward (the plain dq and dk/dv kernels) against
    JAX's kernel path, for q, k, v, c, β and τ per head, with empty rows."""
    rng = np.random.default_rng(4)
    c = 1.3
    q, k, v, mask = _attn_case(rng, (2, 2), 12, 20, 6, c, masked=masked,
                               empty_rows=(2, 7))
    beta = rng.standard_normal((2, 1, 1)) * 0.3
    tau = 1.0 + rng.random((2, 1, 1))
    g_out = rng.standard_normal(q.shape).astype(np.float32)
    args = [np.asarray(z, np.float32) for z in (q, k, v)] + [
        np.float32(c)] + [np.asarray(z, np.float32) for z in (beta, tau)]
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v, c, beta, tau):
        return jnp.sum(JA.flash_attention(q, k, v, c, beta=beta, tau=tau,
                                          mask=jmask) * g_out)

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *[jnp.asarray(z) for z in args])
    ins = [torch.tensor(z, requires_grad=True) for z in args]
    out = TA.flash_attention(*ins[:4], beta=ins[4], tau=ins[5],
                             mask=None if mask is None else
                             torch.as_tensor(mask))
    (out * t32(g_out)).sum().backward()
    for name, t, w in zip("q k v c beta tau".split(), ins, want):
        g, w = t.grad.numpy(), np.asarray(w, np.float32)
        assert np.all(np.isfinite(g)), name
        if name == "beta":
            assert np.all(g == 0) and np.all(w == 0)
            continue
        scale = max(float(np.max(np.abs(w))), 1e-3)
        assert float(np.max(np.abs(g - w))) / scale < 2e-3, name


def test_flash_kernel_plain_versions_agree_with_dense_autograd():
    """The plain dq and dk/dv kernels (through the Function) against
    PyTorch autograd of the dense twin, f64: the same gradient computed
    two ways, away from the clamps (β and τ exact in f32, which the
    Function carries them in)."""
    rng = np.random.default_rng(5)
    q, k, v, mask = _attn_case(rng, (3,), 10, 13, 5, empty_rows=(6,))
    g_out = t64(rng.standard_normal(q.shape))
    tm = torch.as_tensor(mask)
    grads = []
    for fn in (TA.flash_attention, TA.flash_attention_plain):
        ins = [t64(z).requires_grad_() for z in (q, k, v)]
        tau = torch.tensor(1.5, dtype=torch.float64, requires_grad=True)
        kw = dict(beta=0.25, tau=tau, mask=tm)
        out = (fn(*ins, 1.0, **kw) if fn is TA.flash_attention
               else fn(*ins, 1.0, 0.25, tau, tm))
        (out * g_out).sum().backward()
        grads.append([t.grad for t in ins] + [tau.grad])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-11)


# --- layers from the same flax parameters ----------------------------------


def _load(module, flax_params):
    module.load_state_dict(params_from_jax(flax_params))
    return module


@pytest.mark.parametrize("act", [None, "relu"])
def test_lorentz_linear_matches_jax(act):
    rng = np.random.default_rng(6)
    x = np.asarray(hyperboloid(rng, (4, 7, 8), 1.0, 0.5), np.float32)
    jact = None if act is None else jax.nn.relu
    jmod = JNL.LorentzLinear(12, JL(1.0), activation=jact)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    assert all(a.dtype == jnp.float32 for a in jax.tree.leaves(params))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = _load(TNL.LorentzLinear(9, 12, TL(1.0), activation=None
                                   if act is None else torch.relu), params)
    got = tmod(t32(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["flash", "scan"])
def test_multihead_attention_matches_jax(interp, impl):
    rng = np.random.default_rng(7)
    b, n, dim, h = 2, 10, 8, 2
    x = np.asarray(hyperboloid(rng, (b, n, dim), 1.0, 0.5), np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 6:] = False
    att = mask[:, None, :] & mask[:, :, None]
    jmod = JNA.HypMultiHeadAttention(dim=dim, num_heads=h, manifold=JL(1.0),
                                     impl=impl)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                       mask=jnp.asarray(att))["params"]
    params = jax.tree.map(np.asarray, params)
    params["beta"] = rng.standard_normal((h, 1, 1)).astype(np.float32)
    params["tau_raw"] = rng.standard_normal((h, 1, 1)).astype(np.float32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x),
                                 mask=jnp.asarray(att)))
    tmod = _load(TNA.HypMultiHeadAttention(dim + 1, dim, h, TL(1.0),
                                           impl=impl), params)
    got = tmod(t32(x), mask=torch.as_tensor(att)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lorentz_mlr_matches_jax(interp):
    rng = np.random.default_rng(8)
    x = np.asarray(hyperboloid(rng, (6, 16), 1.0, 0.6), np.float32)
    jmod = JNM.LorentzMLR(5, JL(1.0))
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    params = jax.tree.map(np.asarray, params)
    params["p_tangent"] = (0.3 * rng.standard_normal((5, 16))).astype(
        np.float32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = _load(TNM.LorentzMLR(16, 5, TL(1.0)), params)
    got = tmod(t32(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)

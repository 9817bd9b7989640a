"""The port's scatter kernels and the layers built on them against the JAX
package, on the CPU.

On CPU tensors the port's wrappers run their plain versions; the JAX
side runs its Pallas kernels in interpret mode (``HYPERSPACE_KERNELS``)
or its XLA twins, as the JAX package's own tests do.  Inputs come from
numpy with a seed.  float64 runs under JAX's scoped ``enable_x64``.

Tolerances:
- f64: rtol 1e-10 (both sides compute the same sums in float64).
- f32: rtol = atol = 1e-5 (sums in other orders); gradients of a layer
  rtol 1e-4 / atol 1e-6 (two rounded passes).
- bf16 segment sum: 2e-2 compared in f32, the JAX kernel tests'
  tolerance; bf16 cluster aggregate against interpret mode: 1e-2 — both
  round each weight to bf16 before the product, so only the order of
  the f32 sums and the final rounding differ.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.data import graphs as JG
from hyperspace_tpu.kernels import cluster as JC
from hyperspace_tpu.kernels import segment as JS
from hyperspace_tpu.manifolds import Lorentz as JLorentz
from hyperspace_tpu.nn import edge_dist as JE
from hyperspace_tpu.nn import gcn as JGCN
from hyperspace_tpu.nn import scatter as JSC
from hyperspace_torch.data import graphs as TG
from hyperspace_torch.kernels import cluster as TC
from hyperspace_torch.kernels import segment as TS
from hyperspace_torch.manifolds import Lorentz as TLorentz
from hyperspace_torch.nn import edge_dist as TE
from hyperspace_torch.nn import gcn as TGCN
from hyperspace_torch.nn import scatter as TSC

N_LAYER = 600


@pytest.fixture
def mode(monkeypatch, request):
    monkeypatch.setenv("HYPERSPACE_KERNELS", request.param)
    return request.param


def _x64(dt):
    """JAX's scoped float64 mode for f64 cases."""
    return (jax.enable_x64(True) if dt == np.float64
            else contextlib.nullcontext())


def _jdtype(dt):
    return {np.float32: jnp.float32, np.float64: jnp.float64,
            "bfloat16": jnp.bfloat16}[dt]


def _tdtype(dt):
    return {np.float32: torch.float32, np.float64: torch.float64,
            "bfloat16": torch.bfloat16}[dt]


# --- kernels -------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["interpret", "xla"], indirect=True)
@pytest.mark.parametrize("f", [8, 33, 128, 130])
@pytest.mark.parametrize("dt", [np.float32, "bfloat16"])
def test_csr_segment_sum_matches_jax(mode, f, dt):
    rng = np.random.default_rng(f)
    n, e = 300, 1500
    r = np.sort(np.where(rng.random(e) < 0.3, 77,
                         rng.integers(0, n - 40, e))).astype(np.int32)
    r = np.concatenate([r, np.full(100, n - 1, np.int32)])  # padding
    vals = rng.standard_normal((e + 100, f)).astype(np.float32)
    vals[e:] = 0.0
    plan = TS.build_csr_plan(r, n)
    want = JS.csr_segment_sum(jnp.asarray(vals, _jdtype(dt)), jnp.asarray(r),
                              tuple(jnp.asarray(a) for a in plan), n)
    before = TS.csr_segment_sum.launches
    got = TS.csr_segment_sum(torch.tensor(vals).to(_tdtype(dt)),
                             torch.as_tensor(r), plan, n)
    assert TS.csr_segment_sum.launches == before
    assert got.dtype == _tdtype(dt) and got.shape == (n, f)
    tol = 2e-2 if dt == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    assert torch.all(got[n - 40:n - 1] == 0)  # empty rows


def _by_pair(r, s, n):
    key = (r // 256).astype(np.int64) * (n // 256 + 1) + s // 256
    o = np.argsort(key, kind="stable")
    return r[o], s[o]


@pytest.mark.parametrize("mode", ["interpret", "xla"], indirect=True)
@pytest.mark.parametrize("f", [8, 33, 128, 130])
@pytest.mark.parametrize("dt", [np.float32, "bfloat16"])
def test_cluster_aggregate_matches_jax(mode, f, dt):
    rng = np.random.default_rng(f + 1)
    n, e = 700, 3000
    r, s = _by_pair(rng.integers(0, 512, e).astype(np.int32),
                    rng.integers(0, n, e).astype(np.int32), n)
    w = rng.random(e).astype(np.float32)
    h = rng.standard_normal((n, f)).astype(np.float32)
    plan = TC.build_cluster_plan(r, s, n)
    want = JC.cluster_aggregate(jnp.asarray(h, _jdtype(dt)), jnp.asarray(w),
                                jnp.asarray(r), jnp.asarray(s),
                                tuple(jnp.asarray(a) for a in plan), n)
    before = TC.cluster_aggregate.launches
    got = TC.cluster_aggregate(torch.tensor(h).to(_tdtype(dt)),
                               torch.tensor(w), torch.as_tensor(r),
                               torch.as_tensor(s), plan, n)
    assert TC.cluster_aggregate.launches == before
    assert got.dtype == _tdtype(dt) and got.shape == (n, f)
    assert torch.all(got[512:] == 0)
    if dt == "bfloat16" and mode == "xla":
        # the XLA twin multiplies unrounded f32 weights: only the kernel's
        # arithmetic (interpret mode) is held at the tight bf16 tolerance
        tol = 2e-2
    else:
        tol = 1e-2 if dt == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_cluster_aggregate_rounds_weights_like_the_tpu_kernel():
    """bf16 h: the weight is rounded to bf16 before its product."""
    h = torch.tensor([[1.0]], dtype=torch.bfloat16)
    w = torch.tensor([1.0 + 2.0 ** -10])             # rounds to 1.0 in bf16
    r = s = torch.zeros(1, dtype=torch.int32)
    out = TC.cluster_aggregate(h.float(), w, r, s, None, 1)
    assert float(out) == 1.0 + 2.0 ** -10
    out = TC.cluster_aggregate_plain(h, w, r, s, 1)
    assert out.dtype == torch.bfloat16 and float(out) == 1.0
    empty = torch.zeros(0, dtype=torch.int32)
    z = TC.cluster_aggregate(torch.ones(3, 4), torch.zeros(0), empty, empty,
                             None, 3)
    assert torch.equal(z, torch.zeros(3, 4))


def test_wrappers_check_shapes():
    with pytest.raises(ValueError, match="want"):
        TS.csr_segment_sum(torch.zeros(4), torch.zeros(4, dtype=torch.int32),
                           None, 2)
    with pytest.raises(ValueError, match="want"):
        TC.cluster_aggregate(torch.zeros(3, 2), torch.zeros(4),
                             torch.zeros(5, dtype=torch.int32),
                             torch.zeros(4, dtype=torch.int32), None, 3)


# --- layers ----------------------------------------------------------------------


def _graph(cluster: bool):
    """The same 600-node hierarchy through each package's prepare, with a
    cluster split forced (min_pair_edges=8) or none."""
    edges, x, _, _ = JG.synthetic_hierarchy(num_nodes=N_LAYER, feat_dim=12,
                                            seed=0)
    jg = JG.prepare(edges, N_LAYER, x, cluster=False, pad_multiple=256,
                    cache=False)
    tg = TG.prepare(edges, N_LAYER, x, cluster=False, pad_multiple=256)
    if cluster:
        jg.cluster_split = JC.build_cluster_split(
            jg.senders, jg.receivers, jg.edge_mask, jg.deg, N_LAYER,
            min_pair_edges=8, rev_perm=jg.rev_perm)
        tg.cluster_split = TC.build_cluster_split(
            tg.senders, tg.receivers, tg.edge_mask, tg.deg, N_LAYER,
            min_pair_edges=8, rev_perm=tg.rev_perm)
        assert 0.1 < tg.cluster_split.frac_clustered < 1.0
    return jg, tg


def _grad(out, cot, *inputs):
    return torch.autograd.grad(out, inputs, torch.as_tensor(cot))


@pytest.fixture(scope="module")
def graphs():
    return {c: _graph(c) for c in (False, True)}


DTYPES = [(np.float64, 1e-10, 1e-10, "xla"),
          (np.float32, 1e-5, 1e-6, "interpret")]


@pytest.mark.parametrize("dt,rtol,atol,jmode", DTYPES)
def test_sym_segment_aggregate_fwd_bwd(graphs, monkeypatch, dt, rtol, atol,
                                       jmode):
    monkeypatch.setenv("HYPERSPACE_KERNELS", jmode)
    jg, tg = graphs[False]
    rng = np.random.default_rng(1)
    h = rng.standard_normal((N_LAYER, 16)).astype(dt)
    w = (rng.random(len(jg.senders)) * jg.edge_mask).astype(dt)
    cot = rng.standard_normal((N_LAYER, 16)).astype(dt)
    with _x64(dt):
        plan = [jnp.asarray(a) for a in jg.csr_plan]

        def f(hh, ww):
            return JSC.sym_segment_aggregate(
                hh, ww, jnp.asarray(jg.senders), jnp.asarray(jg.receivers),
                jnp.asarray(jg.rev_perm), *plan, N_LAYER, True)

        want, vjp = jax.vjp(jax.jit(f), jnp.asarray(h), jnp.asarray(w))
        dh_w, dw_w = vjp(jnp.asarray(cot))
    dg = TG.to_device(tg, "cpu")
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    got = TSC.sym_segment_aggregate(th, tw, dg.senders, dg.receivers,
                                    dg.rev_perm, dg.plan, N_LAYER)
    dh, dw = _grad(got, cot, th, tw)
    for a, b in ((got, want), (dh, dh_w), (dw, dw_w)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=rtol, atol=atol)
    # the static-weight form has no weight gradient
    th2 = torch.tensor(h, requires_grad=True)
    out = TSC.sym_segment_aggregate(th2, torch.tensor(w), dg.senders,
                                    dg.receivers, dg.rev_perm, dg.plan,
                                    N_LAYER, with_dw=False)
    np.testing.assert_allclose(_grad(out, cot, th2)[0].numpy(),
                               np.asarray(dh_w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dt,rtol,atol,jmode", DTYPES)
def test_cluster_sym_aggregate_fwd_bwd(graphs, monkeypatch, dt, rtol, atol,
                                       jmode):
    monkeypatch.setenv("HYPERSPACE_KERNELS", jmode)
    jg, tg = graphs[True]
    rng = np.random.default_rng(2)
    h = rng.standard_normal((N_LAYER, 16)).astype(dt)
    cot = rng.standard_normal((N_LAYER, 16)).astype(dt)
    with _x64(dt):
        agg = JG.to_device(jg).cluster
        want, vjp = jax.vjp(jax.jit(lambda hh: JSC.cluster_sym_aggregate(
            hh, agg, N_LAYER)), jnp.asarray(h))
        (dh_w,) = vjp(jnp.asarray(cot))
    dg = TG.to_device(tg, "cpu")
    th = torch.tensor(h, requires_grad=True)
    got = TSC.cluster_sym_aggregate(th, dg.cluster, N_LAYER)
    (dh,) = _grad(got, cot, th)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(dh.numpy(), np.asarray(dh_w), rtol=rtol,
                               atol=atol)


def _lorentz_points(rng, n, d, dt, scale=0.7):
    v = np.zeros((n, d + 1))
    v[:, 1:] = rng.standard_normal((n, d)) * scale
    with jax.enable_x64(True):
        x = np.asarray(JLorentz(1.0).expmap0(jnp.asarray(v)))
    return x.astype(dt)


@pytest.mark.parametrize("dt,rtol,atol,jmode", DTYPES)
def test_pair_sqdist_planned_and_semi(monkeypatch, dt, rtol, atol, jmode):
    monkeypatch.setenv("HYPERSPACE_KERNELS", jmode)
    rng = np.random.default_rng(3)
    n, p = 300, 900
    z = _lorentz_points(rng, n, 8, dt)
    # rows on the hyperboloid in exact arithmetic (x0² − ‖x‖² = 1 with
    # representable squares), so u = −⟨x,x⟩_L − 1 is exactly 0 on both
    # sides: the u == v pairs sit exactly on the clamp's tie, where the
    # old unbounded sqrt gradient gave 0·inf = NaN
    exact = [(1.0, ()), (1.25, ((1, 0.75),)), (1.25, ((4, -0.75),)),
             (2.125, ((2, 1.875),)), (1.5, ((3, 1.0), (5, 0.5)))]
    for row, (x0, space) in enumerate(exact):
        z[row] = 0.0
        z[row, 0] = x0
        for k, val in space:
            z[row, k] = val
    pairs = np.stack([rng.integers(0, n, p), np.zeros(p, np.int64)], 1)
    pairs[:, 1] = (pairs[:, 0] + rng.integers(1, n, p)) % n  # u != v
    pairs[:40, 0] = pairs[:40, 1] = np.arange(40) % len(exact)  # u == v
    pairs = pairs.astype(np.int32)
    gbar = rng.standard_normal(p).astype(dt)
    from hyperspace_tpu.models import hgcn as jh
    from hyperspace_torch.models import hgcn as th

    with _x64(dt):
        jp = jh.make_planned_pairs(pairs, n)
        jz = jnp.asarray(z)

        def f_pl(zz):
            return JE.pair_sqdist_planned(zz, 1.0, jp.u, jp.v, *jp.u_plan,
                                          jp.v_perm, jp.v_sorted,
                                          *jp.v_plan, "lorentz")

        def f_semi(zz):
            return JE.pair_sqdist_semi_planned(zz, 1.0, jp.u, jp.v,
                                               *jp.u_plan, "lorentz")

        want = {}
        for name, fn in (("planned", f_pl), ("semi", f_semi)):
            val, vjp = jax.vjp(jax.jit(fn), jz)
            want[name] = (np.asarray(val), np.asarray(vjp(jnp.asarray(gbar))[0]))
    tp = th.make_planned_pairs(pairs, n, torch.device("cpu"))
    for name in ("planned", "semi"):
        tz = torch.tensor(z, requires_grad=True)
        if name == "planned":
            val = TE.pair_sqdist_planned(tz, 1.0, tp.u, tp.v, tp.u_plan,
                                         tp.v_perm, tp.v_sorted, tp.v_plan)
        else:
            val = TE.pair_sqdist_semi_planned(tz, 1.0, tp.u, tp.v, tp.u_plan)
        (dz,) = _grad(val, gbar, tz)
        assert torch.all(torch.isfinite(dz))
        assert torch.all(val[tp.u == tp.v] == 0)
        np.testing.assert_allclose(val.detach().numpy(), want[name][0],
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(dz.numpy(), want[name][1], rtol=rtol,
                                   atol=max(atol, 1e-9))


@pytest.mark.parametrize("cluster", [False, True])
@pytest.mark.parametrize("dt,rtol,atol,jmode", [
    (np.float64, 1e-10, 1e-10, "xla"), (np.float32, 1e-5, 1e-5, "interpret")])
def test_hgcconv_fwd_bwd(graphs, monkeypatch, cluster, dt, rtol, atol, jmode):
    monkeypatch.setenv("HYPERSPACE_KERNELS", jmode)
    jg, tg = graphs[cluster]
    rng = np.random.default_rng(4)
    x = _lorentz_points(rng, N_LAYER, 12, dt, scale=0.3)
    cot = rng.standard_normal((N_LAYER, 9)).astype(dt)
    with _x64(dt):
        conv = JGCN.HGCConv(features=8, kind="lorentz")
        dgj = JG.to_device(jg)
        params = jax.jit(conv.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                    dgj)
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), _jdtype(dt)), params)

        def f(p, xx):
            return conv.apply(p, xx, dgj)[0]

        want, vjp = jax.vjp(jax.jit(f), params, jnp.asarray(x))
        dp_w, dx_w = vjp(jnp.asarray(cot))
    conv_t = TGCN.HGCConv(12, 8, dtype=_tdtype(dt))
    conv_t.load_state_dict({
        k: torch.as_tensor(np.asarray(v)) for k, v in
        params["params"].items()})
    tx = torch.tensor(x, requires_grad=True)
    got, m = conv_t(tx, TG.to_device(tg, "cpu"))
    assert m.c == 1.0
    dk, db, dx = _grad(got, cot, conv_t.kernel, conv_t.bias, tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)
    grad_tol = dict(rtol=1e-4, atol=1e-6) if dt == np.float32 else dict(
        rtol=rtol, atol=atol)
    np.testing.assert_allclose(dk.numpy(), np.asarray(
        dp_w["params"]["kernel"]), **grad_tol)
    np.testing.assert_allclose(db.numpy(), np.asarray(
        dp_w["params"]["bias"]), **grad_tol)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_w), **grad_tol)


def test_hgcconv_refuses_unported_options():
    with pytest.raises(NotImplementedError, match="use_att"):
        TGCN.HGCConv(4, 4, use_att=True)
    with pytest.raises(NotImplementedError, match="learn_c"):
        TGCN.HGCConv(4, 4, learn_c=True)
    with pytest.raises(NotImplementedError, match="poincare"):
        TGCN.make_manifold("poincare", 1.0)


def test_hgcconv_dropout_uses_its_generator(graphs):
    """Dropout keeps each pre-aggregation entry with probability 1 − rate
    and scales kept entries by 1 / (1 − rate), drawn from the generator
    it is given; it is off when deterministic."""
    _, tg = graphs[False]
    dg = TG.to_device(tg, "cpu")
    x = torch.tensor(_lorentz_points(np.random.default_rng(5), N_LAYER, 12,
                                     np.float64, scale=0.3))
    conv = TGCN.HGCConv(12, 8, dtype=torch.float64, dropout_rate=0.5,
                        generator=torch.Generator().manual_seed(0))
    ref, _ = conv(x, dg)
    runs = [conv(x, dg, deterministic=False,
                 generator=torch.Generator().manual_seed(s))[0]
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], ref)
    h = torch.ones(20000, dtype=torch.float64)
    out = TGCN.dropout(h, 0.25, torch.Generator().manual_seed(3))
    assert set(out.unique().tolist()) <= {0.0, 1.0 / 0.75}
    assert abs(float((out > 0).double().mean()) - 0.75) < 0.02

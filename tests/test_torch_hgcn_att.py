"""The HGCN attention arm of the port against the JAX package, on the CPU:
the four kernels' plain versions (``csr_segment_reduce_1d``,
``csr_att_bwd_edges``, ``cluster_att_fwd``, ``cluster_att_bwd``), the
attention partials and helpers of ``nn/scatter.py`` and ``nn/gcn.py``,
``HGCConv(use_att=True)`` on its three branches, the cluster gate, and
the whole ``train_step_lp_pairs`` step from JAX's own parameters.

On CPU tensors the port's wrappers run their plain versions.  The JAX
side runs its Pallas kernels in interpret mode for the per-kernel cases
(``HYPERSPACE_KERNELS=interpret``) and its XLA twins elsewhere, where
both follow the same f32 arithmetic.  Inputs come from numpy with a
seed; float64 runs under JAX's scoped ``enable_x64``.

Tolerances:
- f64 against the XLA twins: rtol 1e-10 (the same sums in float64).
- f32 kernels against interpret mode: rtol 1e-5 (atol 1e-5 forward,
  1e-4 for the cluster backward's dot-product sums); layers: values
  rtol 1e-5, gradients rtol 1e-4 / atol 1e-6; the planned partial's
  outputs within 1e-5 of their terms' absolute sums.
- bf16 cluster kernels against interpret mode: both round the same
  weights (and in the backward the same cotangent rows) to bf16, so the
  only gaps are the order of the f32 sums and a weight whose f32 value
  sits on a bf16 rounding boundary, where an ulp of exp/tanh flips it:
  each term may move by one bf16 ulp of its weight (at most 2^-7 of
  |w·x|), plus 1e-4.  Against the XLA twins, which do not round the cotangent,
  the bf16 backward is held at the JAX test's own 2e-1.
- bf16 planned partial: within 2^-6 of its terms' absolute sums (each
  product and the result rounded to bf16; an ulp of exp may move a
  weight by one bf16 ulp).
- the f32 step from JAX's parameters: loss rtol 1e-5, gradients rtol
  1e-4 / atol 1e-6, parameters after the update rtol 1e-4 / atol 1e-6;
  the bf16 five-step trajectory at lr 3e-3 within 2e-3 (absolute).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperspace_tpu.cli.train import hgcn_mode_defaults as j_mode_defaults
from hyperspace_tpu.data import graphs as JG
from hyperspace_tpu.kernels import cluster as JC
from hyperspace_tpu.kernels import segment as JS
from hyperspace_tpu.manifolds import Lorentz as JLorentz
from hyperspace_tpu.models import hgcn as jh
from hyperspace_tpu.nn import gcn as JGCN
from hyperspace_tpu.nn import scatter as JSC
from hyperspace_torch.benchmarks import hgcn_bench as TB
from hyperspace_torch.cli.train import hgcn_mode_defaults as t_mode_defaults
from hyperspace_torch.data import graphs as TG
from hyperspace_torch.kernels import cluster as TC
from hyperspace_torch.kernels import segment as TS
from hyperspace_torch.models import hgcn as th
from hyperspace_torch.nn import gcn as TGCN
from hyperspace_torch.nn import scatter as TSC

N = 600


@pytest.fixture
def mode(monkeypatch, request):
    monkeypatch.setenv("HYPERSPACE_KERNELS", request.param)
    return request.param


def _x64(dt):
    return (jax.enable_x64(True) if dt == np.float64
            else contextlib.nullcontext())


def _grad(out, cot, *inputs):
    return torch.autograd.grad(out, inputs, torch.as_tensor(cot))


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


# --- B3 and B5: the scalar segment passes ---------------------------------------


def _sorted_receivers(rng, n, e):
    """Receiver-sorted edges with a hub row, empty rows (n - 40 .. n - 2)
    and a padding tail at row n - 1."""
    r = np.sort(np.where(rng.random(e) < 0.3, 77,
                         rng.integers(0, n - 40, e))).astype(np.int32)
    return np.concatenate([r, np.full(100, n - 1, np.int32)])


@pytest.mark.parametrize("mode,dt,tol", [("xla", np.float64, 1e-10),
                                         ("interpret", np.float32, 1e-5)],
                         indirect=["mode"])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_csr_segment_reduce_1d_matches_jax(mode, dt, tol, op):
    rng = np.random.default_rng(7)
    n = 300
    r = _sorted_receivers(rng, n, 1500)
    vals = rng.standard_normal(len(r)).astype(dt)
    vals[-100:] = 0.0
    plan = TS.build_csr_plan(r, n)
    with _x64(dt):
        want = np.asarray(JS.csr_segment_reduce_1d(
            jnp.asarray(vals), jnp.asarray(r),
            tuple(jnp.asarray(a) for a in plan), n, op=op))
    before = TS.csr_segment_reduce_1d.launches
    got = TS.csr_segment_reduce_1d(torch.tensor(vals), torch.as_tensor(r),
                                   plan, n, op=op).numpy()
    assert TS.csr_segment_reduce_1d.launches == before
    assert got.dtype == dt and got.shape == (n,)
    empty = np.ones(n, bool)
    empty[r] = False
    assert empty.sum() >= 39
    # an empty row: 0 for a sum; for a max the kernel's fill -3e38 (JAX's
    # XLA twin gives -inf there, so those rows are compared in interpret
    # mode only)
    assert np.all(got[empty] == (0.0 if op == "sum" else
                                 np.asarray(TS.NEG_FILL, dt)))
    keep = ~empty if mode == "xla" else np.ones(n, bool)
    _close(got[keep], want[keep], tol, tol)
    with pytest.raises(ValueError, match="sum or max"):
        TS.csr_segment_reduce_1d(torch.tensor(vals), torch.as_tensor(r),
                                 plan, n, op="min")


@pytest.mark.parametrize("mode,dt,hdt,tol", [
    ("xla", np.float64, np.float64, 1e-10),
    ("interpret", np.float32, np.float32, 1e-5),
    ("interpret", np.float32, "bfloat16", 1e-5)], indirect=["mode"])
@pytest.mark.parametrize("f", [8, 33, 130])
def test_csr_att_bwd_edges_matches_jax(mode, dt, hdt, tol, f):
    rng = np.random.default_rng(f)
    n = 300
    r = _sorted_receivers(rng, n, 1500)
    e = len(r)
    dn = rng.standard_normal((n, f + 1)).astype(dt)
    h = rng.standard_normal((e, f)).astype(np.float32)
    # w as the layer passes it: float32 values, 0 on padding; logits in
    # (-30, 30) with both signs and exact zeros
    w = (rng.random(e) * 3).astype(np.float32).astype(dt)
    w[-100:] = 0.0
    lm = (rng.standard_normal(e) * 8).astype(dt)
    lm[::50] = 0.0
    plan = TS.build_csr_plan(r, n)
    jh_dt = jnp.bfloat16 if hdt == "bfloat16" else hdt
    th_dt = torch.bfloat16 if hdt == "bfloat16" else {
        np.float32: torch.float32, np.float64: torch.float64}[hdt]
    with _x64(dt):
        hj = jnp.asarray(h, jh_dt)
        h1 = jnp.concatenate([hj, jnp.ones((e, 1), jh_dt)], axis=1)
        dpre_w, dar_w = JS.csr_att_bwd_edges(
            jnp.asarray(dn), h1, jnp.asarray(w), jnp.asarray(lm),
            jnp.asarray(r), tuple(jnp.asarray(a) for a in plan), n, 30.0,
            0.2)
    ht = torch.tensor(h).to(th_dt)
    before = TS.csr_att_bwd_edges.launches
    dpre, dar = TS.csr_att_bwd_edges(
        torch.tensor(dn), ht, torch.tensor(w), torch.tensor(lm),
        torch.as_tensor(r), plan, n, 30.0, 0.2)
    assert TS.csr_att_bwd_edges.launches == before
    assert dpre.shape == (e,) and dar.shape == (n,)
    _close(dpre, dpre_w, tol, tol, "dpre")
    _close(dar, dar_w, tol, tol, "d_alpha_r")
    assert torch.all(dpre[-100:] == 0)


def test_kernel_wrappers_check_shapes():
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="want"):
        TS.csr_segment_reduce_1d(torch.zeros(4, 2), ids, None, 2)
    with pytest.raises(ValueError, match="want"):
        TS.csr_att_bwd_edges(torch.zeros(3, 5), torch.zeros(4, 3),
                             torch.zeros(4), torch.zeros(4), ids, None, 3,
                             30.0, 0.2)
    with pytest.raises(ValueError, match="want"):
        TC.cluster_att_fwd(torch.zeros(3, 2), torch.zeros(3), torch.zeros(2),
                           ids, ids, None, 3)
    with pytest.raises(ValueError, match="cotangent"):
        TC.cluster_att_bwd(torch.zeros(3, 2), torch.zeros(3, 2),
                           torch.zeros(3), torch.zeros(3), ids, ids, None, 3)


# --- B6: the in-tile cluster attention kernels ------------------------------------


def _pair_edges(rng, n, e_half):
    """A reversal-closed edge set sorted by (receiver block, sender
    block), as the JAX kernel tests build it."""
    u = rng.integers(0, n, e_half).astype(np.int32)
    v = rng.integers(0, n, e_half).astype(np.int32)
    r, s = np.concatenate([u, v]), np.concatenate([v, u])
    key = (r // 256).astype(np.int64) * (n // 256 + 1) + s // 256
    o = np.lexsort((s, r, key))
    return r[o], s[o]


def _att_inputs(n, e, f, seed):
    rng = np.random.default_rng(seed)
    r, s = _pair_edges(rng, n, e // 2)
    h = rng.standard_normal((n, f)).astype(np.float32)
    # distinct scores: a swap of dα_s and dα_r cannot pass
    a_s = (rng.standard_normal(n) * 0.7).astype(np.float32)
    a_r = (rng.standard_normal(n) * 0.7 + 0.3).astype(np.float32)
    g = rng.standard_normal((n, f + 1)).astype(np.float32)
    return r, s, h, a_s, a_r, g


def _bf16_term_bound(h, w_abs, r, s, n):
    """Per-row bound of one bf16 ulp of each weight (at most 2^-7 of it:
    bf16 keeps 8 significant bits): 2^-7·Σ|w_e·h[s_e]|."""
    return 2.0 ** -7 * TC.cluster_aggregate_plain(
        torch.as_tensor(np.abs(h)), torch.as_tensor(w_abs),
        torch.as_tensor(r), torch.as_tensor(s), n).numpy()


ATT_SHAPES = [(700, 4000, 32, "float32"), (700, 4000, 32, "bfloat16"),
              (300, 900, 130, "float32"), (257, 513, 8, "float32"),
              (300, 900, 128, "float32")]


@pytest.mark.parametrize("n,e,f,dt", ATT_SHAPES)
def test_cluster_att_fwd_matches_jax(monkeypatch, n, e, f, dt):
    monkeypatch.setenv("HYPERSPACE_KERNELS", "interpret")
    r, s, h, a_s, a_r, _ = _att_inputs(n, e, f, f + n)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    plan = TC.build_cluster_plan(r, s, n)
    want = np.asarray(JC.cluster_att_fwd(
        jnp.asarray(h, jdt), jnp.asarray(a_s), jnp.asarray(a_r),
        jnp.asarray(r), jnp.asarray(s), tuple(jnp.asarray(a) for a in plan),
        n))
    before = TC.cluster_att_fwd.launches
    got = TC.cluster_att_fwd(torch.tensor(h).to(tdt), torch.tensor(a_s),
                             torch.tensor(a_r), torch.as_tensor(r),
                             torch.as_tensor(s), plan, n).numpy()
    assert TC.cluster_att_fwd.launches == before
    assert got.dtype == np.float32 and got.shape == (n, f + 1)
    if dt == "bfloat16":
        hb = torch.tensor(h).to(tdt).float().numpy()
        pre = a_s[s] + a_r[r]
        w = np.exp(30.0 * np.tanh(np.where(pre >= 0, pre, 0.2 * pre) / 30))
        ext = np.concatenate([hb, np.ones((n, 1), np.float32)], 1)
        bound = _bf16_term_bound(ext, w.astype(np.float32), r, s, n)
        assert np.all(np.abs(got - want) <= bound + 1e-4)
    else:
        _close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("n,e,f,dt", [s for s in ATT_SHAPES if s[2] != 130])
def test_cluster_att_bwd_matches_jax(monkeypatch, n, e, f, dt):
    r, s, h, a_s, a_r, g = _att_inputs(n, e, f, f + n + 1)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    plan = TC.build_cluster_plan(r, s, n)
    want = {}
    for m in ("interpret", "xla"):
        monkeypatch.setenv("HYPERSPACE_KERNELS", m)
        want[m] = [np.asarray(a) for a in JC.cluster_att_bwd(
            jnp.asarray(g), jnp.asarray(h, jdt), jnp.asarray(a_s),
            jnp.asarray(a_r), jnp.asarray(r), jnp.asarray(s),
            tuple(jnp.asarray(a) for a in plan), n)]
    before = TC.cluster_att_bwd.launches
    got = [a.numpy() for a in TC.cluster_att_bwd(
        torch.tensor(g), torch.tensor(h).to(tdt), torch.tensor(a_s),
        torch.tensor(a_r), torch.as_tensor(r), torch.as_tensor(s), plan, n)]
    # and with the port's row plan, as the attention step passes it
    rows = TC.rows_on(TC.build_cluster_rows(r, s, n, with_rev=True), "cpu")
    got_rows = TC.cluster_att_bwd(
        torch.tensor(g), torch.tensor(h).to(tdt), torch.tensor(a_s),
        torch.tensor(a_r), torch.as_tensor(r), torch.as_tensor(s), plan, n,
        rows=rows)
    for a, b in zip(got, got_rows):
        np.testing.assert_array_equal(a, b.numpy())
    assert TC.cluster_att_bwd.launches == before
    assert [a.shape for a in got] == [(n, f), (n,), (n,)]
    for name, a, b, x in zip(("dh", "d_alpha_s", "d_alpha_r"), got,
                             want["xla"], want["interpret"]):
        if dt == "bfloat16":
            _close(a, b, 2e-1, 2e-1, name)   # the JAX test's tolerance
        else:
            _close(a, x, 1e-4, 1e-4, name)
            _close(a, b, 1e-4, 1e-4, name)
    if dt == "bfloat16":
        # against the TPU kernel's arithmetic: dh from the same bf16
        # weights and rows (one weight ulp a term); the score gradients
        # from the same bf16 rows, summed in other orders
        gb = torch.tensor(g).to(tdt).float().numpy()
        pre = a_s[r] + a_r[s]
        w = np.exp(30.0 * np.tanh(np.where(pre >= 0, pre, 0.2 * pre) / 30))
        bound = _bf16_term_bound(gb[:, :f], w.astype(np.float32), r, s, n)
        assert np.all(np.abs(got[0] - want["interpret"][0]) <= bound + 1e-4)
        for a, x in zip(got[1:], want["interpret"][1:]):
            _close(a, x, 1e-4, 1e-4)


# --- layers: partials, picks, softmax, the conv ----------------------------------


def _graph(min_pair=8):
    """The same 600-node hierarchy through each package, with a cluster
    split at ``min_pair`` (None: no split)."""
    edges, x, _, _ = JG.synthetic_hierarchy(num_nodes=N, feat_dim=12, seed=0)
    jg = JG.prepare(edges, N, x, cluster=False, pad_multiple=256,
                    cache=False)
    tg = TG.prepare(edges, N, x, cluster=False, pad_multiple=256)
    if min_pair is not None:
        for mod, g in ((JC, jg), (TC, tg)):
            g.cluster_split = mod.build_cluster_split(
                g.senders, g.receivers, g.edge_mask, g.deg, N,
                min_pair_edges=min_pair, rev_perm=g.rev_perm)
    return jg, tg


@pytest.fixture(scope="module")
def graphs():
    return _graph(8)


def _open_gate(dgj, dgt):
    """Force the attention gate open on both sides (the toy graph's
    clustered share may sit under 0.15)."""
    dgj.cluster.use_att_cluster = True
    dgt.cluster.use_att_cluster = True
    assert dgj.cluster.att_ok and dgt.cluster.att_ok


def test_cluster_gate_matches_jax():
    """``use_att_cluster`` and ``att_ok`` equal JAX's on the same split, at
    thresholds on both sides of ATT_MIN_FRAC; no involution, no gate."""
    assert TSC.ClusterAgg.ATT_MIN_FRAC == JSC.ClusterAgg.ATT_MIN_FRAC
    fracs = []
    for min_pair in (8, 1000, 2000):       # clustered 0.999, 0.42, 0
        jg, tg = _graph(min_pair)
        cj, ct = JG.to_device(jg).cluster, TG.to_device(tg, "cpu").cluster
        fracs.append(tg.cluster_split.frac_clustered)
        assert ct.use_att_cluster == cj.use_att_cluster
        assert ct.att_ok == cj.att_ok
    assert min(fracs) < 0.15 <= max(fracs)
    jg, tg = _graph(None)
    split = TC.build_cluster_split(tg.senders, tg.receivers, tg.edge_mask,
                                   tg.deg, N, min_pair_edges=8)
    assert not TSC.ClusterAgg.from_host(split, "cpu").att_ok


def _att_tensors(seed, f=16):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, f)).astype(np.float32)
    a_s = (rng.standard_normal(N) * 0.7).astype(np.float32)
    a_r = (rng.standard_normal(N) * 0.7 + 0.2).astype(np.float32)
    cot = rng.standard_normal((N, f + 1)).astype(np.float32)
    return h, a_s, a_r, cot


@pytest.mark.parametrize("agg", [None, "bfloat16"])
def test_att_partial_planned_fwd_bwd(graphs, monkeypatch, agg):
    """Values and (dh, dα_s, dα_r).  Each output is held within a share
    of its terms' absolute sum (the port's own f32 partial of |h| and
    |ḡ|): 1e-5 in f32 (sums in other orders); 2^-6 with bf16 messages,
    where both sides round each product and the result to bf16 and an
    ulp of exp can move a weight by one bf16 ulp."""
    monkeypatch.setenv("HYPERSPACE_KERNELS", "xla")
    jg, tg = graphs
    h, a_s, a_r, cot = _att_tensors(1)
    dgj, dgt = JG.to_device(jg), TG.to_device(tg, "cpu")
    jagg = None if agg is None else jnp.bfloat16
    tagg = None if agg is None else torch.bfloat16
    graph = (dgt.senders, dgt.receivers, dgt.rev_perm, dgt.edge_mask,
             dgt.plan, N)

    def f(hh, s_, r_):
        return JSC.att_partial_planned(
            hh, s_, r_, dgj.senders, dgj.receivers, dgj.rev_perm,
            dgj.edge_mask, dgj.plan, N, jagg, 0.2)

    want, vjp = jax.vjp(jax.jit(f), jnp.asarray(h), jnp.asarray(a_s),
                        jnp.asarray(a_r))
    dw = vjp(jnp.asarray(cot))
    out = {}
    for which, hh, cc, ag in (("got", h, cot, tagg),
                              ("scale", np.abs(h), np.abs(cot), None)):
        ins = [torch.tensor(a, requires_grad=True) for a in (hh, a_s, a_r)]
        nd = TSC.att_partial_planned(*ins, *graph, ag, 0.2)
        out[which] = (nd.detach(), *_grad(nd, cc, *ins))
    assert out["got"][0].dtype == torch.float32
    assert out["got"][0].shape == (N, 17)
    share = 1e-5 if agg is None else 2.0 ** -6
    for name, a, b, sc in zip(("nd", "dh", "d_alpha_s", "d_alpha_r"),
                              out["got"], (want, *dw), out["scale"]):
        gap = np.abs(a.numpy() - np.asarray(b, np.float32))
        assert np.all(gap <= share * sc.abs().numpy() + 1e-6), name
    # att_aggregate_planned is the partial and one division
    ins = [torch.tensor(a) for a in (h, a_s, a_r)]
    agg_t = TSC.att_aggregate_planned(*ins, *graph, tagg, 0.2)
    agg_j = JSC.att_aggregate_planned(
        jnp.asarray(h), jnp.asarray(a_s), jnp.asarray(a_r), dgj.senders,
        dgj.receivers, dgj.rev_perm, dgj.edge_mask, dgj.plan, N, jagg, 0.2)
    row = (out["scale"][0][:, :-1] / out["scale"][0][:, -1:]).numpy()
    assert np.all(np.abs(agg_t.numpy() - np.asarray(agg_j))
                  <= 4 * share * row + 1e-6)


@pytest.mark.parametrize("dt,jmode", [("float32", "xla"),
                                      ("bfloat16", "interpret")])
def test_cluster_att_partial_fwd_bwd(graphs, monkeypatch, dt, jmode):
    monkeypatch.setenv("HYPERSPACE_KERNELS", jmode)
    jg, tg = graphs
    dgj, dgt = JG.to_device(jg), TG.to_device(tg, "cpu")
    _open_gate(dgj, dgt)
    h, a_s, a_r, cot = _att_tensors(2)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    want, vjp = jax.vjp(
        lambda hh, s_, r_: JSC.cluster_att_partial(hh, s_, r_, dgj.cluster,
                                                   N, 0.2),
        jnp.asarray(h, jdt), jnp.asarray(a_s), jnp.asarray(a_r))
    dw = vjp(jnp.asarray(cot))
    ins = [torch.tensor(h).to(tdt).requires_grad_(),
           torch.tensor(a_s, requires_grad=True),
           torch.tensor(a_r, requires_grad=True)]
    got = TSC.cluster_att_partial(*ins, dgt.cluster, N, 0.2)
    dt_ = _grad(got, cot, *ins)
    assert dt_[0].dtype == tdt            # dh in h's dtype
    tol = 1e-5 if dt == "float32" else 2e-2
    _close(got.detach(), want, tol, tol, "nd")
    for name, a, b in zip(("dh", "d_alpha_s", "d_alpha_r"), dt_, dw):
        _close(a.float(), np.asarray(b, np.float32), max(tol, 1e-4),
               max(tol, 1e-4), name)


def test_cluster_plus_stragglers_equals_full_planned(graphs):
    """The in-tile cluster partial plus the straggler planned partial is
    the full-edge planned partial: values and (dh, dα_s, dα_r)."""
    _, tg = graphs
    dg = TG.to_device(tg, "cpu")
    cl = dg.cluster
    cl.use_att_cluster = True
    h, a_s, a_r, cot = _att_tensors(3)
    out = {}
    for which in ("split", "full"):
        ins = [torch.tensor(a, requires_grad=True) for a in (h, a_s, a_r)]
        if which == "split":
            nd = TSC.cluster_att_partial(*ins, cl, N, 0.2)
            nd = nd + TSC.att_partial_planned(
                *ins, cl.s_send, cl.s_recv, cl.s_rev_local, cl.s_mask,
                cl.s_plan, N, None, 0.2)
        else:
            nd = TSC.att_partial_planned(*ins, dg.senders, dg.receivers,
                                         dg.rev_perm, dg.edge_mask, dg.plan,
                                         N, None, 0.2)
        out[which] = (nd.detach(), *_grad(nd, cot, *ins))
    for a, b in zip(out["split"], out["full"]):
        _close(a, b, 1e-5, 1e-5)


def test_picks_and_planned_1d_match_jax(graphs):
    jg, tg = graphs
    dgj, dgt = JG.to_device(jg), TG.to_device(tg, "cpu")
    rng = np.random.default_rng(4)
    alpha = rng.standard_normal(N).astype(np.float32)
    ev = rng.standard_normal(len(jg.senders)).astype(np.float32)
    ev[~jg.edge_mask] = 0.0
    cot_e = rng.standard_normal(len(jg.senders)).astype(np.float32)
    cot_n = rng.standard_normal(N).astype(np.float32)
    pl = dgj.plan
    cases = {
        "senders": (lambda a: JSC.pick_senders(
            a, dgj.senders, dgj.receivers, dgj.rev_perm, *pl, N),
            lambda a: TSC.pick_senders(a, dgt.senders, dgt.receivers,
                                       dgt.rev_perm, dgt.plan, N),
            alpha, cot_e),
        "receivers": (lambda a: JSC.pick_receivers(a, dgj.receivers, *pl, N),
                      lambda a: TSC.pick_receivers(a, dgt.receivers,
                                                   dgt.plan, N),
                      alpha, cot_e),
        "sum_1d": (lambda v: JSC.planned_segment_sum_1d(
            v, dgj.receivers, *pl, N),
            lambda v: TSC.planned_segment_sum_1d(v, dgt.receivers, dgt.plan,
                                                 N), ev, cot_n),
        "max_1d": (lambda v: JSC.planned_segment_max_1d(
            v, dgj.receivers, *pl, N),
            lambda v: TSC.planned_segment_max_1d(v, dgt.receivers, dgt.plan,
                                                 N), ev, cot_n)}
    for name, (jf, tf, x, cot) in cases.items():
        want, vjp = jax.vjp(jf, jnp.asarray(x))
        (dwant,) = vjp(jnp.asarray(cot))
        tx = torch.tensor(x, requires_grad=True)
        got = tf(tx)
        (dgot,) = _grad(got, cot, tx)
        _close(got.detach(), want, 1e-5, 1e-5, name)
        _close(dgot, dwant, 1e-5, 1e-5, name)


def test_bounded_logits_and_segment_softmax_match_jax():
    rng = np.random.default_rng(5)
    pre = rng.standard_normal(400) * 40
    pre[::37] = 0.0                          # the leaky ReLU's kink
    ids = np.sort(rng.integers(0, 50, 400)).astype(np.int32)
    mask = rng.random(400) < 0.8
    cot = rng.standard_normal(400)
    with jax.enable_x64(True):
        def jf(p):
            lm = JGCN.bounded_att_logits(p, 0.2)
            return lm, JGCN.segment_softmax(lm, jnp.asarray(ids), 60,
                                            mask=jnp.asarray(mask))

        (lm_w, sm_w), vjp = jax.vjp(jf, jnp.asarray(pre))
        (dp_w,) = vjp((jnp.asarray(cot), jnp.asarray(cot)))
    tp = torch.tensor(pre, requires_grad=True)
    lm = TGCN.bounded_att_logits(tp, 0.2)
    sm = TGCN.segment_softmax(lm, torch.as_tensor(ids), 60,
                              mask=torch.as_tensor(mask))
    (dp,) = torch.autograd.grad((lm, sm), (tp,), (torch.tensor(cot),
                                                  torch.tensor(cot)))
    assert TGCN.ATT_LOGIT_BOUND == JGCN.ATT_LOGIT_BOUND
    _close(lm.detach(), lm_w, 1e-12, 1e-12, "logits")
    _close(sm.detach(), sm_w, 1e-12, 1e-12, "softmax")
    _close(dp, dp_w, 1e-10, 1e-12, "gradient (1 at pre == 0)")
    assert np.all(np.abs(lm.detach().numpy()) < 30.0)


def _lorentz_points(rng, n, d, scale=0.3):
    v = np.zeros((n, d + 1))
    v[:, 1:] = rng.standard_normal((n, d)) * scale
    with jax.enable_x64(True):
        x = np.asarray(JLorentz(1.0).expmap0(jnp.asarray(v)))
    return x.astype(np.float32)


@pytest.mark.parametrize("branch,dt,tol", [
    ("cluster", np.float32, 1e-5), ("planned", np.float32, 1e-5),
    ("no_plan", np.float64, 1e-10)])
def test_hgcconv_att_fwd_bwd(graphs, monkeypatch, branch, dt, tol):
    """The three attention branches: the cluster gate open (in-tile
    cluster partial + straggler partial), the full-edge planned partial,
    and the segment softmax without a plan.  The partials compute in f32
    whatever h's dtype (as JAX's), so the two planned branches compare in
    f32; the softmax branch in f64 (in f32 its gradients sum cancelling
    terms, Σ p·(g − Σ p·g), to a few ulps of the largest)."""
    monkeypatch.setenv("HYPERSPACE_KERNELS", "xla")
    jg, tg = graphs
    dgj, dgt = JG.to_device(jg), TG.to_device(tg, "cpu")
    if branch == "cluster":
        _open_gate(dgj, dgt)
    else:
        dgj, dgt = dgj._replace(cluster=None), dataclasses.replace(
            dgt, cluster=None)
    if branch == "no_plan":
        dgj, dgt = dgj._replace(plan=None), dataclasses.replace(dgt,
                                                                 plan=None)
    rng = np.random.default_rng(6)
    x = _lorentz_points(rng, N, 12).astype(dt)
    cot = rng.standard_normal((N, 9)).astype(dt)
    conv = JGCN.HGCConv(features=8, kind="lorentz", use_att=True)
    with _x64(dt):
        params = jax.jit(conv.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                    dgj)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), params)
        assert sorted(params["params"]) == ["att_dst", "att_src", "bias",
                                            "kernel"]
        want, vjp = jax.vjp(jax.jit(lambda p, xx: conv.apply(p, xx,
                                                              dgj)[0]),
                            params, jnp.asarray(x))
        dp_w, dx_w = vjp(jnp.asarray(cot))
    conv_t = TGCN.HGCConv(12, 8, use_att=True,
                          dtype=torch.float64 if dt == np.float64
                          else torch.float32)
    conv_t.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in
                            params["params"].items()})
    tx = torch.tensor(x, requires_grad=True)
    got, _ = conv_t(tx, dgt)
    names = ("kernel", "bias", "att_src", "att_dst")
    grads = _grad(got, cot, *(getattr(conv_t, k) for k in names), tx)
    gtol = (1e-4, 1e-6) if dt == np.float32 else (tol, tol)
    _close(got.detach(), want, tol, tol, "output")
    for name, g in zip(names, grads):
        _close(g, dp_w["params"][name], *gtol, name)
    _close(grads[-1], dx_w, *gtol, "dx")


# --- the step -----------------------------------------------------------------------


def _splits(cluster: bool):
    edges, x, _, _ = JG.synthetic_hierarchy(num_nodes=N, feat_dim=12, seed=0)
    kw = dict(seed=0, pad_multiple=256)
    js_ = JG.split_edges(edges, N, x, cache=False, **kw)
    ts_ = TG.split_edges(edges, N, x, **kw)
    if cluster:
        for mod, sp in ((JC, js_), (TC, ts_)):
            g = sp.graph
            g.cluster_split = mod.build_cluster_split(
                g.senders, g.receivers, g.edge_mask, g.deg, N,
                min_pair_edges=8, rev_perm=g.rev_perm)
    return js_, ts_


def _att_cfgs(agg):
    """The JAX and port configs: the attention arm with the shipped mode
    defaults (lr 3e-3, clip 1.0) from each package's own function."""
    jc = j_mode_defaults(jh.HGCNConfig(
        feat_dim=12, hidden_dims=(16, 8), use_att=True, agg_dtype=agg[0],
        decoder_dtype=agg[0]), {"use_att": "true"}, sampled=False)
    tc = t_mode_defaults(th.HGCNConfig(
        feat_dim=12, hidden_dims=(16, 8), use_att=True, agg_dtype=agg[1],
        decoder_dtype=agg[1]), {"use_att": "true"}, sampled=False)
    assert (jc.lr, jc.clip_norm) == (tc.lr, tc.clip_norm) == (3e-3, 1.0)
    return jc, tc


def _run(js_, ts_, agg, steps, cluster):
    """JAX's init, its losses and updated parameters over ``steps`` (and
    its gradients, for one step); the port's from the same parameters
    and negatives."""
    jc, tc = _att_cfgs(agg)
    model, opt, state = jh.init_lp(jc, js_.graph, seed=0)
    ga = jh._device_graph(js_.graph)
    tg = TG.to_device(ts_.graph, "cpu")
    if cluster:
        _open_gate(ga, tg)
    pos = jh.make_planned_pairs(js_.train_pos, N)
    neg_u, neg_plan = jh.make_static_negatives(N, int(pos.u.shape[0]),
                                               seed=0)
    params0 = jax.tree_util.tree_map(np.asarray, state.params)

    def loss_fn(params, neg_v):
        pl, nl = model.apply({"params": params}, ga, pos, neg_u, neg_v,
                             neg_plan, deterministic=False,
                             method=jh.HGCNLinkPred.pair_logits)
        return ((jnp.sum(optax.sigmoid_binary_cross_entropy(
            pl, jnp.ones_like(pl))) + jnp.sum(
                optax.sigmoid_binary_cross_entropy(nl, jnp.zeros_like(nl))))
            / (pl.shape[0] + nl.shape[0]))

    neg_vs, losses, grads = [], [], None
    for i in range(steps):
        neg_v = jax.random.randint(jax.random.split(state.key, 3)[1],
                                   neg_u.shape, 0, N)
        neg_vs.append(np.asarray(neg_v, np.int32))
        if i == 0 and steps == 1:
            _, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params,
                                                            neg_v)
        state, loss = jh.train_step_lp_pairs(model, opt, N, state, ga, pos,
                                             neg_u, neg_plan)
        losses.append(float(loss))
    j = dict(losses=losses, grads=jax.tree_util.tree_map(np.asarray, grads),
             params=jax.tree_util.tree_map(np.asarray, state.params))

    tmodel, topt, tstate = th.init_lp(tc, ts_.graph, seed=0, device="cpu")
    tmodel.load_state_dict(th.params_from_jax(params0))
    tpos = th.make_planned_pairs(ts_.train_pos, N, torch.device("cpu"))
    tneg_u, tneg_plan = th.make_static_negatives(N, int(tpos.u.shape[0]),
                                                 seed=0, device="cpu")
    t = dict(losses=[], grads=None)
    for i, neg_v in enumerate(neg_vs):
        tstate, loss = th.train_step_lp_pairs(
            tmodel, topt, N, tstate, tg, tpos, tneg_u, tneg_plan,
            neg_v=torch.as_tensor(neg_v))
        if i == 0:
            t["grads"] = {k: p.grad.clone()
                          for k, p in tmodel.named_parameters()}
        t["losses"].append(float(loss))
    t["params"] = {k: v.detach().clone() for k, v in
                   tmodel.state_dict().items()}
    return j, t


@pytest.mark.parametrize("cluster", [False, True], ids=["plain", "cluster"])
def test_f32_att_step_from_jax_parameters(monkeypatch, cluster):
    monkeypatch.setenv("HYPERSPACE_KERNELS", "xla")
    js_, ts_ = _splits(cluster)
    j, t = _run(js_, ts_, (None, None), 1, cluster)
    _close(t["losses"], j["losses"], 1e-5, 0, "loss")
    jg = th.params_from_jax(j["grads"])
    jp = th.params_from_jax(j["params"])
    assert sorted(jg) == sorted(t["grads"])
    assert "encoder.conv1.att_dst" in jg
    for k, g in t["grads"].items():
        _close(g, jg[k], 1e-4, 1e-6, f"gradient {k}")
    for k, p in t["params"].items():
        _close(p, jp[k], 1e-4, 1e-6, f"parameter {k}")


def test_bf16_att_loss_trajectory(monkeypatch):
    """Five steps at the mode default lr 3e-3, bf16 messages and decoder,
    the cluster gate open, against JAX's XLA twins (the per-kernel tests
    hold the bf16 rounding against interpret mode)."""
    monkeypatch.setenv("HYPERSPACE_KERNELS", "xla")
    js_, ts_ = _splits(True)
    j, t = _run(js_, ts_, (jnp.bfloat16, torch.bfloat16), 5, True)
    assert np.all(np.isfinite(t["losses"]))
    _close(t["losses"], j["losses"], 0, 2e-3, "bf16 losses")


def test_att_bench_on_the_cpu():
    out = TB.run_hgcn_bench(steps=2, num_nodes=1500, device="cpu",
                            use_att=True)
    assert out["use_att"] is True
    assert (out["lr"], out["clip_norm"]) == (3e-3, 1.0)
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert TB.main(["--steps", "1", "--num-nodes", "300", "--device", "cpu",
                    "--use-att"]) == 0


def test_params_from_jax_carries_attention_vectors():
    tree = {"encoder": {"conv0": {"kernel": np.ones((3, 2), np.float32),
                                  "bias": np.zeros(2, np.float32),
                                  "att_src": np.full((2, 1), 0.5, np.float32),
                                  "att_dst": np.full((2, 1), -0.5,
                                                     np.float32)}},
            "decoder": {"r": np.float32(2.0), "t_raw": np.float32(1.0)}}
    cfg = th.HGCNConfig(feat_dim=3, hidden_dims=(2,), use_att=True)
    model, _, _ = th.init_lp(cfg, None, seed=0, device="cpu")
    model.load_state_dict(th.params_from_jax(tree))
    assert torch.equal(model.encoder.conv0.att_dst,
                       torch.full((2, 1), -0.5))
    # a learned curvature's c_raw rides along (learn_c is ported)
    tree["encoder"]["conv0"]["c_raw"] = np.float32(0.25)
    cfg_c = th.HGCNConfig(feat_dim=3, hidden_dims=(2,), use_att=True,
                          learn_c=True)
    model_c, _, _ = th.init_lp(cfg_c, None, seed=0, device="cpu")
    model_c.load_state_dict(th.params_from_jax(tree))
    assert float(model_c.encoder.conv0.c_raw) == 0.25
    tree["encoder"]["conv0"]["att_mid"] = np.zeros((2, 1))
    with pytest.raises(NotImplementedError, match="att_mid"):
        th.params_from_jax(tree)

"""HGCN link prediction's CLI step, the planned step and learned curvature
in the port against the JAX package, on the CPU.

- ``nn/edge_dist.py``: ``graph_edge_sqdist`` (values, dz, dc) and the two
  planned pair ops' curvature gradient (``dc``), against JAX's custom
  VJPs (their XLA scatter: no plan) and against autograd of the plain
  ``Lorentz.sqdist``: float64 rtol 1e-10, float32 rtol 1e-5, a sum (an
  element of dz, or dc) within the tier of the sum of its terms'
  magnitudes too; a self-loop's or padding edge's distance, rounding
  noise of a point against itself, under 1,000 ulps.
- ``kernels/mlr.py``: ``hyp_mlr`` with a tensor curvature against JAX's
  (the XLA twin): logits, dx, dp, da and dc in float64 at 1e-10; in
  float32 the logits at hyp_mlr's tier (rtol 2e-5, atol 2e-6, as
  ``tests/test_torch_mlr_head.py``) and dc at 1e-5 of its terms.
- ``models/hgcn.py``: ``train_step_lp`` (the CLI's), ``train_step_lp_
  pairs`` and ``train_step_lp_planned`` from one ``params_from_jax``
  state, fed JAX's negatives, learned curvature on and off, and
  ``train_step_nc`` with learned curvature: the first step's loss and
  every gradient (``c_raw``'s included), three steps' losses, the last
  layer's learned curvature after each step, float32 rtol 2e-5 (atol
  1e-6), and the parameters after three steps at rtol 2e-4 (atol 2e-6),
  the tier of the gradients that moved them.  The first layer's
  curvature has a gradient of rounding noise (the next layer's logmap0
  at c undoes its expmap0 at c), held under 1e-6 on both sides; Adam
  turns that noise into steps of about ±lr, so its value is not held.
  JAX runs its Pallas kernels in interpret mode.
  JAX's ``c_raw`` is created float64 under x64 (flax's constant
  initialiser); both sides start from its float32 rounding, the port's
  dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperspace_tpu.data import graphs as JG
from hyperspace_tpu.kernels import cluster as JC
from hyperspace_tpu.kernels import mlr as JM
from hyperspace_tpu.models import hgcn as jh
from hyperspace_tpu.nn import edge_dist as JE
from hyperspace_torch.data import graphs as TG
from hyperspace_torch.kernels import cluster as TC
from hyperspace_torch.kernels import mlr as TM
from hyperspace_torch.manifolds import Lorentz as TL
from hyperspace_torch.manifolds import PoincareBall as TB
from hyperspace_torch.models import hgcn as th
from hyperspace_torch.nn import edge_dist as TE
from hyperspace_torch.nn.mlr import LorentzMLR

TIERS = {np.float64: 1e-10, np.float32: 1e-5}
TDT = {np.float64: torch.float64, np.float32: torch.float32}
C = 0.7


def _points(rng, n, d, dt, scale=0.5):
    """Points on the hyperboloid of curvature C, made in float64 and
    rounded to ``dt``."""
    v = torch.zeros((n, d + 1), dtype=torch.float64)
    v[:, 1:] = torch.as_tensor(rng.standard_normal((n, d)) * scale)
    return TL(C).expmap0(v).numpy().astype(dt)


def _layout(n=300):
    edges, x, _, _ = TG.synthetic_hierarchy(num_nodes=n, feat_dim=4, seed=1)
    return TG.prepare(edges, n, x, pad_multiple=128, cache=False)


def _close(got, want, tol, terms=None):
    """|got − want| ≤ tol·(|want| + terms): rtol ``tol``, and a sum
    (``terms``: the sum of its terms' magnitudes, a number or one per
    element) also within ``tol`` of the sum of its terms, since two
    summation orders differ by that much."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    mag = 0.0 if terms is None else np.asarray(terms, np.float64)
    err = np.abs(got - want)
    bound = tol * (np.abs(want) + mag)
    assert got.shape == want.shape
    assert np.all(err <= bound), (
        f"{int((err > bound).sum())} of {err.size} beyond tol {tol}: "
        f"worst err/bound {float(np.max(err / np.maximum(bound, 1e-300)))}")


def _dc_terms(fn, c, h=1e-6):
    """Every output's derivative in the scalar c, by central differences
    in float64 (magnitudes for an error bound)."""
    c = float(c.detach())

    def at(cc):
        return fn(torch.tensor(cc, dtype=torch.float64)).double().numpy()

    return (at(c + h) - at(c - h)) / (2 * h)


def _row_terms(z, a_idx, b_idx, c, gbar):
    """Per element of dz, the sum of the magnitudes of the per-pair
    gradient rows scattered into it (a side at ``a_idx``, b at
    ``b_idx``)."""
    a = z[a_idx].detach().requires_grad_()
    b = z[b_idx].detach().requires_grad_()
    ga, gb = torch.autograd.grad(TL(c).sqdist(a, b), (a, b),
                                 torch.as_tensor(gbar))
    mag = torch.zeros_like(z, dtype=torch.float64)
    mag.index_add_(0, a_idx.long(), ga.abs().double())
    mag.index_add_(0, b_idx.long(), gb.abs().double())
    return mag.numpy()


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_graph_edge_sqdist_matches_jax(dt):
    g = _layout()
    rng = np.random.default_rng(3)
    z = _points(rng, g.num_nodes, 5, dt)
    s, r, rp = g.senders, g.receivers, g.rev_perm
    # degenerate positives (self-loops, padding) carry no cotangent, as
    # in the planned step
    gbar = (rng.standard_normal(len(s)) * (g.edge_mask & (s != r))).astype(dt)
    tol = TIERS[dt]

    def jloss(zz, cc):
        return jnp.sum(jnp.asarray(gbar) * JE.graph_edge_sqdist(
            zz, cc, s, r, rp, None, None, None, "lorentz"))

    want_v = JE.graph_edge_sqdist(jnp.asarray(z), jnp.asarray(C, dt), s, r,
                                  rp, None, None, None, "lorentz")
    want_dz, want_dc = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(z), jnp.asarray(C, dt))
    zt = torch.tensor(z, requires_grad=True)
    ct = torch.tensor(C, dtype=TDT[dt], requires_grad=True)
    si, ri, rpi = (TG.index_tensor(a, "cpu") for a in (s, r, rp))
    got = TE.graph_edge_sqdist(zt, ct, si, ri, rpi, None, "lorentz")
    (got * torch.as_tensor(gbar)).sum().backward()
    assert got.dtype == TDT[dt]
    # a self-loop's or padding edge's distance is rounding noise of a
    # point against itself: held under a few ulps, the rest at the tier
    real = g.edge_mask & (s != r)
    _close(got.detach()[real], np.asarray(want_v)[real], tol)
    noise = 1000 * np.finfo(dt).eps
    assert float(got.detach()[~real].abs().max()) <= noise
    assert float(np.abs(np.asarray(want_v)[~real]).max()) <= noise
    dz_terms = _row_terms(zt, si, ri, C, gbar)
    _close(zt.grad, want_dz, tol, dz_terms)
    # dc is a sum over every edge: held against the sum of its terms too
    z64 = torch.as_tensor(z, dtype=torch.float64)
    terms = np.abs(gbar * _dc_terms(
        lambda c_: TL(c_).sqdist(z64[si], z64[ri]), ct)).sum()
    _close(ct.grad, want_dc, tol, terms)
    # and against autograd of the plain distance in the port
    z2 = torch.tensor(z, requires_grad=True)
    c2 = torch.tensor(C, dtype=TDT[dt], requires_grad=True)
    (TL(c2).sqdist(z2[si], z2[ri]) * torch.as_tensor(gbar)).sum().backward()
    _close(zt.grad, z2.grad, tol, dz_terms)
    _close(ct.grad, c2.grad, tol, terms)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("op", ["planned", "semi"])
def test_planned_pair_ops_return_dc_as_jax(dt, op):
    n, p = 200, 900
    rng = np.random.default_rng(5)
    z = _points(rng, n, 4, dt)
    u = np.sort(rng.integers(0, n, p)).astype(np.int32)
    v = ((u + rng.integers(1, n, p)) % n).astype(np.int32)  # v ≠ u
    v_perm = np.argsort(v, kind="stable").astype(np.int32)
    gbar = rng.standard_normal(p).astype(dt)
    tol = TIERS[dt]

    def jfn(zz, cc):
        if op == "planned":
            return JE.pair_sqdist_planned(zz, cc, u, v, None, None, None,
                                          v_perm, v[v_perm], None, None,
                                          None, "lorentz")
        return JE.pair_sqdist_semi_planned(zz, cc, u, v, None, None, None,
                                           "lorentz")

    want_dz, want_dc = jax.jit(jax.grad(
        lambda zz, cc: jnp.sum(jnp.asarray(gbar) * jfn(zz, cc)),
        argnums=(0, 1)))(jnp.asarray(z), jnp.asarray(C, dt))
    zt = torch.tensor(z, requires_grad=True)
    ct = torch.tensor(C, dtype=TDT[dt], requires_grad=True)
    ut, vt = torch.as_tensor(u), torch.as_tensor(v)
    if op == "planned":
        out = TE.pair_sqdist_planned(zt, ct, ut, vt, None,
                                     torch.as_tensor(v_perm),
                                     torch.as_tensor(v[v_perm]), None)
    else:
        out = TE.pair_sqdist_semi_planned(zt, ct, ut, vt, None)
    (out * torch.as_tensor(gbar)).sum().backward()
    z64 = torch.as_tensor(z, dtype=torch.float64)
    per_pair = _dc_terms(lambda c_: TL(c_).sqdist(z64[ut], z64[vt]), ct)
    _close(zt.grad, want_dz, tol, _row_terms(zt, ut, vt, C, gbar))
    _close(ct.grad, want_dc, tol, np.abs(gbar * per_pair).sum())
    # a Python curvature, or one that needs no gradient, returns none
    for c in (C, torch.tensor(C, dtype=TDT[dt])):
        z3 = torch.tensor(z, requires_grad=True)
        TE.pair_sqdist_semi_planned(z3, c, ut, vt, None).sum().backward()
        assert z3.grad is not None


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_hyp_mlr_with_a_tensor_curvature_matches_jax(monkeypatch, dt):
    monkeypatch.setenv("HYPERSPACE_KERNELS", "xla")
    rng = np.random.default_rng(9)
    ball = TB(C)
    x = ball.expmap0(torch.as_tensor(rng.standard_normal((60, 6)) * 0.4)
                     ).numpy().astype(dt)
    p = ball.expmap0(torch.as_tensor(rng.standard_normal((5, 6)) * 0.3)
                     ).numpy().astype(dt)
    a = rng.standard_normal((5, 6)).astype(dt)
    g = rng.standard_normal((60, 5)).astype(dt)
    tol = TIERS[dt]
    want = JM.hyp_mlr(jnp.asarray(x), jnp.asarray(p), jnp.asarray(a),
                      jnp.asarray(C, dt))
    wgrads = jax.jit(jax.grad(
        lambda *t: jnp.sum(jnp.asarray(g) * JM.hyp_mlr(*t)),
        argnums=(0, 1, 2, 3)))(
        jnp.asarray(x), jnp.asarray(p), jnp.asarray(a), jnp.asarray(C, dt))
    ts = [torch.tensor(t, requires_grad=True) for t in (x, p, a)]
    ct = torch.tensor(C, dtype=TDT[dt], requires_grad=True)
    got = TM.hyp_mlr(*ts, ct)
    (got * torch.as_tensor(g)).sum().backward()
    if dt == np.float64:
        _close(got.detach(), want, tol)
        for t, w in zip(ts, wgrads[:3]):
            _close(t.grad, w, tol)
    else:   # the logits at hyp_mlr's f32 tier (tests/test_torch_mlr_head)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-6)
    terms = np.abs(g * _dc_terms(lambda c_: TM.hyp_mlr_plain(
        *(torch.as_tensor(t, dtype=torch.float64) for t in (x, p, a)), c_),
        ct)).sum()
    _close(ct.grad, wgrads[3], tol, terms)
    # the Lorentz head passes a learned curvature through to the kernel
    head = LorentzMLR(6, 5, TL(1.0), dtype=TDT[dt])
    xl = torch.as_tensor(_points(rng, 10, 6, dt))
    c_l = torch.tensor(C, dtype=TDT[dt], requires_grad=True)
    head(xl, c_l).sum().backward()
    assert c_l.grad is not None and torch.isfinite(c_l.grad)


# --- the steps ---------------------------------------------------------------

N, FEAT, STEPS = 600, 12, 3
TOL = dict(rtol=2e-5, atol=1e-6)


def _split(cluster: bool):
    edges, x, _, _ = JG.synthetic_hierarchy(num_nodes=N, feat_dim=FEAT,
                                            seed=0)
    kw = dict(seed=0, pad_multiple=256)
    js_ = JG.split_edges(edges, N, x, cache=False, **kw)
    ts_ = TG.split_edges(edges, N, x, cache=False, **kw)
    if cluster:
        for mod, sp in ((JC, js_), (TC, ts_)):
            g = sp.graph
            g.cluster_split = mod.build_cluster_split(
                g.senders, g.receivers, g.edge_mask, g.deg, N,
                min_pair_edges=8, rev_perm=g.rev_perm)
    return js_, ts_


def _f32_c_raw(model, opt, state):
    """JAX's state with every ``c_raw`` rounded to float32 and the
    optimizer restarted on it (its moments are zero at the start)."""
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a.astype(jnp.float32)
        if getattr(path[-1], "key", None) == "c_raw" else a, state.params)
    return state._replace(params=params, opt_state=opt.init(params))


def _bce(pos, neg, w_pos=None):
    bp = optax.sigmoid_binary_cross_entropy(pos, jnp.ones_like(pos))
    bn = optax.sigmoid_binary_cross_entropy(neg, jnp.zeros_like(neg))
    if w_pos is None:
        return (jnp.sum(bp) + jnp.sum(bn)) / (pos.shape[0] + neg.shape[0])
    return (jnp.sum(bp * w_pos) + jnp.sum(bn)) / (jnp.sum(w_pos)
                                                  + neg.shape[0])


# every layer's learned curvature but the last one's: logmap0 at c in the
# next layer undoes expmap0 at c, so its gradient is rounding noise, which
# Adam turns into steps of about ±lr in a direction the rounding picks;
# its gradient is held under NOISE_GRAD on both sides, its value is not
NOISY_C = ("encoder.conv0.c_raw",)
NOISE_GRAD = 1e-6


def _curvatures(params) -> list:
    """The last layer's learned curvature (the one the decoder or head
    reads; see NOISY_C)."""
    last = params["encoder"]["conv1"]
    return ([float(jax.nn.softplus(last["c_raw"]))] if "c_raw" in last
            else [])


def _jax_lp(kind, learn_c, js_):
    cfg = jh.HGCNConfig(feat_dim=FEAT, hidden_dims=(16, 8), learn_c=learn_c)
    model, opt, state = jh.init_lp(cfg, js_.graph, seed=0)
    if learn_c:
        state = _f32_c_raw(model, opt, state)
    ga = jh._device_graph(js_.graph)
    tp = jnp.asarray(js_.train_pos)
    pos = jh.make_planned_pairs(js_.train_pos, N)
    neg_u, neg_plan = jh.make_static_negatives(
        N, len(js_.train_pos) if kind == "pairs" else 2048, seed=0)
    p0 = jax.tree_util.tree_map(np.asarray, state.params)

    def loss_fn(params, neg):
        args = {"params": params}
        if kind == "lp":
            logits = model.apply(args, ga, jnp.concatenate([tp, neg]),
                                 deterministic=False)
            return _bce(logits[:len(tp)], logits[len(tp):])
        if kind == "pairs":
            return _bce(*model.apply(args, ga, pos, neg_u, neg, neg_plan,
                                     deterministic=False,
                                     method=jh.HGCNLinkPred.pair_logits))
        pl, w, nl = model.apply(args, ga, neg_u, neg, neg_plan,
                                deterministic=False,
                                method=jh.HGCNLinkPred.edge_logits)
        return _bce(pl, nl, w)

    negs, losses, curv = [], [], []
    for i in range(STEPS):
        k_neg = jax.random.split(state.key, 3)[1]
        neg = (jax.random.randint(k_neg, (len(tp), 2), 0, N) if kind == "lp"
               else jax.random.randint(k_neg, neg_u.shape, 0, N))
        negs.append(np.asarray(neg, np.int32))
        if i == 0:
            loss1, grads = jax.jit(jax.value_and_grad(loss_fn))(
                state.params, neg)
        if kind == "lp":
            state, loss = jh.train_step_lp(model, opt, N, state, ga, tp)
        elif kind == "pairs":
            state, loss = jh.train_step_lp_pairs(model, opt, N, state, ga,
                                                 pos, neg_u, neg_plan)
        else:
            state, loss = jh.train_step_lp_planned(model, opt, N, state, ga,
                                                   neg_u, neg_plan)
        losses.append(float(loss))
        curv.append(_curvatures(state.params))
    return dict(p0=p0, loss1=float(loss1), negs=negs, losses=losses,
                curv=curv, grads=jax.tree_util.tree_map(np.asarray, grads),
                params=jax.tree_util.tree_map(np.asarray, state.params))


def _torch_lp(kind, learn_c, ts_, j):
    cfg = th.HGCNConfig(feat_dim=FEAT, hidden_dims=(16, 8), learn_c=learn_c)
    model, opt, state = th.init_lp(cfg, ts_.graph, seed=0, device="cpu")
    model.load_state_dict(th.params_from_jax(j["p0"]))
    ga = TG.to_device(ts_.graph, "cpu")
    tp = TG.index_tensor(ts_.train_pos, "cpu")
    pos = th.make_planned_pairs(ts_.train_pos, N, torch.device("cpu"))
    neg_u, neg_plan = th.make_static_negatives(
        N, len(ts_.train_pos) if kind == "pairs" else 2048, seed=0,
        device="cpu")
    losses, curv, grads = [], [], None
    for i, neg in enumerate(j["negs"]):
        neg = torch.as_tensor(neg)
        if kind == "lp":
            state, loss = th.train_step_lp(model, opt, N, state, ga, tp,
                                           neg=neg)
        elif kind == "pairs":
            state, loss = th.train_step_lp_pairs(model, opt, N, state, ga,
                                                 pos, neg_u, neg_plan,
                                                 neg_v=neg)
        else:
            state, loss = th.train_step_lp_planned(model, opt, N, state, ga,
                                                   neg_u, neg_plan, neg_v=neg)
        if i == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        losses.append(float(loss))
        curv.append([float(model.encoder.conv1.out_curvature().detach())]
                    if learn_c else [])
    return dict(losses=losses, curv=curv, grads=grads, model=model)


@pytest.fixture(scope="module", params=[("lp", True, True),
                                        ("pairs", True, False),
                                        ("planned", True, True)],
                ids=["lp-learn_c-cluster", "pairs-learn_c",
                     "planned-learn_c-cluster"])
def lp_runs(request):
    kind, learn_c, cluster = request.param
    js_, ts_ = _split(cluster)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPERSPACE_KERNELS", "interpret")
        j = _jax_lp(kind, learn_c, js_)
    return request.param, j, _torch_lp(kind, learn_c, ts_, j)


def _check_grads(t_grads, j_grads):
    flat = th.params_from_jax(j_grads)
    assert sorted(flat) == sorted(t_grads)
    for k, g in t_grads.items():
        if k in NOISY_C:
            assert abs(float(g)) <= NOISE_GRAD
            assert abs(float(flat[k])) <= NOISE_GRAD
            continue
        np.testing.assert_allclose(g.numpy(), flat[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def _check_params(model, j_params):
    want = th.params_from_jax(j_params)
    for k, p in model.state_dict().items():
        if k not in NOISY_C:
            np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=2e-4,
                                       atol=2e-6, err_msg=k)


def test_lp_steps_first_loss_and_gradients(lp_runs):
    (kind, learn_c, _), j, t = lp_runs
    np.testing.assert_allclose(t["losses"][0], j["loss1"], rtol=1e-5)
    _check_grads(t["grads"], j["grads"])
    if learn_c:    # the decoder's (and the last layer's) curvature moves
        assert abs(float(t["grads"]["encoder.conv1.c_raw"])) > 1e-4


def test_lp_steps_trajectory_curvature_and_parameters(lp_runs):
    (kind, learn_c, _), j, t = lp_runs
    np.testing.assert_allclose(t["losses"], j["losses"], **TOL)
    np.testing.assert_allclose(t["curv"], j["curv"], **TOL)
    if learn_c:
        assert abs(t["curv"][-1][-1] - 1.0) > 1e-4      # it moved
    _check_params(t["model"], j["params"])


def test_nc_learned_curvature_matches_jax(monkeypatch):
    """Node classification with learn_c: the head's MLR takes the last
    layer's learned curvature, which gets its gradient from it."""
    monkeypatch.setenv("HYPERSPACE_KERNELS", "interpret")
    edges, x, labels, _ = JG.synthetic_hierarchy(num_nodes=N, feat_dim=FEAT,
                                                 num_classes=5, seed=0)
    tr, va, te = JG.node_split_masks(N, seed=0)
    fields = dict(labels=labels, num_classes=5, train_mask=tr, val_mask=va,
                  test_mask=te)
    jg = JG.prepare(edges, N, x, pad_multiple=256, cache=False, **fields)
    tg = TG.prepare(edges, N, x, pad_multiple=256, cache=False, **fields)
    kw = dict(feat_dim=FEAT, hidden_dims=(16, 8), num_classes=5,
              learn_c=True)
    model, opt, state = jh.init_nc(jh.HGCNConfig(**kw), jg, seed=0)
    state = _f32_c_raw(model, opt, state)
    ga = jh._device_graph(jg)
    lab, trm = jnp.asarray(jg.labels), jnp.asarray(jg.train_mask)
    p0 = jax.tree_util.tree_map(np.asarray, state.params)

    def loss_fn(params):
        logits = model.apply({"params": params}, ga)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, lab)
        w = trm.astype(ce.dtype)
        return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0)

    grads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(
        state.params))
    jl, jc = [], []
    for _ in range(STEPS):
        state, loss = jh.train_step_nc(model, opt, state, ga, lab, trm)
        jl.append(float(loss))
        jc.append(_curvatures(state.params))
    tmodel, topt, tstate = th.init_nc(th.HGCNConfig(**kw), tg, seed=0,
                                      device="cpu")
    tmodel.load_state_dict(th.params_from_jax(p0))
    tga = TG.to_device(tg, "cpu")
    tl, ttr = th.nc_targets(tg, "cpu")
    losses, curv, tgrads = [], [], None
    for i in range(STEPS):
        tstate, loss = th.train_step_nc(tmodel, topt, tstate, tga, tl, ttr)
        if i == 0:
            tgrads = {k: p.grad.clone() for k, p in tmodel.named_parameters()}
        losses.append(float(loss))
        curv.append([float(tmodel.encoder.conv1.out_curvature().detach())])
    _check_grads(tgrads, grads)
    assert abs(float(tgrads["encoder.conv1.c_raw"])) > 1e-4
    np.testing.assert_allclose(losses, jl, **TOL)
    np.testing.assert_allclose(curv, jc, **TOL)
    _check_params(tmodel, jax.tree_util.tree_map(np.asarray, state.params))


def test_train_lp_logs_validation_auc():
    edges, x, _, _ = TG.synthetic_hierarchy(num_nodes=192, feat_dim=8,
                                            seed=0)
    split = TG.split_edges(edges, 192, x, seed=0, pad_multiple=128)
    cfg = th.HGCNConfig(feat_dim=8, hidden_dims=(16, 8), learn_c=True)
    model, hist = th.train_lp(cfg, split, steps=20, log_every=10,
                              device="cpu")
    assert [h["step"] for h in hist] == [10, 20]
    assert all(np.isfinite(h["loss"]) and 0.0 <= h["roc_auc"] <= 1.0
               for h in hist)
    assert hist[-1]["loss"] < 0.69


def test_edge_logits_needs_the_symmetric_layout():
    edges, x, _, _ = TG.synthetic_hierarchy(num_nodes=64, feat_dim=4,
                                            seed=0)
    g = TG.prepare(edges, 64, x, symmetrize=False, cache=False)
    cfg = th.HGCNConfig(feat_dim=4, hidden_dims=(4,))
    model, _, _ = th.init_lp(cfg, g, seed=0, device="cpu")
    u, plan = th.make_static_negatives(64, 10, device="cpu")
    with pytest.raises(ValueError, match="symmetric"):
        model.edge_logits(TG.to_device(g, "cpu"), u, u, plan)

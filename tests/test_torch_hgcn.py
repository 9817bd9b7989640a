"""HGCN link-prediction training in the port against the JAX package, on
the CPU: the manifold math and its gradients, the optimizer, the whole
``train_step_lp_pairs`` step started from JAX's own ``init_lp``
parameters and fed JAX's negatives, ROC-AUC, and a short convergence run.

The JAX side runs its Pallas kernels in interpret mode.  float64 runs
under JAX's scoped ``enable_x64``.

Tolerances:
- manifold functions: f64 rtol 1e-10 (gradients at 0 and at ties are
  exact), f32 rtol 1e-5, bf16 2e-2 (JAX's CPU backend may compute a bf16
  chain in f32 and round once where PyTorch rounds after every op).
- f32 step: step-1 loss rtol 1e-5, every gradient rtol 1e-4 / atol 1e-6,
  5-step loss trajectory rtol 1e-4 (sums in other orders, compounded by
  five updates).
- bf16 step (bf16 edge messages and decoder, the arxiv config's lanes):
  5-step loss trajectory within rel 2e-2 (``docs/precision.md``'s bf16
  budget), at a learning rate where five steps are not chaotic.
- optimizer against optax: rtol 1e-6 over 5 updates; ROC-AUC 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperspace_tpu.data import graphs as JG
from hyperspace_tpu.kernels import cluster as JC
from hyperspace_tpu.manifolds import Lorentz as JL
from hyperspace_tpu.manifolds import smath as js
from hyperspace_tpu.models import hgcn as jh
from hyperspace_tpu.utils import metrics as jm
from hyperspace_torch.benchmarks import hgcn_bench as TB
from hyperspace_torch.data import graphs as TG
from hyperspace_torch.kernels import cluster as TC
from hyperspace_torch.manifolds import Lorentz as TL
from hyperspace_torch.manifolds import smath as ts
from hyperspace_torch.models import hgcn as th
from hyperspace_torch.precision import get_policy, parse_dtype
from hyperspace_torch.utils import metrics as tm

# --- manifold math ---------------------------------------------------------------


def test_safe_sqrt_and_arcosh1p_gradients_at_zero_and_ties():
    x = np.array([0.0, 1e-30, 4.0, -1.0, 1e-13])
    with jax.enable_x64(True):
        for jf, tf in ((js.safe_sqrt, ts.safe_sqrt),
                       (js.arcosh1p, ts.arcosh1p),
                       (lambda a: js.clamp_min(a, 0.0),
                        lambda a: ts.clamp_min(a, 0.0)),
                       (lambda a: jnp.clip(a, -1.0, 4.0),
                        lambda a: ts.clip(a, -1.0, 4.0)),
                       (js.sinhc, ts.sinhc)):
            want = np.asarray(jax.grad(lambda a: jf(a).sum())(jnp.asarray(x)))
            t = torch.tensor(x, requires_grad=True)
            tf(t).sum().backward()
            assert np.all(np.isfinite(t.grad.numpy()))
            np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-12)
            np.testing.assert_allclose(tf(torch.tensor(x)).numpy(),
                                       np.asarray(jf(jnp.asarray(x))),
                                       rtol=1e-15)


def _points(rng, n, d, scale=0.6):
    v = np.zeros((n, d + 1))
    v[:, 1:] = rng.standard_normal((n, d)) * scale
    return v


def test_lorentz_sqdist_gradient_at_coincident_points():
    """x == y exactly on the hyperboloid: sqdist 0 with a finite gradient
    (the old unbounded sqrt gradient gave 0·inf = NaN)."""
    x = np.array([[1.0, 0.0, 0.0], [1.25, 0.75, 0.0], [1.5, 1.0, 0.5]])
    with jax.enable_x64(True):
        want = np.asarray(jax.grad(lambda a: JL(1.0).sqdist(
            a, jnp.asarray(x)).sum())(jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    d = TL(1.0).sqdist(t, torch.tensor(x))
    assert torch.all(d == 0)
    d.sum().backward()
    assert torch.all(torch.isfinite(t.grad))
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("dt,tol", [(np.float64, 1e-10), (np.float32, 1e-5),
                                    ("bfloat16", 2e-2)])
@pytest.mark.parametrize("c", [1.0, 0.7])
def test_lorentz_maps_match_jax(dt, tol, c):
    rng = np.random.default_rng(0)
    jdt = {np.float64: jnp.float64, np.float32: jnp.float32,
           "bfloat16": jnp.bfloat16}[dt]
    tdt = {np.float64: torch.float64, np.float32: torch.float32,
           "bfloat16": torch.bfloat16}[dt]
    v, w = _points(rng, 40, 6), _points(rng, 40, 6)
    with jax.enable_x64(True):
        # shared inputs: points and a tangent made in f64, then rounded
        m64 = JL(c)
        x64, y64 = m64.expmap0(jnp.asarray(v)), m64.expmap0(jnp.asarray(w))
        shared = {"v": v, "x": np.asarray(x64), "y": np.asarray(y64),
                  "u": np.asarray(m64.logmap(x64, y64))}
        shared = {k: np.asarray(jnp.asarray(a, jdt)) for k, a in
                  shared.items()}
        jm_ = JL(c)
        a = {k: jnp.asarray(b) for k, b in shared.items()}
        want = {"expmap0": jm_.expmap0(a["v"]),
                "sqdist": jm_.sqdist(a["x"], a["y"]),
                "logmap": jm_.logmap(a["x"], a["y"]),
                "logmap0": jm_.logmap0(a["y"]),
                "expmap": jm_.expmap(a["x"], a["u"]),
                "origin": jm_.origin((3, 7), jdt),
                "coords": jm_.origin_coords_from_tangent(a["v"]),
                "tangent": jm_.tangent_from_origin_coords(a["v"][:, 1:])}
        want = {k: np.asarray(b, np.float64) for k, b in want.items()}
    for cc in (c, torch.tensor(c, dtype=torch.float64)):
        tm_ = TL(cc)
        a = {k: torch.tensor(np.asarray(b, np.float64)).to(tdt)
             for k, b in shared.items()}
        got = {"expmap0": tm_.expmap0(a["v"]),
               "sqdist": tm_.sqdist(a["x"], a["y"]),
               "logmap": tm_.logmap(a["x"], a["y"]),
               "logmap0": tm_.logmap0(a["y"]),
               "expmap": tm_.expmap(a["x"], a["u"]),
               "origin": tm_.origin((3, 7), tdt, "cpu"),
               "coords": tm_.origin_coords_from_tangent(a["v"]),
               "tangent": tm_.tangent_from_origin_coords(a["v"][:, 1:])}
        for k, b in got.items():
            assert b.dtype == tdt, k
            np.testing.assert_allclose(b.double().numpy(), want[k], rtol=tol,
                                       atol=tol, err_msg=k)


# --- optimizer ---------------------------------------------------------------------


@pytest.mark.parametrize("clip", [0.0, 0.3])
def test_adamw_matches_optax(clip):
    rng = np.random.default_rng(1)
    shapes = {"decoder": {"r": (), "t_raw": ()},
              "encoder": {"conv0": {"bias": (5,), "kernel": (4, 5)}}}
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple)) for _ in range(5)]
    cfg = jh.HGCNConfig(lr=3e-2, weight_decay=5e-3, clip_norm=clip)
    opt = jh.make_optimizer(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = opt.init(jp)
    for g in grads:
        upd, st = opt.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[f"{prefix}{k}"] = v
        return out

    tp = {k: torch.tensor(v) for k, v in flat(params).items()}
    topt = th.AdamW(tp, cfg.lr, cfg.weight_decay,
                    clip if clip > 0 else math.inf)
    for g in grads:
        fg = flat(g)
        topt.step([torch.tensor(fg[k]) for k in topt.names])
    for k, v in flat(jax.tree_util.tree_map(np.asarray, jp)).items():
        np.testing.assert_allclose(tp[k].numpy(), v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)


# --- the step ---------------------------------------------------------------------

N_STEP = 600
STEPS = 5


def _splits(cluster: bool):
    edges, x, _, _ = JG.synthetic_hierarchy(num_nodes=N_STEP, feat_dim=12,
                                            seed=0)
    kw = dict(seed=0, pad_multiple=256)
    js_ = JG.split_edges(edges, N_STEP, x, cache=False, **kw)
    ts_ = TG.split_edges(edges, N_STEP, x, **kw)
    if cluster:
        for mod, sp in ((JC, js_), (TC, ts_)):
            g = sp.graph
            g.cluster_split = mod.build_cluster_split(
                g.senders, g.receivers, g.edge_mask, g.deg, N_STEP,
                min_pair_edges=8, rev_perm=g.rev_perm)
        assert 0.1 < ts_.graph.cluster_split.frac_clustered < 1.0
    ts_.test_neg = js_.test_neg  # score the same held-out pairs
    return js_, ts_


def _jax_run(js_, agg_dtype, decoder_dtype, lr=1e-2):
    """JAX's init, step-1 loss and gradients, the neg_v of each step, the
    5-step losses and the test ROC-AUC after them."""
    cfg = jh.HGCNConfig(feat_dim=12, hidden_dims=(16, 8), lr=lr,
                        agg_dtype=agg_dtype, decoder_dtype=decoder_dtype)
    model, opt, state = jh.init_lp(cfg, js_.graph, seed=0)
    ga = jh._device_graph(js_.graph)
    pos = jh.make_planned_pairs(js_.train_pos, N_STEP)
    neg_u, neg_plan = jh.make_static_negatives(N_STEP, int(pos.u.shape[0]),
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

    neg_vs, losses = [], []
    for i in range(STEPS):
        k_neg = jax.random.split(state.key, 3)[1]
        neg_v = jax.random.randint(k_neg, neg_u.shape, 0, N_STEP)
        neg_vs.append(np.asarray(neg_v, np.int32))
        if i == 0:
            loss1, grads = jax.jit(jax.value_and_grad(loss_fn))(
                state.params, neg_v)
        state, loss = jh.train_step_lp_pairs(model, opt, N_STEP, state, ga,
                                             pos, neg_u, neg_plan)
        losses.append(float(loss))
    auc = jh.evaluate_lp(model, state.params, js_, "test", ga=ga)["roc_auc"]
    return dict(params0=params0, loss1=float(loss1),
                grads=jax.tree_util.tree_map(np.asarray, grads),
                neg_vs=neg_vs, losses=losses, auc=auc)


def _torch_run(ts_, jax_out, agg_dtype, decoder_dtype, lr=1e-2):
    cfg = th.HGCNConfig(feat_dim=12, hidden_dims=(16, 8), lr=lr,
                        agg_dtype=agg_dtype, decoder_dtype=decoder_dtype)
    model, opt, state = th.init_lp(cfg, ts_.graph, seed=0, device="cpu")
    model.load_state_dict(th.params_from_jax(jax_out["params0"]))
    ga = TG.to_device(ts_.graph, "cpu")
    pos = th.make_planned_pairs(ts_.train_pos, N_STEP, torch.device("cpu"))
    neg_u, neg_plan = th.make_static_negatives(N_STEP, int(pos.u.shape[0]),
                                               seed=0, device="cpu")
    losses, grads = [], None
    for i, neg_v in enumerate(jax_out["neg_vs"]):
        state, loss = th.train_step_lp_pairs(
            model, opt, N_STEP, state, ga, pos, neg_u, neg_plan,
            neg_v=torch.as_tensor(neg_v))
        if i == 0:  # the gradients at the initial parameters
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        losses.append(float(loss))
    assert state.step == STEPS
    auc = th.evaluate_lp(model, ts_, "test", ga=ga)["roc_auc"]
    return dict(losses=losses, grads=grads, auc=auc)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "cluster"])
def f32_runs(request):
    js_, ts_ = _splits(request.param)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPERSPACE_KERNELS", "interpret")
        j = _jax_run(js_, None, None)
    return j, _torch_run(ts_, j, None, None)


def test_f32_step_loss_and_gradients(f32_runs):
    j, t = f32_runs
    np.testing.assert_allclose(t["losses"][0], j["loss1"], rtol=1e-5)
    flat = th.params_from_jax(j["grads"])
    assert sorted(flat) == sorted(t["grads"])
    for k, g in t["grads"].items():
        np.testing.assert_allclose(g.numpy(), flat[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_f32_loss_trajectory_and_auc(f32_runs):
    j, t = f32_runs
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-4)
    assert abs(t["auc"] - j["auc"]) <= 1e-6


@pytest.mark.parametrize("cluster", [False, True])
def test_bf16_loss_trajectory(monkeypatch, cluster):
    """At lr 3e-3.  At the default 1e-2 five steps on this 600-node graph
    are chaotic: the JAX package's own bf16 run leaves its f32 run by 7%
    at step 5 (and the port's bf16 run stays within that spread), so
    the comparison would measure the chaos, not the bf16 lanes."""
    monkeypatch.setenv("HYPERSPACE_KERNELS", "interpret")
    js_, ts_ = _splits(cluster)
    j = _jax_run(js_, jnp.bfloat16, jnp.bfloat16, lr=3e-3)
    t = _torch_run(ts_, j, torch.bfloat16, torch.bfloat16, lr=3e-3)
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=2e-2)
    assert np.all(np.isfinite(t["losses"]))


def test_roc_auc_matches_jax():
    rng = np.random.default_rng(2)
    pos = rng.standard_normal(300).round(1)
    neg = rng.standard_normal(200).round(1) - 0.5   # with ties
    assert tm.roc_auc(pos, neg) == jm.roc_auc(pos, neg)
    assert math.isnan(tm.roc_auc(pos, neg[:0]))


def test_params_from_jax_refuses_unported_leaves():
    """``c_raw`` (learned curvature) is carried since it was ported; a
    leaf no port module declares is still refused."""
    tree = {"encoder": {"conv0": {"kernel": np.zeros((2, 2)),
                                  "c_raw": np.zeros(())}},
            "decoder": {"r": np.zeros(()), "t_raw": np.zeros(())}}
    assert "encoder.conv0.c_raw" in th.params_from_jax(tree)
    tree["encoder"]["conv0"]["scale"] = np.zeros(())
    with pytest.raises(NotImplementedError, match="scale"):
        th.params_from_jax(tree)


def test_precision_rules():
    assert parse_dtype("bfloat16") is torch.bfloat16
    assert parse_dtype(None, torch.float32) is torch.float32
    with pytest.raises(ValueError, match="dtype"):
        parse_dtype("float8")
    assert get_policy("bf16").mixed and not get_policy(None).mixed
    cfg = th.HGCNConfig(precision="bf16")
    assert cfg.resolved_agg_dtype() is torch.bfloat16
    assert th.HGCNConfig(precision="bf16", decoder_dtype=torch.float32
                         ).resolved_decoder_dtype() is torch.float32
    assert th.HGCNConfig().resolved_agg_dtype() is None
    with pytest.raises(ValueError, match="precision"):
        get_policy("fp8")


def test_port_trains_on_its_own():
    """25 steps of the port's own init at 192 nodes (the JAX package's
    smoke test): finite losses, the last below the first."""
    edges, x, _, _ = TG.synthetic_hierarchy(num_nodes=192, feat_dim=12,
                                            seed=0)
    split = TG.split_edges(edges, 192, x, seed=0, pad_multiple=128)
    cfg = th.HGCNConfig(feat_dim=12, hidden_dims=(16, 8))
    model, opt, state = th.init_lp(cfg, split.graph, seed=0, device="cpu")
    ga = TG.to_device(split.graph, "cpu")
    pos = th.make_planned_pairs(split.train_pos, 192, torch.device("cpu"))
    neg_u, neg_plan = th.make_static_negatives(192, int(pos.u.shape[0]),
                                               seed=0, device="cpu")
    losses = []
    for _ in range(25):
        state, loss = th.train_step_lp_pairs(model, opt, 192, state, ga, pos,
                                             neg_u, neg_plan)
        losses.append(float(loss))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    with pytest.raises(ValueError, match="neg_per_pos"):
        th.train_step_lp_pairs(model, opt, 192, state, ga, pos, neg_u[:5],
                               neg_plan)


def test_bench_on_the_cpu():
    out = TB.run_hgcn_bench(steps=2, num_nodes=1500, device="cpu")
    assert out["device"] == "cpu" and out["card"] is None
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert out["value"] == pytest.approx(1500 * 2 / (out["step_ms"] * 2e-3))
    assert out["frac_clustered"] is None   # under 200,000 edges: no split
    assert out["agg_dtype"] == "torch.bfloat16"

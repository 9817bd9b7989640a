"""HGCN node classification in the port (``models/hgcn.py``: ``init_nc``,
``train_step_nc``, ``evaluate_nc``; ``data/graphs.py:node_split_masks``;
``utils/metrics.py:f1_macro``) against the JAX package, on the CPU.

The graph is the synthetic hierarchy at 600 nodes with 5 classes, with
and without a cluster split; both packages start from JAX's ``init_nc``
parameters (``params_from_jax``).  The JAX side runs its Pallas kernels
(the segment sum, the cluster aggregation, ``hyp_mlr``) in interpret
mode.  Tolerances, f32: logits rtol 1e-5 (atol 1e-6), three steps'
losses and parameters rtol 2e-5 (atol 1e-6); masks bitwise; accuracy,
macro-F1 and ``evaluate_nc`` exactly.  Dropout (default 0) is held by its
keep rate and scale, not by JAX's bits.
"""

import jax
import numpy as np
import pytest
import torch

from hyperspace_tpu.data import graphs as JG
from hyperspace_tpu.kernels import cluster as JC
from hyperspace_tpu.models import hgcn as jh
from hyperspace_tpu.utils import metrics as jm
from hyperspace_torch.data import graphs as TG
from hyperspace_torch.kernels import cluster as TC
from hyperspace_torch.models import hgcn as th
from hyperspace_torch.nn import gcn as tgcn
from hyperspace_torch.utils import metrics as tm

N, CLASSES, FEAT, STEPS = 600, 5, 12, 3
TOL = dict(rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("n,train,val,seed", [(300, 0.6, 0.2, 0),
                                              (1001, 0.5, 0.25, 7),
                                              (7, 0.6, 0.2, 3)])
def test_node_split_masks_match_jax_bitwise(n, train, val, seed):
    want = JG.node_split_masks(n, train, val, seed=seed)
    got = TG.node_split_masks(n, train, val, seed=seed)
    for w, g in zip(want, got):
        assert g.dtype == bool and np.array_equal(g, w)
    assert np.array_equal(got[0] | got[1] | got[2], np.ones(n, bool))
    assert not np.any((got[0] & got[1]) | (got[1] & got[2]))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [3, 7])
def test_accuracy_and_f1_macro_equal_jax(masked, k):
    rng = np.random.default_rng(k)
    logits = rng.standard_normal((500, k)).astype(np.float32)
    labels = rng.integers(0, k, 500)
    labels[:40] = logits[:40].argmax(-1)          # some right answers
    mask = rng.random(500) < 0.4 if masked else None
    assert tm.accuracy(logits, labels, mask) == jm.accuracy(logits, labels,
                                                            mask)
    assert tm.f1_macro(logits, labels, k, mask) == jm.f1_macro(
        logits, labels, k, mask)


def test_f1_macro_skips_absent_classes_and_empty_masks():
    logits = np.eye(4, dtype=np.float32)[[0, 1, 1]]
    labels = np.array([0, 1, 0])
    for mask in (None, np.array([True, False, True]),
                 np.zeros(3, bool)):
        assert tm.f1_macro(logits, labels, 4, mask) == jm.f1_macro(
            logits, labels, 4, mask)


def _graphs(cluster: bool):
    edges, x, labels, _ = JG.synthetic_hierarchy(
        num_nodes=N, feat_dim=FEAT, num_classes=CLASSES, seed=0)
    tr, va, te = JG.node_split_masks(N, seed=0)
    fields = dict(labels=labels, num_classes=CLASSES, train_mask=tr,
                  val_mask=va, test_mask=te)
    jg = JG.prepare(edges, N, x, pad_multiple=256, cluster=False,
                    cache=False, **fields)
    tg = TG.prepare(edges, N, x, pad_multiple=256, cluster=False, **fields)
    if cluster:
        for mod, g in ((JC, jg), (TC, tg)):
            g.cluster_split = mod.build_cluster_split(
                g.senders, g.receivers, g.edge_mask, g.deg, N,
                min_pair_edges=8, rev_perm=g.rev_perm)
        assert 0.1 < tg.cluster_split.frac_clustered < 1.0
    return jg, tg


def test_prepare_carries_the_node_fields():
    jg, tg = _graphs(False)
    for name in ("labels", "train_mask", "val_mask", "test_mask"):
        assert np.array_equal(getattr(tg, name), getattr(jg, name)), name
    assert tg.num_classes == jg.num_classes == CLASSES
    assert np.array_equal(tg.senders, jg.senders)


def _cfgs(**kw):
    base = dict(feat_dim=FEAT, hidden_dims=(16, 8), num_classes=CLASSES)
    base.update(kw)
    return jh.HGCNConfig(**base), th.HGCNConfig(**base)


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "cluster"])
def nc_runs(request):
    """JAX: initial parameters and logits, three steps' losses, the
    parameters after them and ``evaluate_nc``; the port the same from
    JAX's initial parameters."""
    jg, tg = _graphs(request.param)
    jc, tc = _cfgs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYPERSPACE_KERNELS", "interpret")
        model, opt, state = jh.init_nc(jc, jg, seed=0)
        ga = jh._device_graph(jg)
        p0 = jax.tree_util.tree_map(np.asarray, state.params)
        logits0 = np.asarray(jh.eval_logits_nc(model, state.params, ga))
        labels, trm = jax.numpy.asarray(jg.labels), jax.numpy.asarray(
            jg.train_mask)
        losses = []
        for _ in range(STEPS):
            state, loss = jh.train_step_nc(model, opt, state, ga, labels, trm)
            losses.append(float(loss))
        j = dict(p0=p0, logits0=logits0, losses=losses,
                 params=jax.tree_util.tree_map(np.asarray, state.params),
                 ev=jh.evaluate_nc(model, state.params, jg, ga=ga))
    tmodel, topt, tstate = th.init_nc(tc, tg, seed=0, device="cpu")
    tmodel.load_state_dict(th.params_from_jax(p0))
    tga = TG.to_device(tg, "cpu")
    t = dict(logits0=th.eval_logits_nc(tmodel, tga).numpy())
    tl, ttr = th.nc_targets(tg, "cpu")
    t["losses"] = []
    for _ in range(STEPS):
        tstate, loss = th.train_step_nc(tmodel, topt, tstate, tga, tl, ttr)
        t["losses"].append(float(loss))
    assert tstate.step == STEPS
    t["params"] = {k: v.detach().numpy()
                   for k, v in tmodel.state_dict().items()}
    t["ev"] = th.evaluate_nc(tmodel, tg, ga=tga)
    return j, t


def test_nc_logits_match_jax(nc_runs):
    j, t = nc_runs
    assert t["logits0"].shape == (N, CLASSES)
    np.testing.assert_allclose(t["logits0"], j["logits0"], rtol=1e-5,
                               atol=1e-6)


def test_nc_steps_match_jax(nc_runs):
    j, t = nc_runs
    np.testing.assert_allclose(t["losses"], j["losses"], **TOL)
    want = {k: v.numpy() for k, v in th.params_from_jax(j["params"]).items()}
    assert sorted(want) == sorted(t["params"])
    for k, v in t["params"].items():
        np.testing.assert_allclose(v, want[k], err_msg=k, **TOL)


def test_nc_evaluate_equals_jax(nc_runs):
    j, t = nc_runs
    assert sorted(t["ev"]) == ["test_acc", "test_f1", "val_acc"]
    assert t["ev"] == j["ev"]


def test_nc_trains_on_its_own():
    _, tg = _graphs(True)
    _, tc = _cfgs(lr=1e-2)
    model, res = th.train_nc(tc, tg, steps=40, seed=1, device="cpu")
    assert np.isfinite(res["loss"])
    first = th.train_nc(tc, tg, steps=1, seed=1, device="cpu")[1]["loss"]
    assert res["loss"] < first
    assert res["val_acc"] > 1.0 / CLASSES


def test_nc_dropout_keep_rate_and_scale():
    """Dropout on the encoder's linear maps draws from the step's
    generator: at rate 0.3 the kept share is 0.7 and kept entries are
    scaled by 1/0.7 (JAX's bits are not reproduced)."""
    h = torch.ones(400, 50)
    gen = torch.Generator().manual_seed(0)
    out = tgcn.dropout(h, 0.3, gen)
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.02
    np.testing.assert_allclose(out[kept].numpy(), 1.0 / 0.7, rtol=1e-6)
    _, tg = _graphs(False)
    _, tc = _cfgs(dropout=0.3)
    model, opt, state = th.init_nc(tc, tg, seed=0, device="cpu")
    ga = TG.to_device(tg, "cpu")
    labels, tr = th.nc_targets(tg, "cpu")
    a = model(ga, deterministic=False, generator=torch.Generator(
        ).manual_seed(5))
    b = model(ga, deterministic=False, generator=torch.Generator(
        ).manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, model(ga))
    state, loss = th.train_step_nc(model, opt, state, ga, labels, tr)
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("kind", ["poincare", "euclidean"])
def test_nc_head_off_the_hyperboloid_raises(kind):
    _, tc = _cfgs(kind=kind)
    with pytest.raises(NotImplementedError):
        th.HGCNNodeClf(tc)


def test_params_from_jax_refuses_a_dense_head():
    tree = {"encoder": {}, "head": {"kernel": np.zeros((8, 5)),
                                    "bias": np.zeros(5)}}
    with pytest.raises(NotImplementedError):
        th.params_from_jax(tree)


def test_make_manifold_still_refuses_the_ball():
    """HGCN on the ball is not ported: the HVAE resolves its own latent
    manifold, and ``nn/gcn.py:make_manifold`` still raises."""
    with pytest.raises(NotImplementedError):
        tgcn.make_manifold("poincare", 1.0)


ARXIV_LIKE_NODES, ARXIV_LIKE_STEPS = 3_000, 6


def test_nc_time_coordinate_grows_as_in_jax_at_arxiv_width():
    """At the smoke's width (the arxiv-like hierarchy's 128 features of
    norm ~10-14, hidden (128, 32), 40 classes, lr 1e-2) the encoder's
    largest time coordinate grows by orders of magnitude a step, in JAX
    as in the port: from one ``params_from_jax`` state, in float64, six
    steps' losses and per-step largest time coordinates agree within rel
    1e-7, and JAX's grows more than a million-fold over the six steps.
    JAX runs its XLA twins of the kernels (``HYPERSPACE_KERNELS=xla``)."""
    from hyperspace_torch.benchmarks import hgcn_bench as B

    n = ARXIV_LIKE_NODES
    edges, x, labels, k = B.arxiv_scale_graph(n, seed=0)
    tr, va, te = JG.node_split_masks(n, seed=0)
    fields = dict(labels=labels, num_classes=k, train_mask=tr, val_mask=va,
                  test_mask=te)
    base = dict(feat_dim=x.shape[1], hidden_dims=(128, 32), num_classes=k,
                kind="lorentz", lr=1e-2)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setenv("HYPERSPACE_KERNELS", "xla")
        jg = JG.prepare(edges, n, x, pad_multiple=256, cluster=False,
                        cache=False, **fields)
        jc = jh.HGCNConfig(**base, dtype=jax.numpy.float64)
        model, opt, state = jh.init_nc(jc, jg, seed=0)
        ga = jh._device_graph(jg)
        p0 = jax.tree_util.tree_map(np.asarray, state.params)
        enc = jh.HGCNEncoder(jc)

        @jax.jit
        def j_max_time(params):
            z, _ = enc.apply({"params": params["encoder"]}, ga)
            return jax.numpy.max(z[:, 0])

        def j_time(params):
            return float(j_max_time(params))

        lab, trm = jax.numpy.asarray(jg.labels), jax.numpy.asarray(
            jg.train_mask)
        j_loss, j_t = [], [j_time(state.params)]
        for _ in range(ARXIV_LIKE_STEPS):
            state, loss = jh.train_step_nc(model, opt, state, ga, lab, trm)
            j_loss.append(float(loss))
            j_t.append(j_time(state.params))

    tg = TG.prepare(edges, n, x, pad_multiple=256, cluster=False, **fields)
    tc = th.HGCNConfig(**base, dtype=torch.float64)
    tmodel, topt, tstate = th.init_nc(tc, tg, seed=0, device="cpu")
    tmodel.load_state_dict(th.params_from_jax(p0))
    tga = TG.to_device(tg, "cpu")
    tl, ttr = th.nc_targets(tg, "cpu")

    def t_time():
        with torch.no_grad():
            z, _ = tmodel.encoder(tga)
        assert z.dtype == torch.float64
        return float(z[:, 0].max())

    t_loss, t_t = [], [t_time()]
    for _ in range(ARXIV_LIKE_STEPS):
        tstate, loss = th.train_step_nc(tmodel, topt, tstate, tga, tl, ttr)
        t_loss.append(float(loss))
        t_t.append(t_time())
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-7, atol=0)
    np.testing.assert_allclose(t_t, j_t, rtol=1e-7, atol=0)
    assert j_t[-1] > 1e6 * j_t[0], j_t

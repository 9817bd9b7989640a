"""The port's host graph preparation against the JAX package, on the CPU:
the same seed must give the same arrays (the held-out negatives excepted,
which are held to validity — the JAX package draws them from its C++
sampler)."""

import numpy as np
import pytest

from hyperspace_tpu.data import graphs as JG
from hyperspace_tpu.kernels import cluster as JC
from hyperspace_tpu.kernels import segment as JS
from hyperspace_tpu.models import hgcn as jhgcn
from hyperspace_torch.benchmarks import hgcn_bench as TB
from hyperspace_torch.data import graphs as TG
from hyperspace_torch.kernels import cluster as TC
from hyperspace_torch.kernels import segment as TS
from hyperspace_torch.models import hgcn as thgcn

N = 2000


def assert_tuples_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def hierarchy():
    return (JG.synthetic_hierarchy(num_nodes=N, feat_dim=16, seed=3),
            TG.synthetic_hierarchy(num_nodes=N, feat_dim=16, seed=3))


def test_synthetic_hierarchy_equal(hierarchy):
    (je, jx, jl, jk), (te, tx, tl, tk) = hierarchy
    np.testing.assert_array_equal(je, te)
    np.testing.assert_array_equal(jx, tx)
    np.testing.assert_array_equal(jl, tl)
    assert jk == tk


def test_arxiv_scale_graph_equal_at_small_size():
    from hyperspace_tpu.benchmarks import hgcn_bench as JB

    for a, b in zip(JB.arxiv_scale_graph(1500, seed=1),
                    TB.arxiv_scale_graph(1500, seed=1)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["bfs", "community"])
def test_locality_orders_equal(hierarchy, method):
    (edges, x, labels, _), _ = hierarchy
    want = JG.apply_locality_order(edges, x, labels, method=method,
                                   cache=False)
    got = TG.apply_locality_order(edges, x, labels, method=method)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(JG.locality_order(edges, N),
                                  TG.locality_order(edges, N))


def _fields(g):
    return (g.senders, g.receivers, g.edge_mask, g.rev_perm, g.deg)


@pytest.mark.parametrize("cluster,min_pair", [(True, 8), (True, 256),
                                              (False, 256)])
def test_prepare_equal(hierarchy, cluster, min_pair):
    (edges, x, _, _), _ = hierarchy
    jg = JG.prepare(edges, N, x, cluster=cluster, pad_multiple=256,
                    cluster_min_pair=min_pair, cache=False)
    tg = TG.prepare(edges, N, x, cluster=cluster, pad_multiple=256,
                    cluster_min_pair=min_pair)
    assert_tuples_equal(_fields(jg), _fields(tg))
    assert_tuples_equal(jg.csr_plan, tg.csr_plan)
    np.testing.assert_array_equal(jg.x, tg.x)
    if not cluster:
        assert jg.cluster_split is None and tg.cluster_split is None
        return
    js, ts = jg.cluster_split, tg.cluster_split
    assert js._fields == ts._fields
    for name in js._fields:
        a, b = getattr(js, name), getattr(ts, name)
        if name.endswith("plan"):
            assert_tuples_equal(a, b)
        elif name == "frac_clustered":
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
    if min_pair == 8:
        assert 0.0 < ts.frac_clustered < 1.0


def test_cluster_split_without_rev_perm_and_empty_clustered_set(hierarchy):
    (edges, x, _, _), _ = hierarchy
    g = TG.prepare(edges, N, x, cluster=False, pad_multiple=256)
    for kw in ({"min_pair_edges": 16}, {"min_pair_edges": 10**6}):
        js = JC.build_cluster_split(g.senders, g.receivers, g.edge_mask,
                                    g.deg, N, **kw)
        ts = TC.build_cluster_split(g.senders, g.receivers, g.edge_mask,
                                    g.deg, N, **kw)
        assert ts.s_rev_local is None and ts.s_mask is None
        for name in ("c_recv", "c_send", "c_wf", "c_wb", "s_recv", "s_send",
                     "s_wf", "s_wb"):
            np.testing.assert_array_equal(getattr(js, name),
                                          getattr(ts, name))
        assert_tuples_equal(js.c_plan, ts.c_plan)
        assert_tuples_equal(js.s_plan, ts.s_plan)
    assert len(ts.c_recv) == 0
    with pytest.raises(ValueError, match="bn == bs"):
        TC.build_cluster_split(g.senders, g.receivers, g.edge_mask, g.deg, N,
                               bn=256, bs=128)


@pytest.mark.parametrize("n,e", [(300, 2000), (50, 64), (7, 3), (300, 512),
                                 (1000, 5000), (1, 0)])
def test_build_csr_plan_equal(n, e):
    rng = np.random.default_rng(n + e)
    r = np.sort(rng.integers(0, min(n, 128) if e == 512 else n,
                             e)).astype(np.int32)
    assert_tuples_equal(JS.build_csr_plan(r, n), TS.build_csr_plan(r, n))
    hub = np.sort(np.where(rng.random(e) < 0.9, n // 2,
                           rng.integers(0, n, e))).astype(np.int32)
    assert_tuples_equal(JS.build_csr_plan(hub, n), TS.build_csr_plan(hub, n))
    with pytest.raises(ValueError, match="sorted"):
        TS.build_csr_plan(np.asarray([3, 1, 2], np.int32), 5)


def _by_pair(r, s, n):
    key = (r // 256).astype(np.int64) * (n // 256 + 1) + s // 256
    o = np.argsort(key, kind="stable")
    return r[o], s[o]


@pytest.mark.parametrize("n,e,lo,hi", [(700, 4000, 0, 700), (257, 513, 0, 257),
                                       (1500, 600, 512, 768), (600, 0, 0, 1)])
def test_build_cluster_plan_equal(n, e, lo, hi):
    rng = np.random.default_rng(e)
    r, s = _by_pair(rng.integers(lo, hi, e).astype(np.int32),
                    rng.integers(0, n, e).astype(np.int32), n)
    assert_tuples_equal(JC.build_cluster_plan(r, s, n),
                        TC.build_cluster_plan(r, s, n))
    if e:
        with pytest.raises(ValueError, match="sorted"):
            TC.build_cluster_plan(r[::-1].copy(), s[::-1].copy(), n)


@pytest.fixture(scope="module")
def splits(hierarchy):
    (edges, x, _, _), _ = hierarchy
    kw = dict(val_frac=0.05, test_frac=0.1, seed=5, pad_multiple=256)
    return (JG.split_edges(edges, N, x, cache=False, **kw),
            TG.split_edges(edges, N, x, **kw), edges)


def test_split_edges_positives_and_graph_equal(splits):
    js, ts, _ = splits
    for name in ("train_pos", "val_pos", "test_pos"):
        np.testing.assert_array_equal(getattr(js, name), getattr(ts, name))
        assert getattr(ts, name).dtype == np.int32
    assert_tuples_equal(_fields(js.graph), _fields(ts.graph))
    assert_tuples_equal(js.graph.csr_plan, ts.graph.csr_plan)


def test_split_edges_negatives_valid(splits):
    _, ts, edges = splits
    canon = {(int(min(u, v)), int(max(u, v))) for u, v in edges}
    for which in ("val", "test"):
        neg = getattr(ts, f"{which}_neg")
        assert neg.shape == getattr(ts, f"{which}_pos").shape
        assert neg.dtype == np.int32
        assert np.all(neg[:, 0] < neg[:, 1])
        assert not any((int(u), int(v)) in canon for u, v in neg)


def test_static_negatives_and_planned_pairs_equal(splits):
    import torch

    js, ts, _ = splits
    ju, jplan = jhgcn.make_static_negatives(N, 3000, seed=2)
    tu, tplan = thgcn.make_static_negatives(N, 3000, seed=2, device="cpu")
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    assert_tuples_equal(jplan, [a.numpy() for a in tplan])
    jp = jhgcn.make_planned_pairs(js.train_pos, N)
    tp = thgcn.make_planned_pairs(ts.train_pos, N, torch.device("cpu"))
    for name in ("u", "v", "v_perm", "v_sorted"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                      getattr(tp, name).numpy())
    for name in ("u_plan", "v_plan"):
        assert_tuples_equal(getattr(jp, name),
                            [a.numpy() for a in getattr(tp, name)])


def test_to_device_and_edge_range(splits):
    _, ts, _ = splits
    dg = TG.to_device(ts.graph, "cpu")
    assert dg.senders.dtype == dg.receivers.dtype == dg.rev_perm.dtype
    np.testing.assert_array_equal(dg.receivers.numpy(), ts.graph.receivers)
    assert dg.num_nodes == N and dg.cluster is None
    with pytest.raises(IndexError, match="out of range"):
        TG.prepare(np.asarray([[0, N]]), N, np.zeros((N, 2), np.float32))
    with pytest.raises(ValueError, match="reorder"):
        TG.apply_locality_order(np.asarray([[0, 1]]), np.zeros((2, 1)),
                                method="random")
    assert TG.cluster_min_pair_for(False) == 256
    assert TG.cluster_min_pair_for(True) == 128

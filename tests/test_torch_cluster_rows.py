"""The cluster kernels' row plan (``kernels.cluster.ClusterRows``) against a
numpy oracle of the per-launch ranking it replaces, on the CPU (no JAX).

The attention forward kernel still stages each 256-row receiver block's
edges 2,048 at a time and ranks them by row in arrival order
(``rank_by_row`` in ``csrc/cluster.cu``); the aggregation and the
attention backward read the row plan instead, built once per graph.  The
plan must give every row the edges the ranking gives it, in the same
order, so that a row sums its edges in the order it did.  Also: the
reverse-slot involution, the builder on tensors (the wrappers' path when
no plan is passed), and the plain versions with and without a plan.
"""

import zlib

import numpy as np
import pytest
import torch

from hyperspace_torch.kernels import cluster as TC

BN, CAP = 256, 2048


def ranked_rows(recv: np.ndarray, n: int) -> list:
    """Each row's arrival indices in the order the attention forward's
    ranking puts them: receiver block by receiver block, 2,048 edges a
    chunk, a stable counting sort by row within each chunk."""
    rows = [[] for _ in range(n)]
    blocks = recv // BN
    for b in np.unique(blocks):
        idx = np.flatnonzero(blocks == b)
        for c in range(0, len(idx), CAP):
            chunk = idx[c:c + CAP]
            for r in range(b * BN, min((b + 1) * BN, n)):
                rows[r].extend(chunk[recv[chunk] == r].tolist())
    return rows


def by_pair(r, s, n):
    """Edges sorted by (receiver block, sender block), stable: the order
    the cluster split leaves them in."""
    key = (r // BN).astype(np.int64) * (n // BN + 1) + s // BN
    o = np.argsort(key, kind="stable")
    return r[o].astype(np.int32), s[o].astype(np.int32)


def closed(rng, n, e_half, lo=0, hi=None):
    """A reversal-closed edge multiset (with repeats and self-loops),
    sorted by pair."""
    u = rng.integers(lo, n if hi is None else hi, e_half)
    v = rng.integers(0, n, e_half)
    return by_pair(np.concatenate([u, v]), np.concatenate([v, u]), n)


def edge_case(kind):
    """(receivers, senders, n) of a case, reversal-closed."""
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    if kind == "random":
        return (*closed(rng, 700, 2000), 700)
    if kind == "empty_rows":          # most rows have no edge
        return (*closed(rng, 1500, 300, 512, 768), 1500)
    if kind == "n_not_256":           # the last block is a partial one
        return (*closed(rng, 1001, 3000), 1001)
    if kind == "no_edges":
        z = np.zeros(0, np.int32)
        return z, z, 300
    if kind == "full_block":          # a receiver block over 2,048 edges
        return (*closed(rng, 600, 3000, 0, 256), 600)
    if kind == "hub":                 # one row of 5,000 edges
        r, s = closed(rng, 900, 5000, 300, 301)
        return r, s, 900
    if kind == "one_row":
        return (*closed(rng, 1, 5), 1)
    raise ValueError(kind)


KINDS = ["random", "empty_rows", "n_not_256", "no_edges", "full_block",
         "hub", "one_row"]


@pytest.mark.parametrize("kind", KINDS)
def test_rows_match_the_ranking(kind):
    r, s, n = edge_case(kind)
    rows = TC.build_cluster_rows(r, s, n, with_rev=True)
    e = len(r)
    assert all(a.dtype == np.int32 for a in rows)
    assert rows.row_ptr.shape == (n + 1,) and rows.row_ptr[0] == 0
    assert rows.row_ptr[-1] == e
    # every edge exactly once, rows ascending
    np.testing.assert_array_equal(np.sort(rows.perm), np.arange(e))
    np.testing.assert_array_equal(rows.recv, r[rows.perm])
    np.testing.assert_array_equal(rows.send, s[rows.perm])
    assert np.all(np.diff(rows.recv) >= 0)
    np.testing.assert_array_equal(np.diff(rows.row_ptr),
                                  np.bincount(r, minlength=n))
    # each row's edges in arrival order, as the ranking gives them
    want = ranked_rows(r, n)
    for i in range(n):
        got = rows.perm[rows.row_ptr[i]:rows.row_ptr[i + 1]]
        assert got.tolist() == want[i], i
    if kind == "hub":
        assert np.diff(rows.row_ptr).max() >= 5000
    if kind == "full_block":
        assert np.sum(r < BN) > CAP
    if kind == "empty_rows":
        assert np.sum(np.diff(rows.row_ptr) == 0) > n // 2


@pytest.mark.parametrize("kind", KINDS)
def test_reverse_slots_are_an_involution(kind):
    r, s, n = edge_case(kind)
    rows = TC.build_cluster_rows(r, s, n, with_rev=True)
    rev = rows.rev
    assert rev.dtype == np.int32 and rev.shape == r.shape
    np.testing.assert_array_equal(rev[rev], np.arange(len(r)))
    np.testing.assert_array_equal(rows.recv[rev], rows.send)
    np.testing.assert_array_equal(rows.send[rev], rows.recv)


def test_rows_without_reverse_slots():
    r, s, n = edge_case("random")
    assert TC.build_cluster_rows(r, s, n).rev is None


def test_rows_refuse_an_open_edge_set_and_bad_ids():
    r = np.array([0, 1, 1], np.int32)
    s = np.array([1, 0, 2], np.int32)            # (2, 1) is missing
    TC.build_cluster_rows(r, s, 3)               # fine without reversal
    with pytest.raises(ValueError, match="closed under reversal"):
        TC.build_cluster_rows(r, s, 3, with_rev=True)
    with pytest.raises(ValueError, match="outside"):
        TC.build_cluster_rows(r, s, 2)
    with pytest.raises(ValueError, match="want"):
        TC.build_cluster_rows(r, s[:2], 3)
    with pytest.raises(ValueError, match="closed under reversal"):
        TC.cluster_rows_on_device(torch.as_tensor(r), torch.as_tensor(s), 3,
                                  with_rev=True)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_rev", [False, True])
def test_device_builder_equals_the_host_builder(kind, with_rev):
    """The builder the wrappers use when no plan is passed (torch's
    stable sorts, here on CPU tensors) gives the host plan, and counts
    its builds."""
    r, s, n = edge_case(kind)
    want = TC.build_cluster_rows(r, s, n, with_rev=with_rev)
    before = TC.row_plan_builds
    got = TC.cluster_rows_on_device(torch.as_tensor(r), torch.as_tensor(s),
                                    n, with_rev=with_rev)
    assert TC.row_plan_builds == before + 1
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), b)
    moved = TC.rows_on(want, "cpu")
    for a, b in zip(moved, want):
        assert (a is None) == (b is None)
        if b is not None:
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_plain_paths_with_the_plan_equal_those_without(kind, dt):
    r, s, n = edge_case(kind)
    rng = np.random.default_rng(7)
    f = 12
    rows = TC.rows_on(TC.build_cluster_rows(r, s, n, with_rev=True), "cpu")
    h = torch.as_tensor(rng.standard_normal((n, f)), dtype=dt)
    w = torch.as_tensor(rng.random(len(r)), dtype=torch.float32)
    rt, st = torch.as_tensor(r), torch.as_tensor(s)
    before = (TC.cluster_aggregate.launches, TC.cluster_att_bwd.launches,
              TC.row_plan_builds)
    assert torch.equal(TC.cluster_aggregate(h, w, rt, st, None, n, rows=rows),
                       TC.cluster_aggregate(h, w, rt, st, None, n))
    g = torch.as_tensor(rng.standard_normal((n, f + 1)), dtype=torch.float32)
    a_s = torch.as_tensor(rng.standard_normal(n) * 0.7, dtype=torch.float32)
    a_r = torch.as_tensor(rng.standard_normal(n) * 0.7, dtype=torch.float32)
    got = TC.cluster_att_bwd(g, h, a_s, a_r, rt, st, None, n, rows=rows)
    want = TC.cluster_att_bwd(g, h, a_s, a_r, rt, st, None, n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the CPU path launches nothing and builds no plan
    assert (TC.cluster_aggregate.launches, TC.cluster_att_bwd.launches,
            TC.row_plan_builds) == before


def test_wrappers_refuse_a_plan_of_other_edges():
    r, s, n = edge_case("random")
    rows = TC.rows_on(TC.build_cluster_rows(r, s, n), "cpu")
    h = torch.zeros((n, 4))
    w = torch.zeros(len(r))
    rt, st = torch.as_tensor(r), torch.as_tensor(s)
    with pytest.raises(ValueError, match="row plan"):
        TC.cluster_aggregate(h, w[:-2], rt[:-2], st[:-2], None, n, rows=rows)
    with pytest.raises(ValueError, match="row plan"):
        TC.cluster_aggregate(h[:-1], w, rt, st, None, n - 1, rows=rows)
    g = torch.zeros((n, 5))
    a = torch.zeros(n)
    with pytest.raises(ValueError, match="reverse slots"):
        TC.cluster_att_bwd(g, h, a, a, rt, st, None, n, rows=rows)


@pytest.mark.parametrize("min_pair,rev", [(8, True), (64, True), (8, False)])
def test_the_split_carries_the_plan_of_its_clustered_edges(min_pair, rev):
    """``build_cluster_split`` builds the clustered edges' row plan (with
    reverse slots when given the graph's involution), and ``ClusterAgg``
    moves it and the edges in its order to the device."""
    from hyperspace_torch.data import graphs as TG
    from hyperspace_torch.nn.scatter import ClusterAgg

    rng = np.random.default_rng(min_pair)
    n = 900
    edges = np.stack([rng.integers(0, n, 6000),
                      (rng.integers(0, n, 6000) // 3) * 3], 1)
    g = TG.prepare(edges, n, np.zeros((n, 2), np.float32), cluster=False,
                   pad_multiple=256)
    split = TC.build_cluster_split(g.senders, g.receivers, g.edge_mask,
                                   g.deg, n, min_pair_edges=min_pair,
                                   rev_perm=g.rev_perm if rev else None)
    assert len(split.c_recv) > 0
    want = TC.build_cluster_rows(split.c_recv, split.c_send, n,
                                 with_rev=rev)
    for a, b in zip(split.c_rows, want):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b)
    # on the device the clustered edges and weights are in row order, so
    # the plan needs no permutation
    agg = ClusterAgg.from_host(split, "cpu")
    assert agg.c_rows.perm is None
    for a, b in zip(agg.c_rows, want._replace(perm=None)):
        assert (a is None) == (b is None)
        if b is not None:
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(agg.c_recv.numpy(), want.recv)
    np.testing.assert_array_equal(agg.c_send.numpy(), want.send)
    np.testing.assert_array_equal(agg.c_wf.numpy(), split.c_wf[want.perm])
    np.testing.assert_array_equal(agg.c_wb.numpy(), split.c_wb[want.perm])

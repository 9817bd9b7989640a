"""The cluster kernels' row plan (``kernels.cluster.ClusterRows``) and the
row walk that reads it, on the CPU (no JAX).

The three kernels of ``csrc/cluster.cu`` read a row plan built once per
graph: every row gets its edges in arrival order, the order in which the
plain versions (``index_add_``) sum them.  ``ranked_rows`` is an oracle
of that order as a per-block ranking gives it: receiver block by
receiver block, 2,048 edges a chunk, a stable counting sort by row.
Also: the reverse-slot involution, the builder on tensors (the wrappers'
path when no plan is passed), the plain paths with and without a plan,
and a numpy model of the walk ``agg_rows_kernel`` makes in its attention
mode (units of whole rows from ``unit_span``, D slots a step, a row
written when its last slot is summed, empty rows written as 0), held
bitwise against ``cluster_att_fwd_plain``.
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
    before = (TC.cluster_aggregate.launches, TC.cluster_att_fwd.launches,
              TC.cluster_att_bwd.launches, TC.row_plan_builds)
    assert torch.equal(TC.cluster_aggregate(h, w, rt, st, None, n, rows=rows),
                       TC.cluster_aggregate(h, w, rt, st, None, n))
    g = torch.as_tensor(rng.standard_normal((n, f + 1)), dtype=torch.float32)
    a_s = torch.as_tensor(rng.standard_normal(n) * 0.7, dtype=torch.float32)
    a_r = torch.as_tensor(rng.standard_normal(n) * 0.7, dtype=torch.float32)
    assert torch.equal(
        TC.cluster_att_fwd(h, a_s, a_r, rt, st, None, n, rows=rows),
        TC.cluster_att_fwd(h, a_s, a_r, rt, st, None, n))
    got = TC.cluster_att_bwd(g, h, a_s, a_r, rt, st, None, n, rows=rows)
    want = TC.cluster_att_bwd(g, h, a_s, a_r, rt, st, None, n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the CPU path launches nothing and builds no plan
    assert (TC.cluster_aggregate.launches, TC.cluster_att_fwd.launches,
            TC.cluster_att_bwd.launches, TC.row_plan_builds) == before


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
    with pytest.raises(ValueError, match="row plan"):
        TC.cluster_att_fwd(h, a, a, rt[:-2], st[:-2], None, n, rows=rows)
    with pytest.raises(ValueError, match="row plan"):
        TC.cluster_att_fwd(h[:-1], a[:-1], a[:-1], rt, st, None, n - 1,
                           rows=rows)
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


# --- the attention forward's row walk, modelled in numpy --------------------

ROW_DEPTH = 4     # csrc/cluster.cu ROW_DEPTH: slots a group reads a step


def unit_span(u, units, e, n, recv, row_ptr):
    """csrc/cluster.cu ``unit_span``: the rows [r_lo, r_hi) of unit u and
    their slots [j0, j1)."""
    b0, b1 = u * e // units, (u + 1) * e // units
    r_lo = 0 if b0 == 0 else int(recv[b0 - 1]) + 1
    r_hi = n if u + 1 == units else (0 if b1 == 0 else int(recv[b1 - 1]) + 1)
    return r_lo, r_hi, int(row_ptr[r_lo]), int(row_ptr[r_hi])


def fwd_walk(h, w_slot, rows, n, units):
    """``agg_rows_kernel``'s attention mode over ``units`` units: each
    slot's weight w_slot (in slot order) times its sender's row, summed
    with the weights (den) in slot order, a product rounded, then
    added, as the plain version's ``index_add_`` adds them.  Returns
    [n, f + 1] float32 and how often each row was written."""
    f = h.shape[1]
    recv, send, row_ptr = rows.recv, rows.send, rows.row_ptr
    e = len(recv)
    out = np.full((n, f + 1), np.nan, np.float32)
    written = np.zeros(n, np.int64)
    zero = np.zeros(f, np.float32)

    def put(r, acc, den):
        out[r, :f], out[r, f] = acc, den
        written[r] += 1

    for u in range(units):
        r_lo, r_hi, j, j1 = unit_span(u, units, e, n, recv, row_ptr)
        for r in range(r_lo, int(recv[j]) if j < j1 else r_hi):
            put(r, zero, np.float32(0))
        acc, den = zero.copy(), np.float32(0)
        while j < j1:
            rs = [int(recv[j + d]) if j + d < j1 else r_hi
                  for d in range(ROW_DEPTH)]
            after = int(recv[j + ROW_DEPTH]) if j + ROW_DEPTH < j1 else r_hi
            for d in range(ROW_DEPTH):
                if rs[d] >= r_hi:
                    continue
                wd = w_slot[j + d]
                acc = acc + wd * h[send[j + d]]
                den = np.float32(den + wd)
                nxt = rs[d + 1] if d + 1 < ROW_DEPTH else after
                if nxt != rs[d]:            # row rs[d] ends here
                    put(rs[d], acc, den)
                    acc, den = zero.copy(), np.float32(0)
                    for r in range(rs[d] + 1, nxt):
                        put(r, zero, np.float32(0))
            j += ROW_DEPTH
    return out, written


def inner_rows_case():
    """Edges among rows [100, 400) of 600: empty rows at both ends."""
    rng = np.random.default_rng(3)
    r = rng.integers(100, 400, 2500)
    s = rng.integers(100, 400, 2500)
    return (*by_pair(r, s, 600), 600)


@pytest.mark.parametrize("kind", KINDS + ["inner"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_forward_walk_equals_plain(kind, dt):
    r, s, n = inner_rows_case() if kind == "inner" else edge_case(kind)
    rng = np.random.default_rng(zlib.crc32(f"walk{kind}".encode()))
    f = 5
    rows = TC.build_cluster_rows(r, s, n)
    h = torch.as_tensor(rng.standard_normal((n, f)), dtype=dt)
    a_s = torch.as_tensor(rng.standard_normal(n) * 0.7, dtype=torch.float32)
    a_r = torch.as_tensor(rng.standard_normal(n) * 0.7, dtype=torch.float32)
    rt, st = torch.as_tensor(r).long(), torch.as_tensor(s).long()
    want = TC.cluster_att_fwd_plain(h, a_s, a_r, rt, st, n).numpy()
    # the weights as the plain version computes them (arrival order),
    # then in slot order
    w, _ = TC.att_squash(a_s[st] + a_r[rt], 30.0, 0.2)
    if dt == torch.bfloat16:
        w = w.to(torch.bfloat16).float()
    w_slot = w.numpy()[rows.perm]
    hf = h.float().numpy()
    e = len(r)
    for units in sorted({1, 3, 8, 64, e + 3}):
        got, written = fwd_walk(hf, w_slot, rows, n, units)
        assert np.all(written == 1), units
        np.testing.assert_array_equal(got, want)
    if kind == "inner":
        deg = np.diff(rows.row_ptr)
        assert deg[:100].sum() == 0 and deg[400:].sum() == 0
        assert np.all(want[:100] == 0) and np.all(want[400:] == 0)

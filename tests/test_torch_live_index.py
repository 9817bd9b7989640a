"""The port's live index (``serve/delta.py``) against the JAX package's.

One scripted sequence runs on JAX's ``LiveQueryEngine`` and on the
port's over the same table (numpy, from a seed): inserts at the tail, an
update, a batch with a repeated id (last write wins), deletes, queries
by fresh and by appended ids, k up to under-fill, a compaction, queries
again.  Exact and IVF bases (JAX's index, nprobe 4 of 16 cells), on the
ball and on the hyperboloid.  Held equal: ids, every mutation's and the
compaction's return dict (so ``generation`` and the compacted base's
fingerprint), and the under-filled ``ValueError`` in the same cases;
distances at the serving tier (rtol 1e-5, atol 1e-4: the two sum in
another order).  Query batches are of four ids and ``exclude_self``: at
d = 0 the Gram form's rounding noise differs between the two.

Port-only: a fused base is refused with JAX's message; the background
compaction at ``compact_at``; and the stdin loop's ``upsert`` and
``delete`` lines under ``live=1`` answer JAX's CLI's lines.
"""

import dataclasses
import io
import json

import numpy as np
import pytest

from hyperspace_tpu.cli import serve as jcli
from hyperspace_tpu.parallel.host_table import HostEmbedTable as JTable
from hyperspace_tpu.serve import artifact as jart
from hyperspace_tpu.serve import index as jidx
from hyperspace_tpu.serve.delta import LiveQueryEngine as JLive
from hyperspace_tpu.serve.engine import QueryEngine as JEngine
from hyperspace_torch.cli import serve as tcli
from hyperspace_torch.parallel.host_table import HostEmbedTable as TTable
from hyperspace_torch.serve import index as tidx
from hyperspace_torch.serve.delta import LiveQueryEngine as TLive
from hyperspace_torch.serve.engine import QueryEngine as TEngine
from tests.test_torch_serve import C, make_table

RTOL, ATOL = 1e-5, 1e-4
CAP = 8
IVF_ROWS, EXACT_ROWS = 2100, 64


def _near(table: np.ndarray, ids, manifold: str, seed: int) -> np.ndarray:
    """Rows near ``table[ids]``: a tangent nudge of 0.05 on the ball,
    lifted again on the hyperboloid (far above the Gram form's noise)."""
    import torch

    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.manifolds.maps import ball_to_lorentz, \
        lorentz_to_ball

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(table[ids], dtype=torch.float64)
    ball = PoincareBall(C)
    if manifold == "lorentz":
        x = lorentz_to_ball(x, C)
    v = torch.as_tensor(rng.standard_normal(x.shape) * 0.05)
    y = ball.expmap(x, v)
    if manifold == "lorentz":
        y = ball_to_lorentz(y, C)
    return y.to(torch.float32).numpy()


@pytest.fixture(scope="module", params=[
    ("poincare", "exact"), ("lorentz", "exact"),
    ("poincare", "ivf"), ("lorentz", "ivf")],
    ids=lambda p: "-".join(p))
def case(request):
    manifold, base = request.param
    n = IVF_ROWS if base == "ivf" else EXACT_ROWS
    table = make_table(manifold, n, seed=31)
    spec = (manifold, C)
    kw = {}
    if base == "ivf":
        index = jidx.build_index(table, spec, 16, iters=3, seed=1)
        kw = {"jidx": index, "tidx": tidx.ServingIndex(
            **dataclasses.asdict(index)), "nprobe": 4}
    return manifold, base, table, spec, kw


def _engines(case):
    manifold, base, table, spec, kw = case
    jb = JEngine(table, spec, index=kw.get("jidx"),
                 nprobe=kw.get("nprobe", 0))
    tb = TEngine(table, spec, index=kw.get("tidx"),
                 nprobe=kw.get("nprobe", 0), device="cpu")
    j = JLive(jb, JTable.from_array(table.copy()), capacity=CAP,
              auto_compact=False)
    t = TLive(tb, TTable.from_array(table.copy()), capacity=CAP,
              auto_compact=False)
    return j, t


def _same(got, want) -> None:
    ti, td = (np.asarray(x) for x in got)
    ji, jd = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)


def _both(j, t, fn):
    """``fn(engine)`` on both; equal results, or the same error."""
    out = []
    for eng in (j, t):
        try:
            out.append(("ok", fn(eng)))
        except ValueError as e:
            out.append(("error", str(e).split(":")[0]))
    (jk, jv), (tk, tv) = out
    assert tk == jk, (jv, tv)
    if jk == "error":
        assert tv == jv
    return jv, tv


def test_scripted_sequence_matches_jax(case):
    manifold, base, table, _spec, _kw = case
    n = table.shape[0]
    j, t = _engines(case)

    def query(ids, k):
        jv, tv = _both(j, t, lambda e: e.topk_neighbors(
            np.asarray(ids, np.int64), k))
        if not isinstance(jv, str):
            _same(tv, jv)

    def mutate(fn):
        jv, tv = _both(j, t, fn)
        assert tv == jv
        assert t.generation == j.generation
        assert t.segment_rows == j.segment_rows
        return tv

    query([0, 5, 17, 40], 5)
    # three inserts near rows 3, 9, 21 and an update of row 5
    new = _near(table, [3, 9, 21], manifold, seed=1)
    upd = _near(table, [5], manifold, seed=2)
    rows = np.concatenate([new, upd])
    out = mutate(lambda e: e.upsert([n, n + 1, n + 2, 5], rows))
    assert out["inserted"] == 3 and out["upserted"] == 4
    query([3, 9, n, n + 1], 5)                 # planted rows rank first
    query([5, n + 2, 21, 0], 6)
    # a repeated id: the last write wins; a re-upsert inserts nothing
    again = _near(table, [5, 5, 9], manifold, seed=3)
    out = mutate(lambda e: e.upsert([5, n + 1, 5], again))
    assert out["inserted"] == 0 and out["upserted"] == 2
    query([5, n + 1, 1, 2], 5)
    mutate(lambda e: e.delete([9, n + 2, 4]))
    query([3, 21, n, 5], 5)                    # never a deleted id
    _both(j, t, lambda e: e.topk_neighbors(np.asarray([9, 1, 2, 3]), 5))
    mutate(lambda e: e.upsert([n + 3], _near(table, [0], manifold, 4)))
    # bad mutations: a gap in the new ids, a width, a deleted id
    _both(j, t, lambda e: e.upsert([n + 9], new[:1]))
    _both(j, t, lambda e: e.upsert([1], rows[:1, :3]))
    _both(j, t, lambda e: e.delete([9]))
    # k up to under-fill
    live = n + 4 - 3
    outcomes = []
    for k in ((40, 64, 66) if base == "exact" else (200, 1200, 5000)):
        jv, tv = _both(j, t, lambda e, k=k: e.topk_neighbors(
            np.asarray([0, 5, n, 1], np.int64), k))
        outcomes.append(jv if isinstance(jv, str) else "ok")
        if not isinstance(jv, str):
            _same(tv, jv)
    assert t.num_live == j.num_live == live
    # exact: the 66th row is a tombstone; IVF: 1,200 > the probe's
    # 1,052 slots + 8, and 5,000 > the table
    assert [o[:22] for o in outcomes] == (
        ["ok", "ok", "live top-k under-fille"] if base == "exact" else
        ["ok", "live top-k under-fille", "k=5000 out of range [1"])
    # the compaction folds the delta into a rebuilt base
    got = mutate(lambda e: e.compact())
    assert got["segment_rows"] == 0
    np.testing.assert_array_equal(t.master.to_array(), j.master.to_array())
    query([3, 21, n, n + 3], 5)
    query([5, 0, 1, 2], 7)
    _both(j, t, lambda e: e.topk_neighbors(np.asarray([n + 2, 1, 2, 3]), 5))
    # a deleted id revives by upsert, after the compaction too
    mutate(lambda e: e.upsert([9], _near(table, [9], manifold, 5)))
    query([9, 3, 21, n], 5)


def test_score_edges_read_fresh_rows(case):
    manifold, _base, table, _spec, _kw = case
    j, t = _engines(case)
    rows = _near(table, [2, 7], manifold, seed=6)
    for e in (j, t):
        e.upsert([2, 7], rows)
    u, v = np.asarray([2, 7, 1]), np.asarray([7, 3, 2])
    for prob in (False, True):
        np.testing.assert_allclose(
            np.asarray(t.score_edges(u, v, prob=prob)),
            np.asarray(j.score_edges(u, v, prob=prob)),
            rtol=RTOL, atol=ATOL)


def test_fused_base_is_refused_and_stats_carry_generation():
    table = make_table("poincare", EXACT_ROWS, seed=3)
    base = TEngine(table, ("poincare", C), scan_mode="fused", device="cpu")
    jbase = JEngine(table, ("poincare", C), scan_mode="fused")
    with pytest.raises(ValueError) as te:
        TLive(base, TTable.from_array(table.copy()))
    with pytest.raises(ValueError) as je:
        JLive(jbase, JTable.from_array(table.copy()))
    assert str(te.value) == str(je.value)
    from hyperspace_torch.serve.batcher import RequestBatcher

    live = TLive(TEngine(table, ("poincare", C), device="cpu"),
                 TTable.from_array(table.copy()), capacity=CAP)
    b = RequestBatcher(live, min_bucket=4, max_bucket=8, cache_size=64)
    nb, _ = b.topk([1, 2], 3)
    live_row = _near(table, [1], "poincare", seed=7)
    assert b.upsert([1], live_row)["generation"] == 1
    st = b.stats()
    assert (st["generation"], st["segment_rows"]) == (1, 1)
    # the cached pre-mutation rows are unreachable: a new key
    nb2, _ = b.topk([1, 2], 3)
    assert b.stats()["cache_miss"] >= 4
    with pytest.raises(ValueError, match="frozen"):
        RequestBatcher(TEngine(table, ("poincare", C), device="cpu")
                       ).upsert([1], live_row)


def test_background_compaction_at_compact_at():
    """Six upserts into an eight-row segment at ``compact_at`` 0.75 start
    one compaction thread; after it every slot the snapshot covered is
    free and the answers are a fresh frozen engine's over the master."""
    table = make_table("poincare", EXACT_ROWS, seed=8)
    live = TLive(TEngine(table, ("poincare", C), device="cpu"),
                 TTable.from_array(table.copy()), capacity=CAP,
                 compact_at=0.75)
    n = table.shape[0]
    for i in range(6):
        live.upsert([n + i], _near(table, [i], "poincare", seed=10 + i))
    assert live.join_compaction(60)
    assert live.segment_rows == 0 and live.generation == 7
    fresh = TEngine(live.master.to_array(), ("poincare", C), device="cpu")
    assert live.fingerprint == fresh.fingerprint
    ids = np.asarray([0, n, n + 5, 7])
    got, want = live.topk_neighbors(ids, 5), fresh.topk_neighbors(ids, 5)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


def test_stdin_loop_live_ops_match_jax_cli(tmp_path):
    table = make_table("poincare", EXACT_ROWS, seed=12)
    art = str(tmp_path / "a")
    jart.export_artifact(art, table, ("poincare", C))
    n = table.shape[0]
    near = _near(table, [2, 4], "poincare", seed=13).tolist()
    lines = [
        {"op": "upsert", "ids": [n, 3], "rows": near},
        {"op": "topk", "ids": [2, n, 5, 6], "k": 4},
        {"op": "upsert", "ids": [n + 5], "rows": [near[0]]},
        {"op": "delete", "ids": [6, n]},
        {"op": "topk", "ids": [6], "k": 4},
        {"op": "topk", "ids": [2, 3, 5, 7], "k": 4},
        {"op": "delete", "ids": "x"},
        {"op": "stats"},
    ]
    text = "\n".join(json.dumps(x) for x in lines) + "\n"
    outs = []
    for cli, extra in ((jcli, {}), (tcli, {"device": "cpu"})):
        buf = io.StringIO()
        cfg = cli.ServeConfig(artifact=art, live=True, delta_cap=16,
                              window_s=0.0, **extra)
        cli.run_serve(cfg, stdin=io.StringIO(text), stdout=buf)
        outs.append([json.loads(x) for x in buf.getvalue().splitlines()])
    jo, to = outs
    assert len(to) == len(jo) == len(lines)
    for i in (0, 2, 3):
        assert to[i] == jo[i]
    for i in (1, 5):
        _same((to[i]["neighbors"], to[i]["dists"]),
              (jo[i]["neighbors"], jo[i]["dists"]))
    for i in (4, 6):
        assert to[i]["error"]["kind"] == jo[i]["error"]["kind"]
    for key in ("generation", "segment_rows", "scan_mode"):
        assert to[7][key] == jo[7][key]


def test_upserts_interleaved_with_queries_answer_their_generation():
    """One thread upserts (an update and an insert a batch) while another
    queries, the switch interval shortened; each answer equals, bitwise,
    a sequential replay's at a generation between the query's two
    readings of ``generation`` (the card's twin is in
    ``tests/test_torch_cuda.py``)."""
    import sys
    import threading

    table = make_table("poincare", 300, seed=14)
    rng = np.random.default_rng(15)
    batches = [([int(rng.integers(0, 300)), 300 + g],
                _near(table, [g, g + 1], "poincare", seed=100 + g))
               for g in range(30)]
    q = np.asarray([0, 11, 222, 299, 7], np.int64)

    def fresh():
        return TLive(TEngine(table, ("poincare", C), device="cpu"),
                     TTable.from_array(table.copy()), capacity=64,
                     auto_compact=False)

    def ask(eng):
        i, d = eng.topk_neighbors(q, 5)
        return i.numpy(), d.numpy()

    eng = fresh()
    ref = {0: ask(eng)}
    for g, (ids, rows) in enumerate(batches, 1):
        eng.upsert(ids, rows)
        ref[g] = ask(eng)
    live, seen, done = fresh(), [], threading.Event()

    def writer():
        for ids, rows in batches:
            live.upsert(ids, rows)
        done.set()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=writer)
        t.start()
        while not done.is_set() or len(seen) < 5:
            g0 = live.generation
            ans = ask(live)
            seen.append((g0, live.generation, ans))
        t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive()
    for g0, g1, (i, d) in seen:
        assert any(np.array_equal(ref[g][0], i)
                   and np.array_equal(ref[g][1], d)
                   for g in range(g0, g1 + 1)), (g0, g1)

"""The port's serving path against the JAX package, on the CPU: the
artifact format both ways, ``QueryEngine`` top-k and edge scores in both
scan modes on both geometries, and the batcher.

Tolerances: float32 distances rtol 1e-5, atol 1e-4 (the sides sum the
Gram products in different orders); ids equal outside runs of
near-ties, id sets equal inside them; Fermi–Dirac scores atol 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

from hyperspace_tpu.serve import artifact as jart
from hyperspace_tpu.serve.engine import QueryEngine as JaxEngine
from hyperspace_torch.kernels._support import topk_disagreements
from hyperspace_torch.manifolds import Lorentz, PoincareBall
from hyperspace_torch.manifolds.maps import ball_to_lorentz, lorentz_to_ball
from hyperspace_torch.serve import artifact as tart
from hyperspace_torch.serve.batcher import (RequestBatcher, bucket_for,
                                            bucket_sizes)
from hyperspace_torch.serve.engine import QueryEngine, auto_chunk_rows
from hyperspace_torch.telemetry import registry as telem
from tests.test_torch_kernels import u_bound

RTOL, ATOL = 1e-5, 1e-4
C = 0.9
N = 3000


def make_table(manifold: str, n: int = N, seed: int = 0) -> np.ndarray:
    """``expmap0`` of scaled Gaussian tangents (10-dim ball), lifted to
    the hyperboloid for ``lorentz``; float32."""
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.standard_normal((n, 10)) * 0.5,
                        dtype=torch.float64)
    x = PoincareBall(C).expmap0(v)
    if manifold == "lorentz":
        x = ball_to_lorentz(x, C)
    return x.to(torch.float32).numpy()


@pytest.fixture(scope="module")
def tables():
    return {m: make_table(m) for m in ("poincare", "lorentz")}


def self_noise(x: np.ndarray, manifold: str) -> np.ndarray:
    """Largest float32 distance the Gram form can return for d(x, x):
    the arcosh of twice its forward-error bound on u (tests of the
    kernel modules derive the bound)."""
    x = x.astype(np.float64)
    ub = np.diag(u_bound(x, x, C, manifold, 2.0 ** -24, 0.0))
    u = 2.0 * ub
    return np.log1p(u + np.sqrt(u * (u + 2.0))) / np.sqrt(C)


# --- manifolds ----------------------------------------------------------------


def test_lorentz_expmap0_and_maps_match_jax():
    from hyperspace_tpu.manifolds import Lorentz as JL, PoincareBall as JP
    from hyperspace_tpu.manifolds import maps as jmaps
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    v = rng.standard_normal((20, 11)) * 0.7
    v[:, 0] = 0.0
    got = Lorentz(C).expmap0(torch.from_numpy(v)).numpy()
    want = np.asarray(JL(C).expmap0(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    y = PoincareBall(C).expmap0(torch.from_numpy(v[:, 1:])).numpy()
    np.testing.assert_allclose(y, np.asarray(JP(C).expmap0(
        jnp.asarray(v[:, 1:]))), rtol=1e-12, atol=1e-12)
    lift = ball_to_lorentz(torch.from_numpy(y), C).numpy()
    np.testing.assert_allclose(lift, np.asarray(jmaps.ball_to_lorentz(
        jnp.asarray(y), C)), rtol=1e-12)
    np.testing.assert_allclose(
        lorentz_to_ball(torch.from_numpy(lift), C).numpy(), y, atol=1e-12)


# --- artifacts ----------------------------------------------------------------


@pytest.mark.parametrize("manifold", ["poincare", "lorentz"])
def test_artifact_jax_export_port_load(tmp_path, tables, manifold):
    table, spec = tables[manifold], (manifold, C)
    jart.export_artifact(str(tmp_path / "a"), table, spec,
                         model_config={"dim": 10}, step=7)
    art = tart.load_artifact(str(tmp_path / "a"))
    np.testing.assert_array_equal(art.table, table)
    assert art.table.dtype == table.dtype
    assert art.manifold_spec == spec and art.step == 7
    assert art.model_config == {"dim": 10}
    assert art.fingerprint == jart.fingerprint_of(table, spec)
    assert tart.fingerprint_of(table, spec) == jart.fingerprint_of(table, spec)


@pytest.mark.parametrize("manifold", ["poincare", "lorentz"])
def test_artifact_port_export_jax_load(tmp_path, tables, manifold):
    table, spec = tables[manifold], (manifold, C)
    out = tart.export_artifact(str(tmp_path / "a"), table, spec, step=3)
    art = jart.load_artifact(str(tmp_path / "a"))
    np.testing.assert_array_equal(np.asarray(art.table), table)
    assert art.manifold_spec == spec and art.step == 3
    assert art.fingerprint == out.fingerprint
    # a staging directory never survives a commit
    assert sorted(os.listdir(tmp_path)) == ["a"]


def test_artifact_overwrite_and_refusals(tmp_path, tables):
    table = tables["poincare"]
    path = str(tmp_path / "a")
    tart.export_artifact(path, table, ("poincare", C))
    with pytest.raises(FileExistsError):
        tart.export_artifact(path, table, ("poincare", C))
    tart.export_artifact(path, table[:10], ("poincare", C), overwrite=True)
    assert tart.load_artifact(path).num_nodes == 10
    with pytest.raises(FileNotFoundError):
        tart.load_artifact(str(tmp_path / "missing"))
    meta_path = os.path.join(path, tart.META_FILE)
    with open(meta_path) as f:
        meta = json.load(f)
    with open(meta_path, "w") as f:
        json.dump({**meta, "fingerprint": "0" * 64}, f)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        tart.load_artifact(path)
    # an artifact with an IVF index loads; a meta block naming an index
    # whose file is missing does not
    from hyperspace_torch.serve.index import build_index

    index = build_index(table, ("poincare", C), 8, iters=2, device="cpu")
    art = tart.export_artifact(path, table, ("poincare", C), index=index,
                               overwrite=True)
    got = tart.load_artifact(path)
    assert got.fingerprint == art.fingerprint and got.index.ncells == 8
    os.remove(os.path.join(path, tart.INDEX_FILE))
    with pytest.raises(ValueError, match="index.npz is missing"):
        tart.load_artifact(path)


def test_spec_json_round_trip_matches_jax():
    for spec in (("poincare", 1.0), ("lorentz", 0.8),
                 ("product", (("poincare", 5, 1.3), ("euclidean", 2, 0.0)))):
        assert tart.spec_to_json(spec) == jart.spec_to_json(spec)
        assert tart.spec_from_json(jart.spec_to_json(spec)) == spec


# --- engine -------------------------------------------------------------------


@pytest.mark.parametrize("manifold", ["poincare", "lorentz"])
@pytest.mark.parametrize("scan_mode", ["two_stage", "fused"])
@pytest.mark.parametrize("k,exclude_self", [(10, True), (7, False)])
def test_topk_matches_jax_engine(tables, manifold, scan_mode, k,
                                 exclude_self):
    table, spec = tables[manifold], (manifold, C)
    rng = np.random.default_rng(2)
    q = rng.choice(N, 40, replace=False).astype(np.int32)
    jeng = JaxEngine(table, spec, chunk_rows=512, scan_mode=scan_mode)
    want_i, want_d = (np.asarray(a) for a in jeng.topk_neighbors(
        q, k, exclude_self=exclude_self))
    eng = QueryEngine(table, spec, chunk_rows=512, scan_mode=scan_mode,
                      device="cpu")
    got_i, got_d = eng.topk_neighbors(q, k, exclude_self=exclude_self)
    assert got_i.shape == (40, k) and got_i.dtype == torch.int32
    got_i, got_d = got_i.numpy(), got_d.numpy()
    assert np.all(np.diff(got_d, axis=1) >= 0)
    if not exclude_self:
        # the query itself ranks first; its distance is the Gram form's
        # rounding noise at d = 0, which differs between the two sides
        assert np.all(got_i[:, 0] == q) and np.all(want_i[:, 0] == q)
        noise = self_noise(table[q], manifold)
        assert np.all(got_d[:, 0] <= noise) and np.all(want_d[:, 0] <= noise)
        got_i, got_d, want_i, want_d = (a[:, 1:] for a in (
            got_i, got_d, want_i, want_d))
    assert topk_disagreements(got_i, got_d, want_i, want_d,
                              rtol=RTOL, atol=ATOL) == 0
    if exclude_self:
        assert not np.any(got_i == q[:, None])
    assert eng.scan_signature == jeng.scan_signature


@pytest.mark.parametrize("manifold", ["poincare", "lorentz"])
def test_two_stage_matches_fused_and_large_k(tables, manifold):
    """Rank-identical scan modes; k past FUSED_MAX_K takes the two-stage
    scan in a fused engine."""
    table, spec = tables[manifold], (manifold, C)
    q = np.arange(0, N, 150)
    two = QueryEngine(table, spec, chunk_rows=256, device="cpu")
    fused = QueryEngine(table, spec, chunk_rows=256, scan_mode="fused",
                        device="cpu")
    for k in (1, 64, 300):
        a_i, a_d = two.topk_neighbors(q, k)
        b_i, b_d = fused.topk_neighbors(q, k)
        assert topk_disagreements(a_i.numpy(), a_d.numpy(), b_i.numpy(),
                                  b_d.numpy(), rtol=RTOL, atol=ATOL) == 0


@pytest.mark.parametrize("manifold", ["poincare", "lorentz"])
@pytest.mark.parametrize("prob", [False, True])
def test_score_edges_matches_jax_engine(tables, manifold, prob):
    table, spec = tables[manifold], (manifold, C)
    rng = np.random.default_rng(3)
    u = rng.integers(0, N, 64).astype(np.int32)
    v = rng.integers(0, N, 64).astype(np.int32)
    v[:4] = u[:4]                       # self pairs: distance 0
    want = np.asarray(JaxEngine(table, spec).score_edges(
        u, v, prob=prob, fd_r=1.5, fd_t=0.7))
    got = QueryEngine(table, spec, device="cpu").score_edges(
        u, v, prob=prob, fd_r=1.5, fd_t=0.7).numpy()
    if prob:
        np.testing.assert_allclose(got, want, atol=1e-6)
    else:
        np.testing.assert_allclose(got[4:], want[4:], rtol=RTOL, atol=ATOL)
        noise = self_noise(table[u[:4]], manifold)
        assert np.all(got[:4] <= noise) and np.all(want[:4] <= noise)


def test_engine_pads_table_to_chunk_multiple(tables):
    eng = QueryEngine(tables["poincare"], ("poincare", C), chunk_rows=384,
                      device="cpu")
    assert eng.table.shape == (3072, 10) and eng.num_nodes == N
    assert not torch.any(eng.table[N:])
    assert auto_chunk_rows(N) == 2048 and auto_chunk_rows(100) == 128
    assert auto_chunk_rows(10 ** 6) == 2048
    # a table narrower than k: every real row is returned, never padding
    small = QueryEngine(tables["poincare"][:5], ("poincare", C),
                        device="cpu", scan_mode="fused")
    i, d = small.topk_neighbors([0, 1], 4)
    assert np.all(np.isfinite(d.numpy())) and i.max() < 5


@pytest.mark.parametrize("kw,match", [
    (dict(scan_mode="carry"), "not ported"),
    (dict(scan_mode="bogus"), "scan_mode"),
    (dict(nprobe=4), "needs an IVF index"),
    (dict(mesh=object()), "not ported"),
    (dict(chunk_rows=-1), "chunk_rows")])
def test_engine_refuses_unported_options(tables, kw, match):
    with pytest.raises(ValueError, match=match):
        QueryEngine(tables["poincare"], ("poincare", C), device="cpu", **kw)


def test_engine_refuses_unported_specs(tables):
    """Every spec JAX's single-device engine serves is served now; an
    unknown kind, and a product spec narrower than the table, raise."""
    with pytest.raises(ValueError, match="unknown manifold spec kind"):
        QueryEngine(tables["poincare"], ("hyperbolic", 1.0), device="cpu")
    with pytest.raises(ValueError, match="product spec width"):
        QueryEngine(tables["poincare"], ("product", (
            ("poincare", 5, 1.0), ("euclidean", 4, 0.0))), device="cpu")


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
def test_engine_serves_every_lane(tables, precision):
    """The lanes these options refused before: each answers what the f32
    engine answers on a spread table, with f32 distances (the rescore
    against the master)."""
    table, spec = tables["poincare"], ("poincare", C)
    q = np.arange(0, N, 97)
    want_i, want_d = QueryEngine(table, spec, device="cpu").topk_neighbors(
        q, 10)
    for mode in ("two_stage", "fused"):
        eng = QueryEngine(table, spec, device="cpu", precision=precision,
                          scan_mode=mode)
        got_i, got_d = eng.topk_neighbors(q, 10)
        assert got_d.dtype == torch.float32
        assert topk_disagreements(got_i.numpy(), got_d.numpy(),
                                  want_i.numpy(), want_d.numpy(),
                                  rtol=1e-5, atol=1e-4) == 0


@pytest.mark.parametrize("spec", [
    ("sphere", 1.0), ("euclidean", 0.0),
    ("product", (("poincare", 5, 1.0), ("euclidean", 5, 0.0)))])
def test_engine_serves_every_spec(tables, spec):
    """The specs this test refused before: answers equal a brute force
    of the manifold's own distance in float64."""
    from hyperspace_torch.serve.artifact import manifold_from_spec

    table = tables["poincare"]
    if spec[0] == "sphere":
        table = table / np.linalg.norm(table, axis=1, keepdims=True)
    q = np.arange(0, N, 211)
    m = manifold_from_spec(spec)
    t64 = torch.as_tensor(table, dtype=torch.float64)
    d64 = m.dist(t64[q][:, None, :], t64[None, :, :])
    d64[np.arange(len(q)), q] = float("inf")
    ref_d, ref_i = torch.sort(d64, dim=1, stable=True)
    for mode in ("two_stage", "fused"):
        i, d = QueryEngine(table, spec, device="cpu",
                           scan_mode=mode).topk_neighbors(q, 10)
        assert topk_disagreements(i.numpy(), d.numpy().astype(np.float64),
                                  ref_i[:, :10].numpy(),
                                  ref_d[:, :10].numpy(), rtol=1e-5,
                                  atol=1e-4) == 0


def test_engine_validates_requests(tables):
    eng = QueryEngine(tables["poincare"], ("poincare", C), device="cpu")
    for bad in ([], [N], [-1], [0.5], [[0, 1]]):
        with pytest.raises(ValueError):
            eng.topk_neighbors(np.asarray(bad), 3)
    with pytest.raises(ValueError, match="out of range"):
        eng.topk_neighbors([0], N)
    eng.topk_neighbors([0], N, exclude_self=False)
    with pytest.raises(ValueError, match="must match"):
        eng.score_edges([0, 1], [2])


# --- batcher ------------------------------------------------------------------


def test_bucket_ladder_matches_jax():
    from hyperspace_tpu.serve import batcher as jb

    for lo, hi in ((8, 1024), (1, 1), (3, 100)):
        assert bucket_sizes(lo, hi) == jb.bucket_sizes(lo, hi)
        for n in (1, 5, 64, 99, 2000):
            b = bucket_sizes(lo, hi)
            assert bucket_for(n, b) == jb.bucket_for(n, b)


def serve_counts(base: dict) -> dict:
    """The ``serve/*`` counters since the registry mark ``base``: the
    batcher's counters are process-cumulative (the telemetry registry),
    so one batcher's counts are deltas."""
    snap = telem.default_registry().snapshot(baseline=base)
    return {k[len("serve/"):]: v for k, v in snap.items()
            if k.startswith("serve/")}


def test_batcher_topk_cache_and_counters(tables):
    table, spec = tables["lorentz"], ("lorentz", C)
    eng = QueryEngine(table, spec, device="cpu", scan_mode="fused")
    bat = RequestBatcher(eng, min_bucket=4, max_bucket=16)
    base = telem.default_registry().mark()
    ids = [5, 9, 5, 3, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
           24, 25]
    idx, dist = bat.topk(ids, 6)
    ref_i, ref_d = eng.topk_neighbors(ids, 6)
    np.testing.assert_array_equal(idx, ref_i.numpy())
    np.testing.assert_array_equal(dist, ref_d.numpy())
    st = serve_counts(base)
    # 18 unique ids: one slab of 16, one of 2 padded to bucket 4
    assert (st["cache_miss"], st["cache_hit"]) == (18, 0)
    assert (st["slots"], st["padded_waste"]) == (20, 2)
    bat.topk([9, 3], 6)
    st = serve_counts(base)
    assert st["cache_hit"] == 2 and st["requests"] == 2
    assert (round(st["cache_hit"] / (st["cache_hit"] + st["cache_miss"]), 4)
            == round(2 / 20, 4))
    full = bat.stats()
    assert full["cache_entries"] == 18 and full["scan_mode"] == "fused"
    # a different k or flag is a different cache key
    bat.topk([9], 6, exclude_self=False)
    assert serve_counts(base)["cache_miss"] == 19
    for bad in ([1.5], [True], "7", [N], []):
        with pytest.raises(ValueError):
            bat.topk(bad, 3)
    with pytest.raises(ValueError, match="k must be an integer"):
        bat.topk([1], 2.0)


def test_batcher_score_pads_and_splits(tables):
    table, spec = tables["poincare"], ("poincare", C)
    eng = QueryEngine(table, spec, device="cpu")
    bat = RequestBatcher(eng, min_bucket=2, max_bucket=8)
    base = telem.default_registry().mark()
    u, v = list(range(11)), list(range(100, 111))
    got = bat.score(u, v, prob=True)
    want = eng.score_edges(u, v, prob=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert serve_counts(base)["slots"] == 8 + 4
    with pytest.raises(ValueError, match="matching"):
        bat.score([0, 1], [2])

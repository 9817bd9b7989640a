"""The port's IVF and PQ serving lanes against the JAX package, on the CPU.

Both sides get the same numpy inputs made from a seed.  The JAX side runs
its Pallas kernels in interpret mode (``HYPERSPACE_KERNELS=interpret``)
where a kernel is the reference, and its default CPU path elsewhere; the
port's wrappers run their plain PyTorch versions on CPU tensors.

Tolerances:
- ``scan_topk_cand`` / ``scan_topk_pq`` / ``pq_lut`` against the JAX
  kernels: ids equal, distances rtol 1e-6 and atol 1e-6 (float32: the
  Gram products are summed in another order);
- ``build_pq``: codes and codebooks array-equal;
- ``build_index`` on a clustered table: cells and counts equal,
  centroids rtol 1e-5 (the lifted per-cell sums may round apart);
- the engines: neighbours equal, distances rtol 1e-5 and atol 1e-4, the
  serving tests' tier: in float32 the ball's Gram form cancels for near
  neighbours (an ulp of ‖x‖² is 1e-5 of d² at d ≈ 0.5 in a tight
  cluster), and the two sides sum the Gram products in other orders.
"""

import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.kernels import scan_topk as jscan
from hyperspace_tpu.manifolds import PoincareBall as JBall
from hyperspace_tpu.serve import artifact as jart
from hyperspace_tpu.serve import index as jidx
from hyperspace_tpu.serve import quant as jquant
from hyperspace_tpu.serve.engine import QueryEngine as JaxEngine
from hyperspace_torch.cli import serve as cli
from hyperspace_torch.kernels import scan_topk
from hyperspace_torch.manifolds.maps import ball_to_lorentz
from hyperspace_torch.serve import artifact as tart
from hyperspace_torch.serve import index as tidx
from hyperspace_torch.serve import quant as tquant
from hyperspace_torch.serve.batcher import RequestBatcher
from hyperspace_torch.serve.engine import QueryEngine
from hyperspace_torch.telemetry import registry as telem
from tests.test_torch_serve import serve_counts

KTOL = dict(rtol=1e-6, atol=1e-6)
ETOL = dict(rtol=1e-5, atol=1e-4)
C = 1.3
KINDS = ["poincare", "lorentz", "euclidean"]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_KERNELS", "interpret")


def kernel_rows(rng, n, d, kind):
    """Euclidean Gaussians, or ball rows at scaled radius < 0.9 (lifted
    to the hyperboloid for lorentz), float32."""
    if kind == "euclidean":
        return rng.standard_normal((n, d)).astype(np.float32)
    v = rng.standard_normal((n, d))
    v *= rng.uniform(0.0, 0.9, (n, 1)) / np.linalg.norm(v, axis=1,
                                                       keepdims=True)
    x = (v / np.sqrt(C)).astype(np.float32)
    if kind == "lorentz":
        x = ball_to_lorentz(torch.from_numpy(x), C).numpy()
    return x


def spec_of(kind, c=C):
    return (kind, 0.0 if kind == "euclidean" else c)


def clustered(n=4096, dim=8, seed=0, ncl=512):
    """bench.py's IVF-leg generator: 512 Poincaré clusters at moderate
    radii (c = 1), float32."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, dim)) * 0.25
    vv = (centers[rng.integers(0, ncl, size=n)]
          + rng.standard_normal((n, dim)) * 0.05)
    return np.asarray(JBall(1.0).expmap0(jnp.asarray(vv, jnp.float32)))


def table_for(kind, n=4096, dim=8):
    """The clustered table in each family (lorentz: its lift; euclidean:
    the ball rows as plain vectors)."""
    t = clustered(n, dim)
    if kind == "lorentz":
        return ball_to_lorentz(torch.tensor(t), 1.0).numpy()
    return t


def assert_topk_equal(got_d, got_i, want_d, want_i, tol):
    got_d, got_i = np.asarray(got_d), np.asarray(got_i)
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(np.isinf(got_d), np.isinf(want_d))
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(got_d[fin], want_d[fin], **tol)


# --- the kernels' plain versions ----------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 10, 64])
def test_scan_topk_cand_plain_matches_jax(interpret, kind, k):
    """C = 300 (no multiple of 128), -1 pads in mid-list, exclude_self,
    and one query whose candidates are all padding."""
    rng = np.random.default_rng(1)
    table = kernel_rows(rng, 2000, 8, kind)
    q = kernel_rows(rng, 13, 8, kind)
    cand = rng.integers(0, 2000, (13, 300)).astype(np.int32)
    cand[:, 50:83] = -1
    cand[:, 299] = -1
    cand[3] = -1
    qi = cand[:, 5].copy()
    qi[3] = 7
    spec = spec_of(kind)
    wd, wi = jscan.scan_topk_cand(jnp.asarray(table), jnp.asarray(cand),
                                  jnp.asarray(q), jnp.asarray(qi), spec=spec,
                                  k=k, exclude_self=True)
    gd, gi = scan_topk.scan_topk_cand(
        torch.from_numpy(table), torch.from_numpy(cand), torch.from_numpy(q),
        torch.from_numpy(qi), spec=spec, k=k, exclude_self=True)
    assert gd.shape == gi.shape == (13, k)
    assert gd.dtype == torch.float32 and gi.dtype == torch.int32
    assert_topk_equal(gd, gi, wd, wi, KTOL)
    assert torch.all(gi[3] == -1) and torch.all(torch.isinf(gd[3]))
    assert not torch.any(gi == torch.from_numpy(qi)[:, None])


def test_scan_topk_cand_ties_go_to_the_earlier_position(interpret):
    """Duplicate candidates tie exactly: the earlier position wins (the
    JAX kernel's merge), whatever the table ids."""
    rng = np.random.default_rng(2)
    table = kernel_rows(rng, 50, 6, "poincare")
    table = np.concatenate([table, table])             # row i == row i+50
    cand = np.stack([np.r_[np.arange(60, 100), np.arange(0, 40)]] * 4)
    cand = cand.astype(np.int32)
    q = kernel_rows(rng, 4, 6, "poincare")
    qi = np.full(4, -5, np.int32)
    spec = spec_of("poincare")
    wd, wi = jscan.scan_topk_cand(jnp.asarray(table), jnp.asarray(cand),
                                  jnp.asarray(q), jnp.asarray(qi), spec=spec,
                                  k=30, exclude_self=False)
    gd, gi = scan_topk.scan_topk_cand(
        torch.from_numpy(table), torch.from_numpy(cand), torch.from_numpy(q),
        torch.from_numpy(qi), spec=spec, k=30)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    ties = 0
    for row in gi.numpy().tolist():     # the copy (earlier) before row j
        for j in range(10, 40):
            if j in row and j + 50 in row:
                assert row.index(j + 50) == row.index(j) - 1
                ties += 1
    assert ties >= 10


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", [1, 3, 8])
def test_scan_topk_pq_and_lut_match_jax(interpret, kind, m):
    """col0 != 0, n below the slab's end, exclude_self; codebooks from
    the port's build_pq on a lifted table (pad lanes zero, as trained)."""
    rng = np.random.default_rng(3)
    d = 8
    table = kernel_rows(rng, 700, d, kind)
    spec = spec_of(kind)
    codes, cb = tquant.build_pq(table, spec, m=m, iters=2)
    q = table[rng.choice(700, 11, replace=False)]
    lift = tidx._lift(spec, torch.from_numpy(q)).numpy()
    want_lut = np.asarray(jscan.pq_lut(jnp.asarray(lift),
                                       jnp.asarray(cb.codebooks), kind=kind))
    lut = scan_topk.pq_lut(torch.from_numpy(lift),
                           torch.from_numpy(cb.codebooks), kind=kind)
    assert lut.shape == (11, m * 256) and lut.dtype == torch.float32
    np.testing.assert_allclose(lut.numpy(), want_lut, **KTOL)
    col0, n = 100, 100 + 700 - 37
    qi = rng.integers(col0, col0 + 700, 11).astype(np.int32)
    for k in (1, 64):
        wd, wi = jscan.scan_topk_pq(
            jnp.asarray(codes), jnp.asarray(lut.numpy()), jnp.asarray(qi),
            col0, spec=spec, k=k, n=n, exclude_self=True, tile_rows=128)
        gd, gi = scan_topk.scan_topk_pq(
            torch.from_numpy(codes), lut, torch.from_numpy(qi), col0,
            spec=spec, k=k, n=n, exclude_self=True)
        assert_topk_equal(gd, gi, wd, wi, KTOL)
        ids = gi.numpy()
        assert ids.min() >= col0 and ids.max() < n
        assert not np.any(ids == qi[:, None])


def test_scan_topk_pq_narrow_slab_fills_inf(interpret):
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 256, (90, 3)).astype(np.uint8)
    lut = -np.abs(rng.standard_normal((5, 768))).astype(np.float32) - 0.4
    qi = np.arange(5, dtype=np.int32)
    spec = ("lorentz", 1.0)
    wd, wi = jscan.scan_topk_pq(jnp.asarray(codes), jnp.asarray(lut),
                                jnp.asarray(qi), 0, spec=spec, k=128, n=90,
                                exclude_self=True, tile_rows=128)
    gd, gi = scan_topk.scan_topk_pq(torch.from_numpy(codes),
                                    torch.from_numpy(lut),
                                    torch.from_numpy(qi), 0, spec=spec,
                                    k=128, n=90, exclude_self=True)
    assert_topk_equal(gd, gi, wd, wi, KTOL)
    assert np.all(gi.numpy()[:, 89:] == -1)


@pytest.mark.parametrize("spec,k,m,dim,cand", [
    (("poincare", 1.0), 170, 3, 10, 300), (("lorentz", 1.0), 256, 8, 11, 64),
    (("euclidean", 0.0), 1, 1, 3, 128), (("poincare", 1.0), 257, 3, 10, 64),
    (("poincare", 1.0), 10, 9, 10, 64), (("poincare", 1.0), 0, 3, 10, 64),
    (("product", (("poincare", 5, 1.0),)), 10, 3, 5, 64),
    (("sphere", 1.0), 10, 3, 10, 64)])
def test_support_gates_match_jax(spec, k, m, dim, cand):
    assert scan_topk.supports_pq(spec, k=k, m=m) is jscan.supports_pq(
        spec, k=k, m=m)
    assert scan_topk.supports_cand(spec, k=k, dim=dim, cand=cand) is \
        jscan.supports_cand(spec, k=k, dim=dim, cand=cand)
    assert scan_topk.FUSED_MAX_PQ_M == jscan.FUSED_MAX_PQ_M


def test_supports_cand_drops_the_gather_budget():
    """A balance-2 index over 82,115 rows probes ~573 rows a cell: the JAX
    gate turns its fused scan off there, the port's does not."""
    spec = ("poincare", 1.0)
    assert not jscan.supports_cand(spec, k=10, dim=10, cand=8 * 573)
    assert scan_topk.supports_cand(spec, k=10, dim=10, cand=8 * 573)


def test_new_wrappers_refuse_and_count_no_cpu_launch():
    before = (scan_topk.scan_topk_cand.launches,
              scan_topk.scan_topk_pq.launches)
    t = torch.zeros((6, 3))
    cand = torch.zeros((2, 4), dtype=torch.int32)
    qi = torch.zeros(2, dtype=torch.int32)
    spec = ("poincare", 1.0)
    scan_topk.scan_topk_cand(t, cand, t[:2], qi, spec=spec, k=2)
    codes = torch.zeros((6, 2), dtype=torch.uint8)
    scan_topk.scan_topk_pq(codes, torch.zeros((2, 512)), qi, 0, spec=spec,
                           k=2, n=6)
    # the int8 lane's scale= is served: on the CPU by the plain version
    got = scan_topk.scan_topk_cand(t.to(torch.int8), cand, t[:2], qi,
                                   spec=spec, k=2, scale=torch.ones(6))
    assert got[1].shape == (2, 2)
    assert (scan_topk.scan_topk_cand.launches,
            scan_topk.scan_topk_pq.launches) == before
    with pytest.raises(ValueError, match="unsupported"):
        scan_topk.scan_topk_cand(t, cand, t[:2], qi, spec=spec, k=300)
    with pytest.raises(ValueError, match="want table"):
        scan_topk.scan_topk_cand(t, cand, t[:3], qi, spec=spec, k=2)
    with pytest.raises(ValueError, match="lut width"):
        scan_topk.scan_topk_pq(codes, torch.zeros((2, 256)), qi, 0,
                               spec=spec, k=2, n=6)
    with pytest.raises(ValueError, match="unsupported"):
        scan_topk.scan_topk_pq(torch.zeros((6, 9), dtype=torch.uint8),
                               torch.zeros((2, 9 * 256)), qi, 0, spec=spec,
                               k=2, n=6)
    meta = torch.zeros((2, 512), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        scan_topk.scan_topk_pq(codes.to("meta"), meta, qi.to("meta"), 0,
                               spec=spec, k=2, n=6)
    with pytest.raises(ValueError, match="unsupported device"):
        scan_topk.scan_topk_cand(t.to("meta"), cand.to("meta"),
                                 t[:2].to("meta"), qi.to("meta"), spec=spec,
                                 k=2)


# --- PQ and IVF builds --------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_build_pq_is_array_equal_to_jax(kind):
    table = table_for(kind, n=3000)
    spec = spec_of(kind, 1.0)
    want_codes, want_cb = jquant.build_pq(table, spec)
    codes, cb = tquant.build_pq(table, spec)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(cb.codebooks, want_cb.codebooks)
    assert (cb.m, cb.ds, cb.lift_dim) == (want_cb.m, want_cb.ds,
                                           want_cb.lift_dim)
    assert cb.fingerprint == want_cb.fingerprint
    assert tquant.default_pq_m(11) == jquant.default_pq_m(11) == 3
    np.testing.assert_array_equal(tquant.pq_decode(cb, codes[:50]),
                                  jquant.pq_decode(want_cb, codes[:50]))


def test_pq_numpy_stage_is_array_equal_on_a_shared_lift():
    """The numpy stage alone, fed JAX's own lift, with m = 4 and a
    training sample smaller than the table."""
    from hyperspace_tpu.serve.index import _lift as jlift

    table = clustered(3000, 10)
    spec = ("poincare", 1.0)
    want_codes, want_cb = jquant.build_pq(table, spec, m=4, iters=3,
                                          seed=7, sample=2000)
    lift = np.asarray(jlift(spec, jnp.asarray(table)), np.float32)
    codes, cb = tquant.pq_from_lift(lift, 11, m=4, iters=3, seed=7,
                                    sample=2000)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(cb.codebooks, want_cb.codebooks)
    assert cb.fingerprint == want_cb.fingerprint


@pytest.mark.parametrize("kind", KINDS)
def test_build_index_matches_jax(kind):
    """The clustered 4,096 × 8 table (bench.py's generator), 64 cells,
    the export defaults otherwise (iters 8, seed 0, balance 2)."""
    table = table_for(kind)
    spec = spec_of(kind, 1.0)
    want = jidx.build_index(table, spec, 64)
    got = tidx.build_index(table, spec, 64, device="cpu")
    np.testing.assert_array_equal(got.cells, want.cells)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=1e-5,
                               atol=1e-7)
    assert (got.ncells, got.max_cell, got.num_nodes) == (
        want.ncells, want.max_cell, want.num_nodes)
    assert got.max_cell <= int(np.ceil(2.0 * 4096 / 64))
    assert sorted(got.cells[got.cells >= 0].tolist()) == list(range(4096))


def test_build_index_options_and_fingerprint():
    table = clustered(2500, 6)
    spec = ("poincare", 1.0)
    want = jidx.build_index(table, spec, 40, iters=3, seed=5, balance=0,
                            seed_sample=1000)
    got = tidx.build_index(table, spec, 40, iters=3, seed=5, balance=0,
                           seed_sample=1000, device="cpu")
    np.testing.assert_array_equal(got.cells, want.cells)
    fp = tidx.index_fingerprint_of(want.centroids, want.cells, want.counts,
                                   num_nodes=2500, iters=3, seed=5)
    assert fp == want.fingerprint
    assert tidx.auto_ncells(82115) == jidx.auto_ncells(82115) == 287
    assert tidx.IVF_MIN_TABLE_ROWS == jidx.IVF_MIN_TABLE_ROWS
    for bad in (dict(ncells=1), dict(ncells=40, balance=0.5)):
        with pytest.raises(ValueError):
            tidx.build_index(table, spec, device="cpu", **bad)


@pytest.mark.parametrize("spec", [
    ("sphere", 1.0), ("product", (("poincare", 3, 1.0), ("euclidean", 3, 0.0)))])
def test_unported_builds_raise(spec):
    """Sphere and product builds are ported (their lifts and cell means,
    ``tests/test_torch_serve_specs.py`` holds them against JAX): a table
    of one repeated point builds a valid partition and code table, by the
    resident and by the host-streamed build (held against JAX's streamed
    build in ``tests/test_torch_index_stream.py``)."""
    table = np.zeros((3000, 6), np.float32)
    table[:, 0] = 1.0
    for host_resident in (None, True):
        index = tidx.build_index(table, spec, 8, device="cpu",
                                 host_resident=host_resident)
        assert sorted(index.cells[index.cells >= 0].tolist()) == list(
            range(3000))
    codes, cb = tquant.build_pq(table, spec)
    assert codes.shape == (3000, cb.m)


# --- artifacts ----------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A clustered poincare table with a JAX-built index (64 cells) and PQ
    payload, exported by the JAX package."""
    table = clustered(4096, 8, seed=3, ncl=64)
    spec = ("poincare", 1.0)
    index = jidx.build_index(table, spec, 64)
    quant = jart.build_quant_payload(table, spec, "pq")
    path = str(tmp_path_factory.mktemp("art") / "jax")
    jart.export_artifact(path, table, spec, index=index, quant=quant)
    return {"table": table, "spec": spec, "path": path}


def test_artifacts_load_both_ways(served, tmp_path):
    jax_art = jart.load_artifact(served["path"])
    art = tart.load_artifact(served["path"])
    assert art.fingerprint == jax_art.fingerprint
    assert art.index.fingerprint == jax_art.index.fingerprint
    np.testing.assert_array_equal(art.index.cells, jax_art.index.cells)
    assert art.quant.lane == "pq" and art.quant.params == jax_art.quant.params
    assert art.quant.fingerprint == jax_art.quant.fingerprint
    # the port's own build and payload, exported by the port, in JAX
    table, spec = served["table"], served["spec"]
    index = tidx.build_index(table, spec, 64, device="cpu")
    quant = tart.build_quant_payload(table, spec, "pq")
    assert quant.fingerprint == jax_art.quant.fingerprint
    path = str(tmp_path / "port")
    mine = tart.export_artifact(path, table, spec, index=index, quant=quant)
    back = jart.load_artifact(path)
    assert back.fingerprint == mine.fingerprint
    assert mine.fingerprint == jart.fingerprint_of(
        table, spec, index.fingerprint, quant.fingerprint)
    assert mine.fingerprint != tart.fingerprint_of(table, spec)
    assert tart.load_artifact(path).fingerprint == mine.fingerprint


def test_int4_payload_loads_and_is_not_served(served, tmp_path):
    """The int4 payload JAX wrote loads, and is served now: the engine's
    int4 copy is the payload's codes and scales, array-equal to the
    port's own packing; f32 engines ignore it."""
    table, spec = served["table"], served["spec"]
    q4 = jart.build_quant_payload(table, spec, "int4")
    path = str(tmp_path / "int4")
    jart.export_artifact(path, table, spec, quant=q4)
    art = tart.load_artifact(path)
    assert art.quant.lane == "int4"
    assert art.fingerprint == jart.load_artifact(path).fingerprint
    eng = QueryEngine.from_artifact(art, precision="int4", device="cpu")
    mine = tart.build_quant_payload(table, spec, "int4")
    assert mine.fingerprint == q4.fingerprint
    np.testing.assert_array_equal(eng.scan_table[:4096].numpy(),
                                  mine.arrays["packed"])
    np.testing.assert_array_equal(eng.scan_scale[:4096].numpy(),
                                  mine.arrays["scale"])
    assert eng.scan_signature == ("exact", "int4")
    eng = QueryEngine.from_artifact(art, device="cpu")     # f32 ignores it
    assert eng.scan_signature == ("exact",)


def test_artifact_checks_rows_and_width(served, tmp_path):
    table, spec = served["table"], served["spec"]
    art = tart.load_artifact(served["path"])
    with pytest.raises(ValueError, match="index covers"):
        tart.export_artifact(str(tmp_path / "a"), table[:100], spec,
                             index=art.index)
    with pytest.raises(ValueError, match="centroid width"):
        tart.export_artifact(str(tmp_path / "b"), table[:, :4], spec,
                             index=art.index)
    with pytest.raises(ValueError, match="quant payload covers"):
        tart.export_artifact(str(tmp_path / "c"), table[:100], spec,
                             quant=art.quant)
    # a tampered payload fails its fingerprint
    path = str(tmp_path / "d")
    tart.export_artifact(path, table, spec, quant=art.quant)
    qpath = os.path.join(path, tart.QUANT_FILE)
    with np.load(qpath) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["codes"][0, 0] ^= 1
    np.savez(qpath, **arrays)
    with pytest.raises(ValueError, match="quant fingerprint mismatch"):
        tart.load_artifact(path)


# --- the engine ---------------------------------------------------------------


def engines(served, **kw):
    jeng = JaxEngine.from_artifact(jart.load_artifact(served["path"]), **kw)
    eng = QueryEngine.from_artifact(tart.load_artifact(served["path"]),
                                    device="cpu", **kw)
    return jeng, eng


QUERIES = np.random.default_rng(9).choice(4096, 48, replace=False).astype(
    np.int32)


@pytest.mark.parametrize("precision,nprobe", [
    ("f32", 1), ("f32", 4), ("pq", 0), ("pq", 4)])
@pytest.mark.parametrize("scan_mode", ["two_stage", "fused"])
def test_engine_matches_jax_engine(served, precision, nprobe, scan_mode):
    jeng, eng = engines(served, precision=precision, nprobe=nprobe,
                        scan_mode=scan_mode)
    want_i, want_d = (np.asarray(a) for a in jeng.topk_neighbors(QUERIES, 10))
    got_i, got_d = eng.topk_neighbors(QUERIES, 10)
    assert got_i.dtype == torch.int32 and got_i.shape == (48, 10)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, **ETOL)
    assert eng.scan_strategy == jeng.scan_strategy
    assert eng.scan_signature == jeng.scan_signature


def test_pq_distances_are_f32_distances(served):
    """Every PQ answer's distance is the f32 manifold distance of its id."""
    _, eng = engines(served, precision="pq", nprobe=4, scan_mode="fused")
    idx, dist = eng.topk_neighbors(QUERIES, 10)
    q = eng.table[torch.as_tensor(QUERIES).long()]
    want = eng.manifold.dist(q[:, None, :], eng.table[idx.long()])
    assert torch.equal(dist, want)


def test_nprobe_override_and_errors(served):
    _, eng = engines(served, nprobe=4)
    _, narrow = engines(served, nprobe=2)
    a_i, a_d = eng.topk_neighbors(QUERIES, 10, nprobe=2)
    b_i, b_d = narrow.topk_neighbors(QUERIES, 10)
    assert torch.equal(a_i, b_i) and torch.equal(a_d, b_d)
    for bad in (0, 5):
        with pytest.raises(ValueError, match="out of range"):
            eng.topk_neighbors(QUERIES, 10, nprobe=bad)
    cap = eng.index.max_cell
    with pytest.raises(ValueError, match="probe capacity"):
        eng.topk_neighbors(QUERIES, cap + 1, nprobe=1)
    exact = QueryEngine(served["table"], served["spec"], device="cpu")
    with pytest.raises(ValueError, match="probing engine"):
        exact.topk_neighbors(QUERIES, 10, nprobe=1)


def test_underfilled_probe_raises(served):
    """Cell 0 holds rows 0 and 1 and its centroid is row 0: row 0's
    nearest cell is its own, and excluding itself leaves one row."""
    table, spec = served["table"], served["spec"]
    rest = np.arange(2, 4096, dtype=np.int32)
    half = len(rest) // 2
    cells = np.full((3, len(rest) - half), -1, np.int32)
    cells[0, :2] = [0, 1]
    cells[1, :half] = rest[:half]
    cells[2, :len(rest) - half] = rest[half:]
    far = np.zeros((2, table.shape[1]), np.float32)
    far[:, 0] = [0.9, -0.9]
    idx = tidx.ServingIndex(
        centroids=np.concatenate([table[:1], far]), cells=cells,
        counts=(cells >= 0).sum(1).astype(np.int32), num_nodes=4096,
        iters=0, seed=0, fingerprint="hand-made")
    eng = QueryEngine(table, spec, index=idx, nprobe=1, device="cpu")
    with pytest.raises(ValueError, match="under-filled"):
        eng.topk_neighbors([0], 5)
    i, _ = eng.topk_neighbors([0], 1)
    assert int(i[0, 0]) == 1


@pytest.mark.parametrize("scan_mode", ["two_stage", "fused"])
def test_exact_fallbacks(served, scan_mode):
    """nprobe >= ncells serves the exact scan bit for bit; so does a
    table under IVF_MIN_TABLE_ROWS."""
    table, spec = served["table"], served["spec"]
    art = tart.load_artifact(served["path"])
    full = QueryEngine.from_artifact(art, nprobe=art.index.ncells,
                                     scan_mode=scan_mode, device="cpu")
    exact = QueryEngine(table, spec, scan_mode=scan_mode, device="cpu")
    assert full.scan_strategy == "exact"
    assert full.scan_signature == exact.scan_signature
    a_i, a_d = full.topk_neighbors(QUERIES, 10)
    b_i, b_d = exact.topk_neighbors(QUERIES, 10)
    assert torch.equal(a_i, b_i) and torch.equal(a_d, b_d)
    small = table[:1500]
    sidx = tidx.build_index(small, spec, 8, device="cpu")
    eng = QueryEngine(small, spec, index=sidx, nprobe=2,
                      scan_mode=scan_mode, device="cpu")
    assert eng.scan_strategy == "exact"
    a_i, a_d = eng.topk_neighbors(QUERIES[:5] % 1500, 10)
    b_i, b_d = QueryEngine(small, spec, scan_mode=scan_mode,
                           device="cpu").topk_neighbors(QUERIES[:5] % 1500,
                                                        10)
    assert torch.equal(a_i, b_i) and torch.equal(a_d, b_d)


def test_engine_option_checks(served):
    table, spec = served["table"], served["spec"]
    art = tart.load_artifact(served["path"])
    with pytest.raises(ValueError, match="needs an IVF index"):
        QueryEngine(table, spec, nprobe=2, device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        QueryEngine(table, spec, nprobe=-1, device="cpu")
    with pytest.raises(ValueError, match="built over"):
        QueryEngine(table[:3000], spec, index=art.index, device="cpu")
    with pytest.raises(ValueError, match="quant payload covers"):
        QueryEngine(table[:3000], spec, quant=art.quant, precision="pq",
                    device="cpu")
    with pytest.raises(ValueError, match="precision must be"):
        QueryEngine(table, spec, precision="fp8", device="cpu")
    # no payload: the engine trains its own codebooks, as JAX's does
    eng = QueryEngine(table, spec, precision="pq", device="cpu")
    jeng = JaxEngine(table, spec, precision="pq")
    assert eng.scan_signature == jeng.scan_signature
    assert eng._k_scan(10, 10 ** 6) == jeng._k_scan(10, 10 ** 6) == 170
    assert eng._k_scan(10, 100) == 100


def test_signatures_separate_cache_rows(served):
    """f32 exact, IVF at two widths and PQ rows never share cache keys;
    stats report the strategy, precision and width."""
    art = tart.load_artifact(served["path"])
    kinds = {}
    for name, kw in (("exact", {}), ("ivf1", dict(nprobe=1)),
                     ("ivf4", dict(nprobe=4)), ("pq", dict(precision="pq")),
                     ("pq_ivf", dict(precision="pq", nprobe=4))):
        eng = QueryEngine.from_artifact(art, device="cpu", scan_mode="fused",
                                        **kw)
        bat = RequestBatcher(eng, min_bucket=4, max_bucket=64)
        keyf, _nprobe_ov, _cache_only = bat.plan_topk(10, True)
        kinds[name] = keyf(int(QUERIES[0]))
        st = bat.stats()
        assert st["scan_strategy"] == ("ivf" if "ivf" in name else "exact")
        assert st["precision"] == kw.get("precision", "f32")
        assert st["nprobe"] == kw.get("nprobe", 0)
    assert len(set(kinds.values())) == len(kinds)
    eng = QueryEngine.from_artifact(art, device="cpu", nprobe=4)
    assert eng.scan_signature_for(2) == ("ivf", 2, art.index.fingerprint)
    assert kinds["ivf4"][-1] == ("ivf", 4, art.index.fingerprint, "fused")


def test_batcher_serves_ivf_pq_answers(served):
    art = tart.load_artifact(served["path"])
    eng = QueryEngine.from_artifact(art, device="cpu", scan_mode="fused",
                                    precision="pq", nprobe=4)
    bat = RequestBatcher(eng, min_bucket=4, max_bucket=32)
    base = telem.default_registry().mark()
    ids = QUERIES[:40].tolist()
    idx, dist = bat.topk(ids, 10)
    ref_i, ref_d = eng.topk_neighbors(np.asarray(ids, np.int32), 10)
    np.testing.assert_array_equal(idx, ref_i.numpy())
    np.testing.assert_array_equal(dist, ref_d.numpy())
    bat.topk(ids[:3], 10)
    assert serve_counts(base)["cache_hit"] == 3


# --- the CLI ------------------------------------------------------------------


def test_cli_serve_loop_with_nprobe_and_pq(served):
    lines = "\n".join(json.dumps(r) for r in (
        {"op": "topk", "ids": QUERIES[:6].tolist(), "k": 10},
        {"op": "topk", "ids": [0], "k": 10 ** 6},
        {"op": "stats"})) + "\n"
    out = io.StringIO()
    closing = cli.run_serve(
        cli.ServeConfig(artifact=served["path"], device="cpu",
                        scan_mode="fused", precision="pq", nprobe=4),
        stdin=io.StringIO(lines), stdout=out)
    resp = [json.loads(s) for s in out.getvalue().splitlines()]
    assert len(resp) == 3 and "error" in resp[1]
    _, eng = engines(served, scan_mode="fused", precision="pq", nprobe=4)
    want_i, want_d = eng.topk_neighbors(QUERIES[:6], 10)
    assert resp[0]["neighbors"] == want_i.tolist()
    np.testing.assert_allclose(resp[0]["dists"], want_d.numpy(), rtol=1e-7)
    assert resp[2]["scan_strategy"] == "ivf" and resp[2]["precision"] == "pq"
    assert resp[2]["nprobe"] == 4 and closing["served"] == 2
    res = cli.run_query(cli.ServeConfig(
        artifact=served["path"], device="cpu", nprobe=2,
        ids=",".join(map(str, QUERIES[:3])), k=5))
    _, eng2 = engines(served, nprobe=2)
    assert res["neighbors"] == eng2.topk_neighbors(QUERIES[:3],
                                                   5)[0].tolist()


@pytest.mark.parametrize("bad", ["scan_mode=carry", "precision=bogus",
                                 "nprobe=-1", "nprobe=abc"])
def test_cli_rejects_bad_lane_options(served, bad):
    with pytest.raises(SystemExit):
        cli.main(["query", f"artifact={served['path']}", "device=cpu",
                  "ids=1,2", bad])

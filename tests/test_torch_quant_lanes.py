"""The port's bf16, int8 and int4 serving lanes against the JAX package,
on the CPU.

Both sides get the same numpy inputs made from a seed.  JAX's slab and
candidate scans run their XLA twins (JAX's default on the CPU, held
bitwise to the Pallas interpreter by ``tests/kernels/test_scan_topk.py``);
its bf16 ``pdist`` runs the Pallas body in interpret mode
(``HYPERSPACE_KERNELS=interpret``), because JAX's XLA twin computes in
bf16 while the TPU kernel, and the port, compute in f32 and round once.

Tolerances:
- the quantizers, the int4 packing and the int4 payload: bitwise;
- ``scan_topk`` / ``scan_topk_cand`` lanes against JAX's: ids equal,
  distances rtol 1e-6 and atol 1e-6 (the same widened rows; the Gram
  products are summed in another order); hyperboloid rows in the arcosh
  argument u = cosh d − 1, within twice the Gram form's forward-error
  bound (D + 2)·2^-24·(Σ|x_i|)² at the largest row: rows lifted from
  radius 0.9 have x_0 up to 9.5, and a bf16 copy puts near pairs at
  d ≈ 2e-3, where that bound is 1e-4 of d;
- bf16 ``pdist`` against JAX's interpreter: one bf16 ulp (the two f32
  results round to bf16 apart when they straddle a rounding boundary);
- the engines: neighbours equal, distances rtol 1e-5 and atol 1e-4, the
  serving tier (every lane rescores in f32).  JAX's bf16 lane scores
  in bf16 arithmetic on the CPU where its TPU kernels do not: its
  ``pdist`` twin, and its candidate scorer (its fused gate refuses
  these lists, C > its gather budget).  The bf16 rescore then misses up
  to 3 of 400 neighbours at these rows, where the port, which widens to
  f32 as the TPU kernels do, misses none on the ball.  So the exact
  bf16 two-stage engine is held to JAX's in interpret mode (the Pallas
  body), and the bf16 probe to JAX's f32 probe: recall@10 at least that
  of JAX's bf16 probe (on the hyperboloid a bf16 row moves u = cosh d −
  1 by ~2^-8 of x_0·y_0, which reorders near neighbours past the
  over-fetch in both packages), each distance the f32 distance of its
  id.
"""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.kernels import distmat as jdist
from hyperspace_tpu.kernels import scan_topk as jscan
from hyperspace_tpu.manifolds import PoincareBall as JBall
from hyperspace_tpu.serve import artifact as jart
from hyperspace_tpu.serve import index as jidx
from hyperspace_tpu.serve import quant as jquant
from hyperspace_tpu.serve.engine import QueryEngine as JaxEngine
from hyperspace_torch.cli import serve as cli
from hyperspace_torch.cli import train as ttrain
from hyperspace_torch.kernels import scan_topk
from hyperspace_torch.kernels.distmat import pdist
from hyperspace_torch.manifolds.maps import ball_to_lorentz
from hyperspace_torch.serve import artifact as tart
from hyperspace_torch.serve import quant as tquant
from hyperspace_torch.serve.batcher import RequestBatcher
from hyperspace_torch.serve.engine import QueryEngine
from hyperspace_torch.telemetry import registry as telem
from hyperspace_torch.train.checkpoint import restore_params_only

KTOL = dict(rtol=1e-6, atol=1e-6)
ETOL = dict(rtol=1e-5, atol=1e-4)
KINDS = ["poincare", "lorentz", "euclidean"]
LANES = ["bf16", "int8", "int4"]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_KERNELS", "interpret")


def spec_of(kind):
    return (kind, 0.0 if kind == "euclidean" else 1.0)


def ball_rows(rng, n, d, radius=0.9):
    v = rng.standard_normal((n, d))
    v *= rng.uniform(0.0, radius, (n, 1)) / np.linalg.norm(v, axis=1,
                                                          keepdims=True)
    return v.astype(np.float32)


def kind_rows(rng, n, d, kind):
    """Gaussians for euclidean, ball rows (lifted for lorentz)."""
    if kind == "euclidean":
        return rng.standard_normal((n, d)).astype(np.float32)
    x = ball_rows(rng, n, d)
    if kind == "lorentz":
        x = ball_to_lorentz(torch.from_numpy(x), 1.0).numpy()
    return x


def lane_arrays(table, lane):
    """(slab, scale, packed) of ``table`` in ``lane``, numpy."""
    if lane == "bf16":
        return table, None, False
    if lane == "int8":
        return (*tquant.quantize_rows(table), False)
    return (*tquant.pack_int4_rows(table), True)


def to_torch(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def assert_topk_equal(got, want, tol, lorentz_rows=None):
    (gd, gi), (wd, wi) = got, want
    gd, gi, wd, wi = (np.asarray(a) for a in (gd, gi, wd, wi))
    if lorentz_rows is not None:
        x1 = float(np.abs(lorentz_rows).sum(axis=1).max())
        tol = dict(rtol=tol["rtol"], atol=2.0 * (lorentz_rows.shape[1] + 2)
                   * 2.0 ** -24 * x1 * x1)
        gd, wd = (2.0 * np.sinh(t.astype(np.float64) / 2.0) ** 2
                  for t in (gd, wd))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], **tol)


# --- the quantizers -----------------------------------------------------------


def quant_table(d, seed=0):
    """Rows of mixed scale, an all-zero row and a row at +-its max."""
    rng = np.random.default_rng(seed)
    t = (rng.standard_normal((64, d)) * rng.uniform(1e-3, 3.0, (64, 1))
         ).astype(np.float32)
    t[5] = 0.0
    t[9, 0] = -np.abs(t[9]).max() * 2
    return t


@pytest.mark.parametrize("d", [1, 7, 10, 11])
def test_int8_quantizer_is_bitwise_jax(d):
    t = quant_table(d)
    q, s = tquant.quantize_rows(t)
    jq, js = jquant.quantize_rows(t)
    assert q.dtype == jq.dtype == np.int8 and s.dtype == js.dtype
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(tquant.dequantize_rows(q, s),
                                  jquant.dequantize_rows(jq, js))
    assert tquant.quant_error_bound(s) == jquant.quant_error_bound(js)
    assert tquant.QLEVELS == jquant.QLEVELS and not q[5].any()


@pytest.mark.parametrize("d", [1, 7, 10, 11])
def test_int4_packing_is_bitwise_jax(d):
    t = quant_table(d, seed=1)
    pk, s = tquant.pack_int4_rows(t)
    jpk, js = jquant.pack_int4_rows(t)
    assert pk.dtype == np.uint8 and s.dtype == js.dtype == np.float16
    np.testing.assert_array_equal(pk, jpk)
    np.testing.assert_array_equal(s, js)
    assert tquant.int4_packed_width(d) == jquant.int4_packed_width(d)
    np.testing.assert_array_equal(tquant.unpack_int4_rows(pk, d),
                                  jquant.unpack_int4_rows(jpk, d))
    np.testing.assert_array_equal(tquant.dequantize_int4_rows(pk, s, d),
                                  jquant.dequantize_int4_rows(jpk, js, d))
    np.testing.assert_array_equal(
        tquant.unpack_int4_torch(torch.from_numpy(pk), d).numpy(),
        np.asarray(jquant.unpack_int4_jnp(jnp.asarray(jpk), d)))
    np.testing.assert_array_equal(
        tquant.dequantize_torch(torch.from_numpy(pk), torch.from_numpy(s),
                                packed=True, dim=d).numpy(),
        jquant.dequantize_int4_rows(jpk, js, d))
    assert tquant.QLEVELS4 == jquant.QLEVELS4


def test_int4_payload_round_trips_both_ways(tmp_path):
    """The port's int4 payload is JAX's: arrays, params, fingerprint; an
    artifact written by either loads in the other under one name."""
    rng = np.random.default_rng(2)
    table = ball_rows(rng, 300, 10)
    spec = ("poincare", 1.0)
    mine = tart.build_quant_payload(table, spec, "int4")
    theirs = jart.build_quant_payload(table, spec, "int4")
    assert mine.lane == theirs.lane == "int4"
    assert mine.params == theirs.params == {"dim": 10}
    for name in ("packed", "scale"):
        np.testing.assert_array_equal(mine.arrays[name], theirs.arrays[name])
    assert mine.fingerprint == theirs.fingerprint
    for write, read, payload in ((tart, jart, mine), (jart, tart, theirs)):
        path = str(tmp_path / write.__name__.split(".")[0])
        written = write.export_artifact(path, table, spec, quant=payload)
        back = read.load_artifact(path)
        assert back.fingerprint == written.fingerprint
        assert back.quant.fingerprint == payload.fingerprint
        np.testing.assert_array_equal(back.quant.arrays["packed"],
                                      payload.arrays["packed"])


# --- the kernels' plain versions ----------------------------------------------


def bf16_ulp(x):
    x = np.abs(np.asarray(x, np.float64))
    return np.where(x > 0, 2.0 ** (np.floor(np.log2(np.where(x > 0, x, 1)))
                                   - 7), 2.0 ** -133)


def bf16_pair(kind, n, m, d, seed):
    rng = np.random.default_rng(seed)
    x = kind_rows(rng, n, d, kind)
    y = kind_rows(rng, m, d, kind)
    tx, ty = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, y))
    jx, jy = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tx, ty))
    return tx, ty, jx, jy


@pytest.mark.parametrize("kind,d", [("poincare", 10), ("lorentz", 11)])
def test_pdist_bf16_plain_matches_jax_interpret(interpret, kind, d):
    """bf16 in and out, f32 inside, one rounding: within one bf16 ulp of
    the Pallas body run by the interpreter."""
    tx, ty, jx, jy = bf16_pair(kind, 21, 300, d, seed=3)
    got = pdist(tx, ty, 1.0, manifold=kind)
    want = np.asarray(jdist.pdist(jx, jy, 1.0, manifold=kind)
                      .astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    assert np.all(np.abs(got.float().numpy() - want) <= bf16_ulp(want))


def test_pdist_bf16_xla_twin_computes_in_bf16():
    """JAX's XLA twin (its CPU default) computes the closed form in bf16,
    so it strays from the body beyond the one-ulp tier the port meets
    (3 bf16 ulps at these rows): the port follows the body (ROADMAP
    §C)."""
    tx, ty, jx, jy = bf16_pair("poincare", 21, 300, 10, seed=3)
    got = pdist(tx, ty, 1.0, manifold="poincare").float().numpy()
    twin = np.asarray(jdist.pdist(jx, jy, 1.0, manifold="poincare")
                      .astype(jnp.float32))
    assert np.max(np.abs(got - twin) / bf16_ulp(got)) > 1.0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lane", LANES)
def test_scan_topk_lanes_plain_match_jax(kind, lane):
    """M = 700 (no multiple of 128): k 10 over the whole slab, and k 64
    with exclude_self, col0 and n cut."""
    rng = np.random.default_rng(4)
    d = 11 if kind == "lorentz" else 10
    table = kind_rows(rng, 700, d, kind)
    q = kind_rows(rng, 9, d, kind)
    slab, scale, packed = lane_arrays(table, lane)
    tslab = to_torch(slab)
    jslab = jnp.asarray(slab)
    tq, jq = torch.from_numpy(q), jnp.asarray(q)
    if lane == "bf16":
        tslab, jslab = tslab.to(torch.bfloat16), jslab.astype(jnp.bfloat16)
        tq, jq = tq.to(torch.bfloat16), jq.astype(jnp.bfloat16)
    spec = spec_of(kind)
    for k, ex, col0, n in ((10, False, 0, 700),
                           (64, True, 300, 300 + 700 - 31)):
        qi = rng.integers(col0, col0 + 700, 9).astype(np.int32)
        got = scan_topk.scan_topk(tslab, tq, torch.from_numpy(qi), col0,
                                  spec=spec, k=k, n=n, exclude_self=ex,
                                  scale=to_torch(scale), packed=packed)
        want = jscan.scan_topk(jslab, jq, jnp.asarray(qi), col0, spec=spec,
                               k=k, n=n, exclude_self=ex,
                               scale=None if scale is None
                               else jnp.asarray(scale), packed=packed)
        assert_topk_equal(got, want, KTOL, lorentz_rows=(
            table if kind == "lorentz" else None))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lane", ["bf16", "int8"])
def test_scan_topk_cand_lanes_plain_match_jax(kind, lane):
    """C = 300 with -1 pads in mid-list, a query with no candidate,
    exclude_self; the int8 scale gathered beside each candidate."""
    rng = np.random.default_rng(5)
    d = 11 if kind == "lorentz" else 10
    table = kind_rows(rng, 2000, d, kind)
    q = kind_rows(rng, 13, d, kind)
    cand = rng.integers(0, 2000, (13, 300)).astype(np.int32)
    cand[:, 50:83] = -1
    cand[3] = -1
    qi = cand[:, 5].copy()
    slab, scale, _ = lane_arrays(table, lane)
    tslab, jslab = to_torch(slab), jnp.asarray(slab)
    tq, jq = torch.from_numpy(q), jnp.asarray(q)
    if lane == "bf16":
        tslab, jslab = tslab.to(torch.bfloat16), jslab.astype(jnp.bfloat16)
        tq, jq = tq.to(torch.bfloat16), jq.astype(jnp.bfloat16)
    spec = spec_of(kind)
    got = scan_topk.scan_topk_cand(tslab, torch.from_numpy(cand), tq,
                                   torch.from_numpy(qi), spec=spec, k=32,
                                   exclude_self=True, scale=to_torch(scale))
    want = jscan.scan_topk_cand(jslab, jnp.asarray(cand), jq,
                                jnp.asarray(qi), spec=spec, k=32,
                                exclude_self=True,
                                scale=None if scale is None
                                else jnp.asarray(scale))
    assert_topk_equal(got, want, KTOL, lorentz_rows=(
        table if kind == "lorentz" else None))


def test_lane_gates_and_refusals():
    spec = ("poincare", 1.0)
    for lane in ("f32",) + tuple(LANES):
        assert scan_topk.supports(spec, k=256, dim=10, lane=lane)
    # a narrow lane's byte buffers cap its width below FUSED_MAX_DIM
    assert scan_topk.supports(spec, k=256, dim=1024)
    assert not scan_topk.supports(spec, k=256, dim=1024, lane="bf16")
    assert scan_topk.supports_cand(spec, k=10, dim=10, cand=64, lane="int8")
    assert not scan_topk.supports_cand(spec, k=10, dim=10, cand=64,
                                       lane="int4")
    t = torch.zeros((6, 5), dtype=torch.uint8)
    q, qi = torch.zeros((2, 10)), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="requires scale"):
        scan_topk.scan_topk(t, q, qi, 0, spec=spec, k=2, n=6, packed=True)
    with pytest.raises(ValueError, match="packed slab"):
        scan_topk.scan_topk(t[:, :4], q, qi, 0, spec=spec, k=2, n=6,
                            scale=torch.ones(6, dtype=torch.float16),
                            packed=True)


# --- the engine ---------------------------------------------------------------


def clustered(n, dim, seed, ncl=64):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, dim)) * 0.25
    vv = (centers[rng.integers(0, ncl, size=n)]
          + rng.standard_normal((n, dim)) * 0.05)
    return np.asarray(JBall(1.0).expmap0(jnp.asarray(vv, jnp.float32)))


@pytest.fixture(scope="module")
def kind_artifacts(tmp_path_factory):
    """A 4,099-row clustered table in each family with a JAX-built index
    (64 cells) and int4 payload, exported by the JAX package (a row
    count of its own: JAX's jitted engine programs are cached by shape,
    whatever kernel mode traced them)."""
    out = {}
    for kind in KINDS:
        table = clustered(4099, 8, seed=6)
        if kind == "lorentz":
            table = ball_to_lorentz(torch.tensor(table), 1.0).numpy()
        spec = spec_of(kind)
        path = str(tmp_path_factory.mktemp("art") / kind)
        jart.export_artifact(path, table, spec,
                             index=jidx.build_index(table, spec, 64),
                             quant=jart.build_quant_payload(table, spec,
                                                            "int4"))
        out[kind] = path
    return out


QUERIES = np.random.default_rng(9).choice(4096, 40, replace=False).astype(
    np.int32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("precision", LANES)
@pytest.mark.parametrize("nprobe", [0, 4])
@pytest.mark.parametrize("scan_mode", ["two_stage", "fused"])
def test_engine_lanes_match_jax_engine(kind_artifacts, monkeypatch, kind,
                                       precision, nprobe, scan_mode):
    if precision == "bf16" and scan_mode == "two_stage":
        monkeypatch.setenv("HYPERSPACE_KERNELS", "interpret")
    kw = dict(precision=precision, nprobe=nprobe, scan_mode=scan_mode)
    path = kind_artifacts[kind]
    jeng = JaxEngine.from_artifact(jart.load_artifact(path), **kw)
    eng = QueryEngine.from_artifact(tart.load_artifact(path), device="cpu",
                                    **kw)
    got_i, got_d = eng.topk_neighbors(QUERIES, 10)
    assert got_d.dtype == torch.float32 and got_i.shape == (40, 10)
    want_i, want_d = (np.asarray(a) for a in jeng.topk_neighbors(QUERIES,
                                                                 10))
    if precision == "bf16" and nprobe:
        ref = JaxEngine.from_artifact(jart.load_artifact(path),
                                      **{**kw, "precision": "f32"})
        f32_i = np.asarray(ref.topk_neighbors(QUERIES, 10)[0])

        def recall(ids):
            return np.mean([len(set(a) & set(b)) for a, b in zip(ids, f32_i)])

        assert recall(got_i.numpy()) >= recall(want_i)
        q = eng.table[torch.as_tensor(QUERIES).long()]
        f32_d = eng.manifold.dist(q[:, None, :], eng.table[got_i.long()])
        np.testing.assert_allclose(got_d.numpy(), f32_d.numpy(), **ETOL)
    else:
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        np.testing.assert_allclose(got_d.numpy(), want_d, **ETOL)
    assert eng.scan_signature == jeng.scan_signature
    assert eng._k_scan(10, 4099) == jeng._k_scan(10, 4099)


def test_lane_signatures_cache_keys_and_prewarm(kind_artifacts):
    """Each lane's rows land under their own cache keys, and after
    ``prewarm`` over the lane's buckets no request counts a cold
    dispatch."""
    art = tart.load_artifact(kind_artifacts["poincare"])
    keys = set()
    for precision in ("f32",) + tuple(LANES):
        eng = QueryEngine.from_artifact(art, device="cpu", nprobe=4,
                                        precision=precision,
                                        scan_mode="fused")
        bat = RequestBatcher(eng, min_bucket=4, max_bucket=16,
                             cache_size=64)
        keyf, _, _ = bat.plan_topk(5, True)
        keys.add(keyf(7))
        bat.prewarm([5])
        base = telem.default_registry().mark()
        bat.topk(list(range(11)), 5)
        bat.topk([3], 5)
        snap = telem.default_registry().snapshot(baseline=base)
        assert snap.get("serve/cold_dispatches", 0) == 0
        assert bat.stats()["precision"] == precision
    assert len(keys) == 4


def test_cli_serve_loop_with_int8_and_int4(kind_artifacts):
    """``serve precision=int8`` answers the engine's rows; ``query
    precision=int4`` serves the artifact's shipped int4 codes."""
    path = kind_artifacts["poincare"]
    lines = "\n".join(json.dumps(r) for r in (
        {"op": "topk", "ids": QUERIES[:6].tolist(), "k": 10},
        {"op": "stats"})) + "\n"
    out = io.StringIO()
    cli.run_serve(cli.ServeConfig(artifact=path, device="cpu",
                                  precision="int8", scan_mode="fused",
                                  nprobe=4),
                  stdin=io.StringIO(lines), stdout=out)
    resp = [json.loads(s) for s in out.getvalue().splitlines()]
    eng = QueryEngine.from_artifact(tart.load_artifact(path), device="cpu",
                                    precision="int8", scan_mode="fused",
                                    nprobe=4)
    want_i, want_d = eng.topk_neighbors(QUERIES[:6], 10)
    assert resp[0]["neighbors"] == want_i.tolist()
    np.testing.assert_allclose(resp[0]["dists"], want_d.numpy(), rtol=1e-7)
    assert resp[1]["precision"] == "int8"
    res = cli.run_query(cli.ServeConfig(
        artifact=path, device="cpu", precision="int4",
        ids=",".join(map(str, QUERIES[:3])), k=5))
    jeng = JaxEngine.from_artifact(jart.load_artifact(path),
                                   precision="int4")
    assert res["neighbors"] == np.asarray(
        jeng.topk_neighbors(QUERIES[:3], 5)[0]).tolist()


def test_cli_export_quant_int4(tmp_path, capsys):
    """``export quant=int4`` from a port checkpoint writes JAX's int4
    payload for the restored table; ``query precision=int4`` serves it."""
    ck = str(tmp_path / "ck")
    assert ttrain.main(["poincare", "device=cpu", "steps=10",
                        f"ckpt_dir={ck}", "ckpt_every=10",
                        "batch_size=64"]) == 0
    capsys.readouterr()
    out = str(tmp_path / "art")
    assert cli.main(["export", f"ckpt={ck}", f"out={out}", "c=1.0",
                     "quant=int4", "device=cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    table = restore_params_only(ck)[0]["table"].numpy()
    want = jart.build_quant_payload(table, ("poincare", 1.0), "int4")
    assert res["quant"] == {"lane": "int4", "fingerprint": want.fingerprint}
    assert jart.load_artifact(out).fingerprint == res["fingerprint"]
    got = cli.run_query(cli.ServeConfig(artifact=out, device="cpu",
                                        precision="int4", ids="0,1,2", k=5))
    assert np.asarray(got["neighbors"]).shape == (3, 5)

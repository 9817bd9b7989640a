"""The port's engine on the euclidean, sphere and product specs against
the JAX package, on the CPU: the IVF index's lifts and cell means, its
build, PQ per factor, the engine on every lane, and a product artifact
exported from the port's own checkpoint.

Both sides get the same numpy inputs made from a seed; JAX runs its
default CPU path (these specs run no Pallas kernel of their own).

Tolerances: lifts and cell means rtol 1e-6 (float32, another order of
the same operations); index cells and counts equal, centroids rtol
1e-5; PQ codes and codebooks array-equal; the engines: neighbours equal,
distances rtol 1e-5 and atol 1e-4 (the serving tier).  JAX's bf16 lane
scores these specs in bf16 arithmetic (its ``_tile_dist`` and
``_cand_dist`` on bf16 rows) where the port widens to f32, so its bf16
engine is the reference by recall against the f32 engine only (as in
``tests/test_torch_quant_lanes.py``).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.serve import artifact as jart
from hyperspace_tpu.serve import index as jidx
from hyperspace_tpu.serve import quant as jquant
from hyperspace_tpu.serve.engine import QueryEngine as JaxEngine
from hyperspace_torch.cli import serve as cli
from hyperspace_torch.cli import train as ttrain
from hyperspace_torch.serve import artifact as tart
from hyperspace_torch.serve import index as tidx
from hyperspace_torch.serve import quant as tquant
from hyperspace_torch.serve.engine import QueryEngine
from hyperspace_torch.train.checkpoint import restore_params_only

ETOL = dict(rtol=1e-5, atol=1e-4)
N = 3000
SPECS = {
    "euclidean": ("euclidean", 0.0),
    "sphere": ("sphere", 1.3),
    "product": ("product", (("poincare", 3, 1.0), ("sphere", 3, 0.7),
                            ("euclidean", 2, 0.0))),
}


def spec_rows(kind, n=N, seed=5):
    """Rows on each spec's manifold, float32."""
    rng = np.random.default_rng(seed)
    if kind == "euclidean":
        return rng.standard_normal((n, 6)).astype(np.float32)
    if kind == "sphere":
        x = rng.standard_normal((n, 6))
        return (x / np.linalg.norm(x, axis=1, keepdims=True)
                / np.sqrt(1.3)).astype(np.float32)
    b = rng.standard_normal((n, 3))
    b *= rng.uniform(0, 0.8, (n, 1)) / np.linalg.norm(b, axis=1,
                                                      keepdims=True)
    s = rng.standard_normal((n, 3))
    s = s / np.linalg.norm(s, axis=1, keepdims=True) / np.sqrt(0.7)
    e = rng.standard_normal((n, 2))
    return np.concatenate([b, s, e], 1).astype(np.float32)


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_lifts_and_cell_means_match_jax(kind):
    spec, x = SPECS[kind], spec_rows(kind, 64)
    assert tidx._lift_dim(spec, x.shape[1]) == jidx._lift_dim(spec,
                                                              x.shape[1])
    lifted = tidx._lift(spec, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(lifted, np.asarray(
        jidx._lift(spec, jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    seg = np.arange(64) % 5
    sums = np.stack([lifted[seg == c].sum(0) for c in range(5)])
    cnt = np.bincount(seg, minlength=5).astype(np.float32)
    got = tidx._unlift(spec, torch.from_numpy(sums),
                       torch.from_numpy(cnt)).numpy()
    want = np.asarray(jidx._unlift(spec, jnp.asarray(sums),
                                   jnp.asarray(cnt)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["sphere", "product"])
def test_index_and_pq_builds_match_jax(kind):
    spec, table = SPECS[kind], spec_rows(kind)
    got = tidx.build_index(table, spec, 32, device="cpu")
    want = jidx.build_index(table, spec, 32)
    np.testing.assert_array_equal(got.cells, want.cells)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=1e-5,
                               atol=1e-6)
    codes, cb = tquant.build_pq(table, spec)
    jcodes, jcb = jquant.build_pq(table, spec)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(cb.codebooks, jcb.codebooks)
    assert cb.fingerprint == jcb.fingerprint


@pytest.fixture(scope="module")
def spec_artifacts(tmp_path_factory):
    """Each spec's table with a JAX-built index (32 cells) and PQ
    payload, exported by the JAX package."""
    out = {}
    for kind, spec in SPECS.items():
        table = spec_rows(kind)
        path = str(tmp_path_factory.mktemp("art") / kind)
        jart.export_artifact(path, table, spec,
                             index=jidx.build_index(table, spec, 32),
                             quant=jart.build_quant_payload(table, spec,
                                                            "pq"))
        out[kind] = path
    return out


QUERIES = np.random.default_rng(9).choice(N, 32, replace=False).astype(
    np.int32)


def check_engine(path, **kw):
    jeng = JaxEngine.from_artifact(jart.load_artifact(path), **kw)
    eng = QueryEngine.from_artifact(tart.load_artifact(path), device="cpu",
                                    **kw)
    got_i, got_d = eng.topk_neighbors(QUERIES, 10)
    want_i, want_d = (np.asarray(a) for a in jeng.topk_neighbors(QUERIES,
                                                                 10))
    assert eng.scan_signature == jeng.scan_signature
    assert eng.scan_strategy == jeng.scan_strategy
    if kw["precision"] != "bf16":
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        np.testing.assert_allclose(got_d.numpy(), want_d, **ETOL)
        return
    ref = JaxEngine.from_artifact(jart.load_artifact(path),
                                  **{**kw, "precision": "f32"})
    f32_i = np.asarray(ref.topk_neighbors(QUERIES, 10)[0])

    def recall(ids):
        return np.mean([len(set(a) & set(b)) for a, b in zip(ids, f32_i)])

    assert recall(got_i.numpy()) >= recall(want_i)
    q = eng.table[torch.as_tensor(QUERIES).long()]
    f32_d = eng.manifold.dist(q[:, None, :], eng.table[got_i.long()])
    np.testing.assert_allclose(got_d.numpy(), f32_d.numpy(), **ETOL)


@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("precision", ["f32", "pq"])
@pytest.mark.parametrize("nprobe", [0, 4])
@pytest.mark.parametrize("scan_mode", ["two_stage", "fused"])
def test_spec_engine_matches_jax(spec_artifacts, kind, precision, nprobe,
                                 scan_mode):
    """Exact and IVF, f32 and PQ (a product's PQ decodes per factor and
    never takes the ADC kernel), both modes (sphere and product specs
    serve ``fused`` by the two-stage scan, as in JAX)."""
    check_engine(spec_artifacts[kind], precision=precision, nprobe=nprobe,
                 scan_mode=scan_mode)


@pytest.mark.parametrize("kind", ["sphere", "product"])
@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("nprobe", [0, 4])
def test_spec_lanes_match_jax(spec_artifacts, kind, precision, nprobe):
    check_engine(spec_artifacts[kind], precision=precision, nprobe=nprobe,
                 scan_mode="two_stage")


def test_product_export_from_port_checkpoint_serves(tmp_path, capsys):
    """``cli.train product`` with ``ckpt_dir``, then ``cli.serve export
    workload=product index=1 quant=pq``: JAX loads the artifact under
    the same fingerprint, and the port's ``query`` answers what JAX's
    engine answers on it, f32 and PQ."""
    ck = str(tmp_path / "ck")
    assert ttrain.main(["product", "device=cpu", "steps=20",
                        f"ckpt_dir={ck}", "ckpt_every=20"]) == 0
    capsys.readouterr()
    out = str(tmp_path / "art")
    assert cli.main(["export", "workload=product", f"ckpt={ck}",
                     f"out={out}", "index=1", "quant=pq",
                     "device=cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_art = jart.load_artifact(out)
    assert jax_art.fingerprint == res["fingerprint"]
    assert jax_art.manifold_spec[0] == "product"
    table = restore_params_only(ck)[0]["params"]["table"].numpy()
    np.testing.assert_array_equal(jax_art.table, table)
    ids = [0, 5, 17]
    for precision in ("f32", "pq"):
        got = cli.run_query(cli.ServeConfig(
            artifact=out, device="cpu", precision=precision,
            ids=",".join(map(str, ids)), k=5))
        jeng = JaxEngine.from_artifact(jax_art, precision=precision)
        want_i, want_d = jeng.topk_neighbors(np.asarray(ids, np.int32), 5)
        assert got["neighbors"] == np.asarray(want_i).tolist()
        np.testing.assert_allclose(got["dists"], np.asarray(want_d), **ETOL)

"""The port's multi-tenant serving (``serve/registry.py``,
``collator.FairDispatcher``, the door's tenant routing) against the JAX
package's.

- ``FairDispatcher``: the same scripted queue of jobs, costs and weights
  dispatches in JAX's order (an executor that runs each job at once).
- ``EngineRegistry`` over artifacts the JAX package exports (96 × 8
  ball rows each), behind each package's door: routing by name, by
  fingerprint and by default answers as the tenant's solo engine
  (bitwise for the port's own; JAX's within rtol 1e-5, atol 1e-4, the
  serving tier); an unknown tenant answers 404 ``unknown_tenant``;
  ``?tenant=`` narrows ``/v1/stats`` and ``/healthz``; ``/metrics``
  carries the same tenant-labelled families.
- Under a budget that holds one engine (1.25 × each package's own
  ``engine_device_bytes``), the same request sequence gives every tenant
  JAX's admissions, evictions and residency, and the port's answers stay
  bitwise its solo engine's across paging.
- ``SloWindow.for_tenant`` reads JAX's series names.
"""

import asyncio
from concurrent.futures import Executor, Future

import numpy as np
import pytest

from hyperspace_tpu.serve import artifact as jart
from hyperspace_tpu.serve import collator as jcoll
from hyperspace_tpu.serve import registry as jreg
from hyperspace_tpu.serve import server as jserver
from hyperspace_tpu.telemetry import window as jwin
from hyperspace_torch.serve import collator as tcoll
from hyperspace_torch.serve import registry as treg
from hyperspace_torch.serve import server as tserver
from hyperspace_torch.serve.artifact import load_artifact
from hyperspace_torch.serve.engine import QueryEngine
from hyperspace_torch.telemetry import window as twin
from tests.test_torch_front_door import _http
from tests.test_torch_serve import C, make_table

N, K = 96, 4
IDS = [0, 3, 11, 29]
RTOL, ATOL = 1e-5, 1e-4
BATCHER_KW = dict(min_bucket=4, max_bucket=8, cache_size=0)


class _Inline(Executor):
    """Runs each submitted job at once, on the caller's thread."""

    def submit(self, fn, *args, **kwargs):
        fut = Future()
        fut.set_result(fn(*args, **kwargs))
        return fut


def _drr_order(mod, weights, jobs, quantum):
    order = []

    async def run():
        loop = asyncio.get_running_loop()
        disp = mod.FairDispatcher(_Inline(), weights=weights,
                                  quantum=quantum)
        futs = [disp.submit(loop, tenant, cost,
                            lambda t=tag: order.append(t))
                for tenant, cost, tag in jobs]
        await asyncio.gather(*futs)
        return disp.pending(), dict(disp._deficit)

    return order, asyncio.run(run())


@pytest.mark.parametrize("quantum", [1, 8])
def test_fair_dispatch_order_matches_jax(quantum):
    rng = np.random.default_rng(quantum)
    jobs = [(str(rng.choice(["a", "b", "c"])), int(rng.integers(1, 40)),
             f"j{i}") for i in range(40)]
    weights = {"a": 3.0, "b": 1.0, "c": 0.5}
    got = _drr_order(tcoll, weights, jobs, quantum)
    want = _drr_order(jcoll, weights, jobs, quantum)
    assert got == want
    assert len(got[0]) == 40 and got[1][0] == {}


def test_slo_window_for_tenant_names_match_jax():
    t, j = twin.SloWindow.for_tenant("en", 5.0), jwin.SloWindow.for_tenant(
        "en", 5.0)
    assert (t.hist_names, t.counter_names) == (j.hist_names, j.counter_names)
    assert t.window_s == j.window_s == 5.0


def _art(root, name, seed):
    path = str(root / name)
    jart.export_artifact(path, make_table("poincare", N, seed=seed)[:, :8],
                         ("poincare", C))
    return path


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    root = tmp_path_factory.mktemp("tenants")
    return {name: _art(root, name, seed)
            for seed, name in enumerate(("ta", "tb", "tc"))}


def _budget_mb(mod, engine) -> float:
    return mod.engine_device_bytes(engine) * 1.25 / (1 << 20)


def _registry(mod, arts, names, *, budget_mb=0.0, window_s=0.0):
    reg = mod.EngineRegistry(device_budget_mb=budget_mb, max_wait_us=500)
    ekw = {"device": "cpu"} if mod is treg else {}
    for name in names:
        reg.add_tenant(name, arts[name], window_s=window_s,
                       engine_kw=dict(ekw), batcher_kw=dict(BATCHER_KW))
    return reg


def _serve(server_mod, reg, go):
    async def run():
        door = server_mod.HttpFrontDoor(registry=reg)
        await door.start()
        try:
            return await go(door)
        finally:
            await door.drain()

    return asyncio.run(run())


def _solo(path):
    eng = QueryEngine.from_artifact(load_artifact(path), device="cpu")
    i, d = eng.topk_neighbors(np.asarray(IDS, np.int32), K)
    return i.numpy(), d.numpy()


def _answers_equal(tbody, jbody, solo):
    ti, td = np.asarray(tbody["neighbors"]), np.asarray(tbody["dists"],
                                                         np.float32)
    np.testing.assert_array_equal(ti, solo[0])
    np.testing.assert_array_equal(td.view(np.uint32), solo[1].view(np.uint32))
    np.testing.assert_array_equal(ti, np.asarray(jbody["neighbors"]))
    np.testing.assert_allclose(td, np.asarray(jbody["dists"]), rtol=RTOL,
                               atol=ATOL)


def test_routing_by_name_fingerprint_and_default(arts):
    fp_b = load_artifact(arts["tb"]).fingerprint

    async def go(door):
        topk = "/v1/topk"
        out = [await _http(door, "POST", topk, {"ids": IDS, "k": K}),
               await _http(door, "POST", topk,
                           {"ids": IDS, "k": K, "tenant": "tb"}),
               await _http(door, "POST", topk,
                           {"ids": IDS, "k": K, "tenant": fp_b}),
               await _http(door, "POST", topk,
                           {"ids": IDS, "k": K, "tenant": "nobody"}),
               await _http(door, "POST", topk,
                           {"ids": IDS, "k": K, "tenant": 7}),
               await _http(door, "GET", "/v1/stats?tenant=tb"),
               await _http(door, "GET", "/v1/stats?tenant=nobody"),
               await _http(door, "GET", "/healthz?tenant=" + fp_b),
               await _http(door, "GET", "/healthz"),
               await _http(door, "GET", "/v1/stats"),
               await _http(door, "GET", "/metrics")]
        return out

    jo = _serve(jserver, _registry(jreg, arts, ["ta", "tb"], window_s=5.0),
                go)
    to = _serve(tserver, _registry(treg, arts, ["ta", "tb"], window_s=5.0),
                go)
    assert [s for s, _, _ in to] == [s for s, _, _ in jo] == [
        200, 200, 200, 404, 400, 200, 404, 200, 200, 200, 200]
    for i, name in ((0, "ta"), (1, "tb"), (2, "tb")):
        _answers_equal(to[i][1], jo[i][1], _solo(arts[name]))
    assert to[3][1]["error"]["kind"] == jo[3][1]["error"]["kind"] == \
        "unknown_tenant"
    assert to[6][1]["error"]["kind"] == "unknown_tenant"
    st_t, st_j = to[5][1], jo[5][1]
    assert st_t["tenant"] == st_j["tenant"] == "tb"
    assert set(st_t["registry"]) == set(st_j["registry"])
    assert st_t["window"]["rate_qps"] > 0 and st_j["window"]["rate_qps"] > 0
    for key in ("tenant", "fingerprint", "resident", "scan_signature"):
        assert to[7][1][key] == jo[7][1][key]
    assert set(to[8][1]) == set(jo[8][1])
    assert [s["tenant"] for s in to[8][1]["tenants"]] == ["ta", "tb"]
    assert set(to[9][1]["tenants"]) == set(jo[9][1]["tenants"])

    def tenant_families(raw):
        return {line.split("{")[0] for line in raw.decode().splitlines()
                if 'tenant="tb"' in line and not line.startswith("#")}

    fam = tenant_families(to[10][2])
    assert fam == tenant_families(jo[10][2])
    assert {"hyperspace_serve_requests", "hyperspace_serve_e2e_ms_count",
            "hyperspace_serve_fair_dispatches"} <= fam


def test_paging_counts_match_jax_under_a_one_engine_budget(arts):
    eng = QueryEngine.from_artifact(load_artifact(arts["ta"]), device="cpu")
    from hyperspace_tpu.serve.engine import QueryEngine as JEngine
    from hyperspace_tpu.serve.artifact import load_artifact as jload

    jeng = JEngine.from_artifact(jload(arts["ta"]))
    seq = ["tc", "ta", "ta", "tb", "tc", "ta", "tb"]

    async def go(door):
        out = []
        for name in seq:
            out.append(await _http(door, "POST", "/v1/topk",
                                   {"ids": IDS, "k": K, "tenant": name}))
        out.append(await _http(door, "GET", "/v1/stats"))
        return out

    jo = _serve(jserver, _registry(jreg, arts, ["ta", "tb", "tc"],
                                   budget_mb=_budget_mb(jreg, jeng)), go)
    to = _serve(tserver, _registry(treg, arts, ["ta", "tb", "tc"],
                                   budget_mb=_budget_mb(treg, eng)), go)
    for (ts, tb, _), (js, jb, _), name in zip(to, jo, seq):
        assert ts == js == 200
        _answers_equal(tb, jb, _solo(arts[name]))

    def blocks(stats):
        return {name: {k: s["registry"][k] for k in (
            "resident", "admissions", "evictions")}
            for name, s in stats["tenants"].items()}

    got, want = blocks(to[-1][1]), blocks(jo[-1][1])
    assert got == want
    assert sum(b["admissions"] for b in got.values()) >= 4
    assert sum(b["resident"] for b in got.values()) == 1


def test_concurrent_admissions_coalesce(arts):
    reg = _registry(treg, arts, ["ta", "tb"])
    try:
        b = reg.resolve("tb")
        reg._evict(b)
        assert b.batcher.engine is None

        async def run():
            await asyncio.gather(*(reg.ensure_resident(b)
                                   for _ in range(4)))

        asyncio.run(run())
        assert b.resident and b.admissions == 1 and b.admit_future is None
        i, d = b.batcher.topk(IDS, K)
        solo = _solo(arts["tb"])
        np.testing.assert_array_equal(i, solo[0])
        np.testing.assert_array_equal(d, solo[1])
    finally:
        reg.close()


def test_engine_device_bytes_counts_each_storage_once(arts):
    art = load_artifact(arts["ta"])
    f32 = QueryEngine.from_artifact(art, device="cpu")
    assert f32.scan_table is f32.table
    want = sum(t.untyped_storage().nbytes() for t in (f32.table, f32._cols))
    assert treg.engine_device_bytes(f32) == want
    # a view of the table is a new object on the same storage
    f32.scan_table = f32.table[:10]
    assert treg.engine_device_bytes(f32) == want
    bf16 = QueryEngine.from_artifact(art, precision="bf16", device="cpu")
    assert treg.engine_device_bytes(bf16) == want + \
        bf16.scan_table.untyped_storage().nbytes()

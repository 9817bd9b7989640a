"""The port's serve CLI beyond one-shot queries: ``export`` from the
port's own checkpoint, ``serve-http`` in-process, the stdin loop's
lifecycle keys against the JAX CLI's record shapes, and the keys that
are not ported.

- ``export`` from a checkpoint the port's ``poincare`` CLI wrote gives
  the artifact ``export_artifact`` writes for the restored table, with
  its IVF index and PQ payload; the fingerprint is the JAX package's
  ``fingerprint_of`` for that table, and JAX loads the artifact.
- ``serve-http`` answers every route on an ephemeral port and drains.
- The stdin loop with ``deadline_ms``, ``queue_max``, ``access_log``,
  ``window_s`` and ``log`` writes JAX's access-record, window and
  session-record shapes (the same keys, the same value types).
- ``tenants=`` (inline or a file, with ``device_budget_mb``) serves
  every roster entry behind one door; bad rosters, ``tenants=`` with
  ``artifact=`` or ``live=1``, and bad ``live=1`` options exit with the
  JAX CLI's messages.
"""

import http.client
import io
import json
import threading

import numpy as np
import pytest

from hyperspace_tpu.cli import serve as jcli
from hyperspace_tpu.serve import artifact as jart
from hyperspace_torch.cli import serve as tcli
from hyperspace_torch.cli import train as ttrain
from hyperspace_torch.resilience import faults
from hyperspace_torch.serve import artifact as tart
from hyperspace_torch.serve.index import auto_ncells, build_index
from hyperspace_torch.train.checkpoint import restore_params_only
from tests.test_torch_serve import C, make_table

SPEC = ("poincare", 1.0)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port checkpoint of the poincare CLI (1,365-node tree, 10-dim)."""
    ck = str(tmp_path_factory.mktemp("pe") / "ck")
    assert ttrain.main(["poincare", "device=cpu", "steps=40",
                        f"ckpt_dir={ck}", "ckpt_every=20",
                        "batch_size=64"]) == 0
    return ck


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("art") / "a")
    jart.export_artifact(path, make_table("poincare", 600, seed=4),
                         ("poincare", C))
    return path


def _export(capsys, argv) -> dict:
    assert tcli.main(["export", *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_export_from_port_checkpoint_matches_export_artifact(
        trained, tmp_path, capsys):
    out = str(tmp_path / "art")
    res = _export(capsys, [f"ckpt={trained}", f"out={out}", "c=1.0",
                           "index=1", "quant=pq", "device=cpu"])
    tree, step = restore_params_only(trained)
    table = tree["table"].numpy()
    assert res["step"] == step == 40 and res["num_nodes"] == 1365
    index = build_index(table, SPEC, auto_ncells(table.shape[0]),
                        device="cpu")
    quant = tart.build_quant_payload(table, SPEC, "pq")
    want = tart.export_artifact(str(tmp_path / "ref"), table, SPEC,
                                model_config={"c": 1.0}, step=step,
                                index=index, quant=quant)
    got = tart.load_artifact(out)
    assert got.fingerprint == res["fingerprint"] == want.fingerprint
    np.testing.assert_array_equal(got.table, table)
    assert res["index"]["fingerprint"] == index.fingerprint
    assert res["quant"] == {"lane": "pq", "fingerprint": quant.fingerprint}
    # the JAX package's fingerprint of that table, index and payload,
    # and JAX loads the artifact the port wrote
    assert jart.fingerprint_of(table, SPEC, index.fingerprint,
                               quant.fingerprint) == got.fingerprint
    assert jart.load_artifact(out).fingerprint == got.fingerprint
    # plain export: JAX's fingerprint_of for the restored table
    plain = _export(capsys, [f"ckpt={trained}", f"out={tmp_path / 'p'}",
                             "c=1.0", "step=20", "device=cpu"])
    t20 = restore_params_only(trained, step=20)[0]["table"].numpy()
    assert plain["step"] == 20
    assert plain["fingerprint"] == jart.fingerprint_of(t20, SPEC)


@pytest.mark.parametrize("argv,match", [
    (["c=1.0"], "needs ckpt= and out="),
    (["ckpt={ck}", "out={out}"], "requires c="),
    (["ckpt={ck}", "out={out}", "c=x"], "want a float"),
    (["ckpt={ck}", "out={out}", "c=1", "quant=int8"], "want int4 or pq"),
    (["ckpt={ck}", "out={out}", "workload=product", "factors=[[1"],
     "want JSON"),
    (["ckpt={ck}", "out={out}", "c=1", "ncells=-2"], "ncells"),
    (["ckpt={ck}", "out={out}", "c=1", "workload=hgcn"], "unknown workload"),
    (["ckpt={ck}/none", "out={out}", "c=1"], "no committed checkpoint"),
])
def test_export_usage_errors(trained, tmp_path, argv, match):
    argv = [a.format(ck=trained, out=tmp_path / "o") for a in argv]
    with pytest.raises(SystemExit, match=match):
        tcli.main(["export", "device=cpu", *argv])


def _get(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request(method, path, body=None if body is None
                 else json.dumps(body))
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def test_serve_http_in_process_answers_and_drains(artifact):
    """``run_serve_http`` on a thread: ``ready`` hands the bound door,
    every route answers, and a drain ends the run with its closing
    stats."""
    import asyncio

    got = {}
    up = threading.Event()

    def ready(door):
        got["door"] = door
        up.set()

    def run():
        got["result"] = tcli.run_serve_http(
            tcli.ServeConfig(artifact=artifact, device="cpu", port=0,
                             prewarm="3", k=3, max_bucket=64),
            ready=ready)

    t = threading.Thread(target=run)
    t.start()
    assert up.wait(60)
    port = got["door"].port
    s, b = _get(port, "POST", "/v1/topk", {"ids": [1, 2], "k": 3})
    assert s == 200 and len(json.loads(b)["neighbors"]) == 2
    assert _get(port, "POST", "/v1/score", {"u": [1], "v": [2]})[0] == 200
    s, b = _get(port, "GET", "/v1/stats")
    st = json.loads(b)
    assert s == 200 and st["prewarmed"] >= 8 and "kernel_builds" in st
    assert _get(port, "GET", "/healthz")[0] == 200
    s, b = _get(port, "GET", "/metrics")
    assert s == 200 and b"hyperspace_serve_requests" in b
    asyncio.run_coroutine_threadsafe(got["door"].drain(),
                                     got["door"].loop).result(30)
    t.join(30)
    res = got["result"]
    assert res["mode"] == "serve_http" and res["drained"]
    assert res["served"] == 5 and res["aborted_connections"] == 0


def test_serve_http_without_cuda_exits_before_binding(artifact, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tcli.main(["serve-http", f"artifact={artifact}", "port=0"])


def _record_shape(rec) -> dict:
    """Key → type name, nested one level (dict values by their keys)."""
    out = {}
    for k, v in rec.items():
        if isinstance(v, dict):
            out[k] = ("dict", tuple(sorted(v)))
        else:
            out[k] = type(v).__name__
    return out


LOOP = [
    {"op": "topk", "ids": [0, 1, 2], "k": 5, "request_id": "a"},
    {"op": "topk", "ids": [0, 1], "k": 5, "deadline_ms": 10000},
    {"op": "score", "u": [0, 1], "v": [2, 3]},
    "not json",
    {"op": "topk", "ids": [0.5], "k": 3},
    {"op": "bogus"},
    {"op": "upsert", "ids": [3], "rows": [[0.0] * 10]},
    {"op": "topk", "ids": [1], "k": 2, "deadline_ms": -1},
    {"op": "stats"},
]


def _renamed(keys: set) -> set:
    """JAX's stats keys with ``recompiles`` read as ``kernel_builds``,
    beside which the port reports ``kernel_loads`` and
    ``cold_dispatches``."""
    if "recompiles" not in keys:
        return keys
    return (keys - {"recompiles"}) | {"kernel_builds", "kernel_loads",
                                      "cold_dispatches"}


def _run_loop(cli, artifact, tmp_path, tag, **extra):
    acc = tmp_path / f"{tag}_access.jsonl"
    log = tmp_path / f"{tag}_session.jsonl"
    text = "\n".join(x if isinstance(x, str) else json.dumps(x)
                     for x in LOOP) + "\n"
    out = io.StringIO()
    closing = cli.run_serve(cli.ServeConfig(
        artifact=artifact, deadline_ms=5000.0, queue_max=4,
        access_log=str(acc), window_s=30.0, log=str(log), **extra),
        stdin=io.StringIO(text), stdout=out)
    resp = [json.loads(s) for s in out.getvalue().splitlines()]
    recs = [json.loads(s) for s in acc.read_text().splitlines()]
    session = [json.loads(s) for s in log.read_text().splitlines()]
    return closing, resp, recs, session


def test_stdin_loop_writes_jax_record_shapes(artifact, tmp_path):
    jc, jr, ja, js = _run_loop(jcli, artifact, tmp_path, "jax")
    tc, tr, ta, ts = _run_loop(tcli, artifact, tmp_path, "port",
                               device="cpu")
    assert len(tr) == len(jr) == len(LOOP)
    for t, j in zip(tr, jr):
        assert set(t) == _renamed(set(j))
        if "error" in j:
            assert t["error"]["kind"] == j["error"]["kind"]
    # one access record per request, JAX's keys and types, same outcomes
    assert len(ta) == len(ja) == len(LOOP) - 1      # stats is not logged
    for t, j in zip(ta, ja):
        tt, jj = _record_shape(t), _record_shape(j)
        assert tt == jj
        assert (t["route"], t["outcome"]) == (j["route"], j["outcome"])
        assert t["request_id"] and len(t["request_id"]) == 16 or \
            t["request_id"] == "a"
    # the stats op and the closing stats carry the window block
    for t, j in ((tr[-1], jr[-1]), (tc, jc)):
        assert set(t["window"]) == set(j["window"])
        assert set(t["window"]["e2e_ms"]) == set(j["window"]["e2e_ms"])
        assert t["queue_max"] == j["queue_max"] == 4
    assert set(tc) == _renamed(set(jc))
    # the session log: run_manifest first, telemetry_summary last
    assert [r["event"] for r in ts] == [r["event"] for r in js] == [
        "run_manifest", "telemetry_summary"]
    assert set(ts[0]) == set(js[0])
    assert set(ts[0]["config"]) - set(js[0]["config"]) == {"device"}
    for key in ("ctr/serve/requests", "ctr/serve/errors",
                "ctr/serve/cache_miss", "hist/serve/e2e_ms"):
        assert ts[1][key] == js[1][key] or key.startswith("hist/")
    assert ts[1]["ctr/serve/requests"] == 5


def test_stdin_loop_deadline_and_chaos(artifact, tmp_path, capsys):
    """The port's ``serve.dispatch`` site through ``chaos=``: an armed
    latency 10× the deadline answers ``deadline_exceeded``, an armed
    ioerror answers ``internal``, and the loop keeps serving; the run's
    chaos stats ride the closing line."""
    lines = [{"op": "topk", "ids": [5], "k": 3, "deadline_ms": 30},
             {"op": "topk", "ids": [6], "k": 3},
             {"op": "topk", "ids": [7], "k": 3}]
    stdin = io.StringIO("\n".join(json.dumps(x) for x in lines) + "\n")
    import sys

    monkey_in = sys.stdin
    sys.stdin = stdin
    try:
        assert tcli.main([
            "serve", f"artifact={artifact}", "device=cpu",
            "chaos=serve.dispatch:latency:ms=300:times=1,"
            "serve.dispatch:ioerror:times=1"]) == 0
    finally:
        sys.stdin = monkey_in
    cap = capsys.readouterr()
    resp = [json.loads(s) for s in cap.out.splitlines()]
    assert [r.get("error", {}).get("kind") for r in resp] == [
        "deadline_exceeded", "internal", None]
    closing = json.loads(cap.err.strip().splitlines()[-1])
    assert closing["chaos"]["fired"] == 2 and closing["deadline_exceeded"] >= 1
    assert not faults.active()


NOT_PORTED_VALUES = {"mesh": "-1", "compile_cache_dir": "/tmp/x"}


@pytest.mark.parametrize("key", sorted(NOT_PORTED_VALUES))
@pytest.mark.parametrize("mode", ["serve", "serve-http"])
def test_unported_keys_exit_naming_themselves(artifact, key, mode):
    assert set(NOT_PORTED_VALUES) == set(tcli.NOT_PORTED)
    with pytest.raises(SystemExit, match=f"{key}=.*not ported"):
        tcli.main([mode, f"artifact={artifact}", "device=cpu",
                   f"{key}={NOT_PORTED_VALUES[key]}"])


def test_serve_keys_are_jax_keys():
    """Every JAX serve key is a port key with JAX's default (the port
    adds ``device``)."""
    import dataclasses

    jdef, tdef = jcli.ServeConfig(), tcli.ServeConfig()
    for f in dataclasses.fields(jcli.ServeConfig):
        assert getattr(tdef, f.name) == getattr(jdef, f.name), f.name
    assert {f.name for f in dataclasses.fields(tcli.ServeConfig)} - {
        f.name for f in dataclasses.fields(jcli.ServeConfig)} == {"device"}


def _roster(artifact, n=2, **extra):
    return json.dumps([{"name": f"t{i}", "artifact": artifact, **extra}
                       for i in range(n)])


BAD_SERVE = {
    "tenants_with_artifact": lambda a: ["serve-http", f"artifact={a}",
                                        f"tenants={_roster(a)}"],
    "tenants_with_live": lambda a: ["serve-http", "live=1",
                                    f"tenants={_roster(a)}"],
    "roster_not_json": lambda a: ["serve-http", "tenants=[{nope"],
    "roster_empty": lambda a: ["serve-http", "tenants=[]"],
    "roster_not_objects": lambda a: ["serve-http", "tenants=[1, 2]"],
    "roster_no_artifact": lambda a: ["serve-http",
                                     'tenants=[{"name": "t0"}]'],
    "roster_unknown_field": lambda a: [
        "serve-http", f"tenants={_roster(a, 1, color=1)}"],
    "roster_duplicate": lambda a: [
        "serve-http", "tenants=" + json.dumps(
            [{"name": "t", "artifact": a}, {"name": "t", "artifact": a}])],
    "roster_zero_weight": lambda a: ["serve-http",
                                      f"tenants={_roster(a, 1, weight=0)}"],
    "live_fused": lambda a: ["serve", f"artifact={a}", "live=1",
                             "scan_mode=fused"],
    "live_zero_cap": lambda a: ["serve", f"artifact={a}", "live=1",
                                "delta_cap=0"],
    "live_bad_compact_at": lambda a: ["serve", f"artifact={a}", "live=1",
                                      "compact_at=1.5"],
}


@pytest.mark.parametrize("case", sorted(BAD_SERVE))
def test_bad_tenant_and_live_options_exit_as_jax(artifact, case):
    argv = BAD_SERVE[case](artifact)
    with pytest.raises(SystemExit) as je:
        jcli.main(argv)
    with pytest.raises(SystemExit) as te:
        tcli.main(argv + ["device=cpu"])
    assert str(te.value) == str(je.value) != ""


@pytest.mark.parametrize("source", ["inline", "file"])
def test_serve_http_tenants_route_and_page(artifact, tmp_path, source):
    """Two tenants over one artifact (fingerprint routing picks the first
    with it), a budget of one engine: each answers its solo engine's
    rows, an unknown tenant 404s, and every switch pages."""
    import asyncio

    from hyperspace_torch.serve import QueryEngine, load_artifact
    from hyperspace_torch.serve.registry import engine_device_bytes

    solo = QueryEngine.from_artifact(load_artifact(artifact), device="cpu")
    budget = engine_device_bytes(solo) * 1.25 / (1 << 20)
    roster = _roster(artifact)
    if source == "file":
        path = tmp_path / "roster.json"
        path.write_text(roster)
        roster = str(path)
    got, up = {}, threading.Event()

    def ready(door):
        got["door"] = door
        up.set()

    t = threading.Thread(target=lambda: got.update(
        result=tcli.run_serve_http(tcli.ServeConfig(
            tenants=roster, device="cpu", port=0, k=3,
            device_budget_mb=budget), ready=ready)), daemon=True)
    t.start()
    assert up.wait(60)
    port = got["door"].port
    try:
        want = solo.topk_neighbors(np.asarray([1, 2], np.int32), 3)[0]
        for tenant in ("t0", "t1", "t0", None):
            body = {"ids": [1, 2], "k": 3}
            if tenant:
                body["tenant"] = tenant
            s, b = _get(port, "POST", "/v1/topk", body)
            assert s == 200 and json.loads(b)["neighbors"] == want.tolist()
        s, b = _get(port, "POST", "/v1/topk",
                    {"ids": [1], "k": 3, "tenant": "t9"})
        assert s == 404 and json.loads(b)["error"]["kind"] == \
            "unknown_tenant"
        s, b = _get(port, "GET", "/v1/stats?tenant=t1")
        assert s == 200 and json.loads(b)["tenant"] == "t1"
    finally:
        asyncio.run_coroutine_threadsafe(got["door"].drain(),
                                         got["door"].loop).result(30)
        t.join(30)
    res = got["result"]
    assert res["drained"] and set(res["tenants"]) == {"t0", "t1"}
    reg = {n: v["registry"] for n, v in res["tenants"].items()}
    assert reg["t0"]["admissions"] == 2 and reg["t1"]["admissions"] == 1
    assert reg["t0"]["evictions"] == reg["t1"]["evictions"] == 2

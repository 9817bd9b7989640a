"""The port's blue-green rollover (``serve/rollover.py``) against the JAX
package's: ``standby_health`` gives JAX's body for the same artifact,
``gate_flip`` refuses the same bodies with JAX's messages, and a door's
``POST /admin/rollover`` flips onto a second artifact with JAX's report
keys and statuses; after the flip both doors answer from the new
artifact (ids equal, distances within rtol 1e-5, atol 1e-4, the serving
tier) and a bad target answers as JAX's does.  The serve CLI's
``serve-http`` arms the same route with its artifact builder."""

import asyncio
import http.client
import json
import threading

import numpy as np
import pytest

from hyperspace_tpu.serve import artifact as jart
from hyperspace_tpu.serve import rollover as jroll
from hyperspace_tpu.serve.batcher import RequestBatcher as JBatcher
from hyperspace_tpu.serve.engine import QueryEngine as JEngine
from hyperspace_tpu.serve.server import HttpFrontDoor as JDoor
from hyperspace_torch.cli import serve as tcli
from hyperspace_torch.serve import rollover as troll
from hyperspace_torch.serve.artifact import load_artifact
from hyperspace_torch.serve.batcher import RequestBatcher as TBatcher
from hyperspace_torch.serve.engine import QueryEngine as TEngine
from hyperspace_torch.serve.server import HttpFrontDoor as TDoor
from tests.test_torch_front_door import _http
from tests.test_torch_serve import C, make_table

N, K = 300, 4
IDS = [1, 7, 40, 99]
RTOL, ATOL = 1e-5, 1e-4
BKW = dict(min_bucket=4, max_bucket=8, cache_size=64)


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    root = tmp_path_factory.mktemp("roll")
    out = {}
    for seed, name in enumerate(("blue", "green")):
        out[name] = str(root / name)
        jart.export_artifact(out[name], make_table("poincare", N, seed=seed),
                             ("poincare", C))
    return out


def _jbatcher(path):
    return JBatcher(JEngine.from_artifact(jart.load_artifact(path)), **BKW)


def _tbatcher(path):
    return TBatcher(TEngine.from_artifact(load_artifact(path),
                                          device="cpu"), **BKW)


def test_standby_health_and_gate_match_jax(arts):
    tb = troll.standby_health(_tbatcher(arts["blue"]))
    jb = jroll.standby_health(_jbatcher(arts["blue"]))
    assert tb == jb
    assert troll.GATE_FIELDS == jroll.GATE_FIELDS
    troll.gate_flip(tb)
    bad = [dict(jb, ok=False), dict(jb, degrade_level=2)]
    for f in jroll.GATE_FIELDS:
        body = dict(jb)
        del body[f]
        bad.append(body)
    for body in bad:
        with pytest.raises(ValueError) as te:
            troll.gate_flip(body)
        with pytest.raises(ValueError) as je:
            jroll.gate_flip(body)
        assert str(te.value) == str(je.value)


def _roll(door_cls, coord_cls, batcher_of, arts):
    async def run():
        door = door_cls(batcher_of(arts["blue"]), max_wait_us=500)
        door.rollover = coord_cls(door, batcher_of, prewarm_ks=(K,))
        await door.start()
        try:
            topk = {"ids": IDS, "k": K}
            return [await _http(door, "POST", "/v1/topk", topk),
                    await _http(door, "POST", "/admin/rollover",
                                {"target": arts["green"]}),
                    await _http(door, "POST", "/v1/topk", topk),
                    await _http(door, "GET", "/healthz"),
                    await _http(door, "POST", "/admin/rollover",
                                {"target": 5}),
                    await _http(door, "POST", "/admin/rollover",
                                {"target": arts["green"] + "_missing"})]
        finally:
            await door.drain()

    return asyncio.run(run())


def test_admin_rollover_flips_like_jax(arts):
    jo = _roll(JDoor, jroll.RolloverCoordinator, _jbatcher, arts)
    to = _roll(TDoor, troll.RolloverCoordinator, _tbatcher, arts)
    assert [s for s, _, _ in to] == [s for s, _, _ in jo]
    assert [s for s, _, _ in to][:5] == [200, 200, 200, 200, 400]
    rep_t, rep_j = to[1][1], jo[1][1]
    assert set(rep_t) == set(rep_j)
    for key in ("flipped", "old_fingerprint", "new_fingerprint",
                "scan_signature", "prewarmed_programs"):
        assert rep_t[key] == rep_j[key]
    green = load_artifact(arts["green"]).fingerprint
    assert rep_t["new_fingerprint"] == green == to[3][1]["fingerprint"]
    for i in (0, 2):
        np.testing.assert_array_equal(to[i][1]["neighbors"],
                                      jo[i][1]["neighbors"])
        np.testing.assert_allclose(to[i][1]["dists"], jo[i][1]["dists"],
                                   rtol=RTOL, atol=ATOL)
    assert to[0][1]["neighbors"] != to[2][1]["neighbors"]
    assert to[5][1]["error"]["kind"] == jo[5][1]["error"]["kind"]


def test_serve_http_cli_arms_rollover(arts):
    got = {}
    up = threading.Event()

    def ready(door):
        got["door"] = door
        up.set()

    t = threading.Thread(target=lambda: got.update(
        result=tcli.run_serve_http(tcli.ServeConfig(
            artifact=arts["blue"], device="cpu", port=0, prewarm="4",
            k=4, min_bucket=4, max_bucket=8), ready=ready)), daemon=True)
    t.start()
    assert up.wait(60)
    door = got["door"]
    try:
        _cli_rollover(door, arts)
    finally:
        asyncio.run_coroutine_threadsafe(door.drain(), door.loop).result(30)
        t.join(30)
    assert not t.is_alive() and got["result"]["drained"]


def _cli_rollover(door, arts):
    def post(path, body):
        conn = http.client.HTTPConnection("127.0.0.1", door.port, timeout=60)
        conn.request("POST", path, json.dumps(body))
        r = conn.getresponse()
        out = r.status, json.loads(r.read())
        conn.close()
        return out

    s, rep = post("/admin/rollover", {"target": arts["green"]})
    assert s == 200 and rep["flipped"] and rep["prewarmed_programs"] >= 4
    s, bad = post("/admin/rollover", {"target": arts["green"] + "_nope"})
    assert s in (400, 500) and "error" in bad
    s, body = post("/v1/topk", {"ids": IDS, "k": K})
    eng = TEngine.from_artifact(load_artifact(arts["green"]), device="cpu")
    i, d = eng.topk_neighbors(np.asarray(IDS, np.int32), K)
    assert s == 200 and body["neighbors"] == i.tolist()
    assert body["dists"] == d.tolist()

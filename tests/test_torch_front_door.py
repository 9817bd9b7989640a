"""The port's HTTP front door against the JAX package's.

Both doors start over the same 2,048-row Poincaré table (numpy, from a
seed), each prewarmed, and take the same requests over real sockets:

- ``/v1/topk`` neighbours equal and distances within rtol 1e-5, atol
  1e-4 (the serving tier: the port's plain PyTorch scan and JAX's
  XLA program sum in different orders); ``/v1/score`` likewise where
  f32 keeps the distance at that tier, and everywhere no further from
  the float64 distance than JAX's answer is, plus the tier;
- ``/v1/stats`` and ``/healthz`` have JAX's keys, ``kernel_builds`` in
  place of ``recompiles`` and ``kernel_loads`` and ``cold_dispatches``
  beside it;
- prewarm takes every first launch at a shape: traffic after it counts
  no ``cold_dispatches``, traffic without it does;
- status codes and error kinds are equal for bad JSON, bad ids, a k too
  large, a body past ``MAX_BODY_BYTES``, a wrong method and an unknown
  route;
- eight concurrent single-id requests under a long ``max_wait_us`` fill
  bucket 8 in one flush in both;
- 429 shedding is equal at ``queue_max=2``.

No wall-clock races: collation waits on exact fills, shedding on the
admission counter, and the port-only deadline and drain tests arm the
port's ``serve.dispatch`` latency at 10× the deadline.  JAX's
fault-armed tests fail on Python 3.12 (``faults.install``), so those
behaviours are held to their documented contract only.
"""

import asyncio
import json

import numpy as np
import pytest

from hyperspace_tpu.serve.batcher import RequestBatcher as JBatcher
from hyperspace_tpu.serve.engine import QueryEngine as JEngine
from hyperspace_tpu.serve.server import HttpFrontDoor as JDoor
from hyperspace_torch.kernels._support import topk_disagreements
from hyperspace_torch.resilience import faults
from hyperspace_torch.serve import server as tserver
from hyperspace_torch.serve.batcher import RequestBatcher as TBatcher
from hyperspace_torch.serve.engine import QueryEngine as TEngine
from hyperspace_torch.serve.server import HttpFrontDoor as TDoor
from hyperspace_torch.telemetry import registry as telem
from tests.test_torch_serve import C, make_table, self_noise

ROWS, DIM, K = 2048, 10, 4
RTOL, ATOL = 1e-5, 1e-4
SPEC = ("poincare", C)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def table():
    return make_table("poincare", ROWS, seed=20)


@pytest.fixture(scope="module")
def engines(table):
    """(JAX engine, port engine) over the same table, JAX's prewarmed
    for the buckets and k these tests use."""
    jeng = JEngine(table, SPEC)
    teng = TEngine(table, SPEC, device="cpu")
    JBatcher(jeng, min_bucket=8, max_bucket=64).prewarm([K])
    return jeng, teng


def _doors(engines, **kw):
    """A (JAX door, port door) pair with the same batcher knobs; the
    port's prewarmed on its dispatch thread."""
    jeng, teng = engines
    max_wait_us = kw.pop("max_wait_us", 2000)
    bkw = dict(min_bucket=8, max_bucket=64, cache_size=kw.pop("cache_size",
                                                               0), **kw)
    jd = JDoor(JBatcher(jeng, **bkw), max_wait_us=max_wait_us)
    td = TDoor(TBatcher(teng, **bkw), max_wait_us=max_wait_us)
    td.collator.prewarm([K])
    return jd, td


async def _http(door, method, path, payload=None, raw=None, headers=""):
    """(status, parsed body, raw bytes) of one HTTP round trip."""
    reader, writer = await asyncio.open_connection(door.host, door.port)
    body = (raw if raw is not None
            else b"" if payload is None else json.dumps(payload).encode())
    if headers:
        head = f"{method} {path} HTTP/1.1\r\n{headers}\r\n"
    else:
        head = (f"{method} {path} HTTP/1.1\r\nContent-Length: {len(body)}"
                "\r\nConnection: close\r\n\r\n")
    writer.write(head.encode() + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    clen = 0
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, val = h.decode().partition(":")
        if name.strip().lower() == "content-length":
            clen = int(val)
    data = await reader.readexactly(clen)
    writer.close()
    try:
        parsed = json.loads(data)
    except ValueError:
        parsed = None
    return status, parsed, data


def _both(engines, go, **kw):
    """Run ``go(door)`` against a started JAX door and a started port
    door; returns (jax result, port result)."""
    async def run(door):
        await door.start()
        try:
            return await go(door)
        finally:
            await door.drain()

    jd, td = _doors(engines, **kw)
    return asyncio.run(run(jd)), asyncio.run(run(td))


def _same_topk(t: dict, j: dict, ids=None, table=None) -> None:
    """Equal neighbours, distances at the serving tier.  With ``ids``
    (an ``exclude_self=False`` request) each query ranks itself first on
    both sides, at a distance within the Gram form's rounding noise at
    d = 0 (which differs between the two), and the rest is compared."""
    ti, td = np.asarray(t["neighbors"]), np.asarray(t["dists"], np.float64)
    ji, jd = np.asarray(j["neighbors"]), np.asarray(j["dists"], np.float64)
    assert ti.shape == ji.shape
    if ids is not None:
        assert np.all(ti[:, 0] == ids) and np.all(ji[:, 0] == ids)
        noise = self_noise(table[ids], "poincare")
        assert np.all(td[:, 0] <= noise) and np.all(jd[:, 0] <= noise)
        ti, td, ji, jd = (a[:, 1:] for a in (ti, td, ji, jd))
    assert topk_disagreements(ti, td, ji, jd, rtol=RTOL, atol=ATOL) == 0
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)


def artanh_conditioning(d: np.ndarray) -> np.ndarray:
    """The f32 error a ball distance d = (2/√c)·artanh(z) inherits from
    its argument z = tanh(√c·d/2) rounded over ~8 f32 operations:
    |Δd| ≈ (2/√c)·Δz/(1 − z²) = 16·2^-24·cosh²(√c·d/2)/√c.  Far pairs
    near the rim (d ≈ 8: about 1e-3) can part beyond the serving tier on
    either side of the comparison."""
    d = np.asarray(d, np.float64)
    return 16.0 * 2.0 ** -24 * np.cosh(np.sqrt(C) * d / 2) ** 2 / np.sqrt(C)


def ball_dist_f64(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The Poincaré distance of the f32 rows in float64:
    arcosh(1 + 2c‖x − y‖² / ((1 − c‖x‖²)(1 − c‖y‖²))) / √c."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    num = 2 * C * np.sum((x - y) ** 2, -1)
    den = (1 - C * np.sum(x * x, -1)) * (1 - C * np.sum(y * y, -1))
    return np.arccosh(1 + num / den) / np.sqrt(C)


REQUESTS = [
    {"ids": [0, 5, 2047], "k": K},
    {"ids": list(range(100, 140)), "k": K, "exclude_self": False},
    {"ids": [7, 7, 9], "k": K},
]


def test_topk_and_score_answers_match_jax(engines, table):
    rng = np.random.default_rng(3)
    u = rng.integers(0, ROWS, 37).tolist()
    v = rng.integers(0, ROWS, 37).tolist()

    async def go(door):
        out = [await _http(door, "POST", "/v1/topk", r) for r in REQUESTS]
        out.append(await _http(door, "POST", "/v1/score",
                               {"u": u, "v": v}))
        out.append(await _http(door, "POST", "/v1/score",
                               {"u": u[:5], "v": v[:5], "prob": True,
                                "fd_r": 1.5, "fd_t": 0.5}))
        return out

    jo, to = _both(engines, go)
    for req, (js, jb, _), (ts, tb, _) in zip(
            REQUESTS + [{}, {"prob": True}], jo, to):
        assert js == ts == 200
        assert set(tb) == set(jb)
        if "neighbors" in jb:
            own = (None if req.get("exclude_self", True)
                   else np.asarray(req["ids"]))
            _same_topk(tb, jb, own, table)
        elif "prob" in req:
            got, want = np.asarray(tb["scores"]), np.asarray(jb["scores"])
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        else:
            got, want = np.asarray(tb["scores"]), np.asarray(jb["scores"])
            ref = ball_dist_f64(table[u], table[v])
            tier = RTOL * np.abs(ref) + ATOL
            # the port no further from the true distance than JAX is
            assert np.all(np.abs(got - ref) <= np.abs(want - ref) + tier)
            # and, where f32 holds the distance at the tier, JAX's answer
            plain = artanh_conditioning(ref) <= ATOL
            assert plain.sum() >= 5
            np.testing.assert_allclose(got[plain], want[plain], rtol=RTOL,
                                       atol=ATOL)


def test_stats_healthz_metrics_keys_match_jax(engines):
    async def go(door):
        await _http(door, "POST", "/v1/topk", {"ids": [1], "k": K})
        return [await _http(door, "GET", "/v1/stats"),
                await _http(door, "POST", "/v1/stats"),
                await _http(door, "GET", "/healthz"),
                await _http(door, "GET", "/metrics")]

    jo, to = _both(engines, go, queue_max=8, deadline_ms=5000.0)
    for (js, jb, _), (ts, tb, _) in zip(jo[:2], to[:2]):
        assert js == ts == 200
        assert set(tb) == (set(jb) - {"recompiles"}) | {
            "kernel_builds", "kernel_loads", "cold_dispatches"}
        assert set(tb["server"]) == set(jb["server"])
        assert tb["queue_max"] == jb["queue_max"] == 8
        assert tb["degrade_mode"] == jb["degrade_mode"] == "full"
        assert tb["scan_strategy"] == jb["scan_strategy"] == "exact"
    (js, jb, _), (ts, tb, _) = jo[2], to[2]
    assert js == ts == 200 and set(tb) == set(jb) and tb["ok"]
    assert tb["fingerprint"] == jb["fingerprint"]   # same artifact bytes
    (js, _, jraw), (ts, _, traw) = jo[3], to[3]
    assert js == ts == 200
    for raw in (jraw, traw):
        assert b"# TYPE hyperspace_serve_requests counter" in raw
        assert b"hyperspace_serve_e2e_ms_bucket" in raw


BAD = [
    ("POST", "/v1/topk", None, b"{not json"),
    ("POST", "/v1/topk", [1, 2], None),
    ("POST", "/v1/topk", {"ids": [0.5], "k": K}, None),
    ("POST", "/v1/topk", {"ids": [ROWS], "k": K}, None),
    ("POST", "/v1/topk", {"ids": "7", "k": K}, None),
    ("POST", "/v1/topk", {"ids": [1], "k": ROWS + 5}, None),
    ("POST", "/v1/topk", {"ids": [1], "k": 2.0}, None),
    ("POST", "/v1/topk", {"ids": [1], "exclude_self": "no"}, None),
    ("POST", "/v1/topk", {"ids": [1], "deadline_ms": -3}, None),
    ("POST", "/v1/score", {"u": [0], "v": [1, 2]}, None),
    ("POST", "/v1/score", {"u": [0], "v": [1], "fd_r": "x"}, None),
    ("GET", "/v1/topk", None, None),
    ("PUT", "/v1/stats", None, None),
    ("POST", "/healthz", None, None),
    ("POST", "/metrics", None, None),
    ("GET", "/no/such/route", None, None),
    ("POST", "/v1/upsert", {"ids": [1], "rows": [[0.0] * DIM]}, None),
    ("POST", "/v1/delete", {"ids": [1]}, None),
    ("POST", "/admin/rollover", {"target": "/nowhere"}, None),
]


@pytest.mark.parametrize("case", range(len(BAD)))
def test_error_statuses_and_kinds_match_jax(engines, case):
    method, path, payload, raw = BAD[case]

    async def go(door):
        return await _http(door, method, path, payload, raw)

    (js, jb, _), (ts, tb, _) = _both(engines, go)
    assert ts == js and ts >= 400
    assert tb["error"]["kind"] == jb["error"]["kind"]


@pytest.mark.parametrize("head", [
    f"Content-Length: {tserver.MAX_BODY_BYTES + 1}\r\n",   # 413
    "Content-Length: nope\r\n",                              # 400
])
def test_framing_errors_match_jax(engines, head):
    async def go(door):
        return await _http(door, "POST", "/v1/topk", raw=b"",
                           headers=head)

    (js, jb, _), (ts, tb, _) = _both(engines, go)
    assert ts == js and tb["error"]["kind"] == jb["error"]["kind"]


def test_eight_concurrent_requests_fill_bucket_8_in_one_flush(engines):
    """Under a 30 s max wait, eight distinct single ids flush only by
    exactly filling bucket 8: one flush, eight slots, no padding."""
    async def go(door):
        reg = (telem if isinstance(door, TDoor) else _jax_telem()
               ).default_registry()
        base = reg.mark()
        out = await asyncio.gather(*[
            _http(door, "POST", "/v1/topk", {"ids": [50 + i], "k": K})
            for i in range(8)])
        d = reg.snapshot(baseline=base)
        return out, (d["serve/collator_flushes"], d["serve/slots"],
                     d.get("serve/padded_waste", 0))

    (jo, jc), (to, tc) = _both(engines, go, max_wait_us=30_000_000)
    assert jc == tc == (1, 8, 0)
    for (js, jb, _), (ts, tb, _) in zip(jo, to):
        assert js == ts == 200
        _same_topk(tb, jb)


def _jax_telem():
    from hyperspace_tpu.telemetry import registry

    return registry


def test_shedding_at_queue_max_2_matches_jax(engines):
    """Two single-id requests wait in the collator (bucket 8 is not
    filled; max wait 0.5 s); a third, sent once both are admitted, sheds
    429 ``overloaded``; the two then answer 200."""
    async def go(door):
        first = [asyncio.ensure_future(_http(
            door, "POST", "/v1/topk", {"ids": [i], "k": K}))
            for i in (300, 301)]
        adm = door.batcher._admission
        for _ in range(5000):
            if adm.inflight == 2:
                break
            await asyncio.sleep(0.001)
        assert adm.inflight == 2
        third = await _http(door, "POST", "/v1/topk", {"ids": [302], "k": K})
        rest = await asyncio.gather(*first)
        return [third[0], third[1]["error"]["kind"]] + [r[0] for r in rest]

    jo, to = _both(engines, go, queue_max=2, max_wait_us=500_000)
    assert to == jo == [429, "overloaded", 200, 200]


def test_deadline_504_caches_rows_then_answers_from_cache(engines):
    """A 300 ms ``serve.dispatch`` latency against a 30 ms deadline
    answers 504; the rows were computed and cached, so the same ids
    then answer 200 with no new slot."""
    _jd, td = _doors(engines, cache_size=1024)
    reg = telem.default_registry()

    async def go():
        await td.start()
        try:
            faults.install([faults.FaultSpec(site="serve.dispatch",
                                             kind="latency", ms=300.0)])
            late = await _http(td, "POST", "/v1/topk",
                               {"ids": [11, 12], "k": K, "deadline_ms": 30})
            faults.clear()
            base = reg.mark()
            again = await _http(td, "POST", "/v1/topk",
                                {"ids": [11, 12], "k": K, "deadline_ms": 30})
            return late, again, reg.snapshot(baseline=base)
        finally:
            await td.drain()

    late, again, d = asyncio.run(go())
    assert late[0] == 504 and late[1]["error"]["kind"] == "deadline_exceeded"
    assert again[0] == 200
    assert d.get("serve/slots", 0) == 0 and d["serve/cache_hit"] == 2


def test_drain_answers_inflight_and_refuses_new(engines):
    """Drain during an in-flight dispatch (a 200 ms armed latency): the
    request is answered, new connections are refused and /healthz reads
    503 while draining."""
    _jd, td = _doors(engines)

    async def go():
        await td.start()
        faults.install([faults.FaultSpec(site="serve.dispatch",
                                         kind="latency", ms=200.0)])
        inflight = asyncio.ensure_future(_http(td, "POST", "/v1/topk",
                                               {"ids": [21], "k": K}))
        while td.inflight == 0:
            await asyncio.sleep(0.001)
        drain = asyncio.ensure_future(td.drain())
        await asyncio.sleep(0.02)
        status_mid = td._healthz()[0]
        refused = False
        try:
            await asyncio.open_connection(td.host, td.port)
        except OSError:
            refused = True
        status, body, _ = await inflight
        await drain
        return status, body, refused, status_mid

    status, body, refused, status_mid = asyncio.run(go())
    assert status == 200 and len(body["neighbors"]) == 1
    assert refused and status_mid == 503


def test_kernel_failure_answers_internal_500(engines, monkeypatch):
    """A kernel that fails to build or launch raises RuntimeError: the
    request answers the typed ``internal`` 500, counted in
    ``serve/errors``, and the server keeps serving (no fallback)."""
    _jd, td = _doors(engines)
    reg = telem.default_registry()

    def broken(*_a, **_k):
        raise RuntimeError("nvcc failed for scan_topk.cu")

    async def go():
        await td.start()
        try:
            base = reg.mark()
            monkeypatch.setattr(td.batcher.engine, "topk_neighbors", broken)
            bad = await _http(td, "POST", "/v1/topk", {"ids": [3], "k": K})
            monkeypatch.undo()
            good = await _http(td, "POST", "/v1/topk", {"ids": [3], "k": K})
            return bad, good, reg.snapshot(baseline=base)
        finally:
            await td.drain()

    bad, good, d = asyncio.run(go())
    assert bad[0] == 500 and bad[1]["error"]["kind"] == "internal"
    assert d["serve/errors"] == 1 and good[0] == 200


@pytest.mark.parametrize("prewarmed", [True, False])
def test_cold_dispatches_flat_only_after_prewarm(engines, prewarmed):
    """Traffic over every bucket, both exclude_self and two k counts no
    ``serve/cold_dispatches`` after a prewarm of those k, and at least
    one per new shape without it (the control that shows the counter
    can fail the flat check)."""
    _jeng, teng = engines
    bat = TBatcher(teng, min_bucket=8, max_bucket=64, cache_size=0)
    if prewarmed:
        bat.prewarm([K, 2 * K])
    reg = telem.default_registry()
    base = reg.mark()
    shapes = set()
    for n, k, ex in ((1, K, True), (9, K, False), (40, 2 * K, True),
                     (64, K, True), (3, 2 * K, False)):
        bat.topk(list(range(n)), k, exclude_self=ex)
        shapes.add((max(8, 1 << (n - 1).bit_length()), k, ex))
    cold = reg.snapshot(baseline=base).get("serve/cold_dispatches", 0)
    assert cold == (0 if prewarmed else len(shapes))
    assert bat.stats()["cold_dispatches"] == reg.get("serve/cold_dispatches")

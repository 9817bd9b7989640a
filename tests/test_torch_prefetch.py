"""The port's ``HostPrefetcher`` (``data/prefetch.py``) held to the JAX
package's contract: the six cases of ``tests/data/test_prefetch.py``
(ordering, a start offset, bounded look-ahead, a worker error re-raised
with its cause, ``close`` joining a worker blocked on a put, ``close``
twice) on both packages, the same ``prefetch/*`` counts for one gated
schedule (three items taken from a full queue, one after a stall), and
the ``data.next_batch`` fault site: an ``ioerror`` spec raises
``InjectedIOError`` from exactly the scheduled ``next()`` calls, a
latency spec delays them.  JAX's own ``faults.install`` seeds
``random.Random`` with a tuple, which Python 3.12 refuses, so the site is
held to its contract rather than to JAX's run."""

import threading
import time

import pytest

from hyperspace_tpu.data import prefetch as jpf
from hyperspace_tpu.telemetry import registry as jtelem
from hyperspace_torch.data import prefetch as tpf
from hyperspace_torch.resilience import faults
from hyperspace_torch.telemetry import registry as ttelem

BOTH = pytest.mark.parametrize("mod", [jpf, tpf], ids=["jax", "torch"])


@BOTH
def test_yields_in_order_exactly_once(mod):
    with mod.HostPrefetcher(lambda i: i * 10) as p:
        assert [p.next() for _ in range(5)] == [0, 10, 20, 30, 40]


@BOTH
def test_start_offset_resumes_sequence(mod):
    with mod.HostPrefetcher(lambda i: i, start=3) as p:
        assert [p.next() for _ in range(3)] == [3, 4, 5]


@BOTH
def test_lookahead_is_bounded(mod):
    calls = []
    ev = threading.Event()

    def fn(i):
        calls.append(i)
        ev.set()
        return i

    with mod.HostPrefetcher(fn, depth=2):
        ev.wait(timeout=5.0)
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and len(calls) < 3:
            time.sleep(0.01)
        time.sleep(0.1)
        assert len(calls) <= 3


@BOTH
def test_worker_error_reraises_with_cause(mod):
    def fn(i):
        if i == 2:
            raise ValueError("chunk 2 broke")
        return i

    with mod.HostPrefetcher(fn) as p:
        assert p.next() == 0
        assert p.next() == 1
        with pytest.raises(RuntimeError) as ei:
            p.next()
        assert isinstance(ei.value.__cause__, ValueError)
        assert "chunk 2 broke" in str(ei.value.__cause__)


@BOTH
def test_close_joins_worker_even_when_blocked_on_put(mod):
    with mod.HostPrefetcher(lambda i: i, depth=1) as p:
        p.next()
    assert not p._thread.is_alive()


@BOTH
def test_close_is_idempotent(mod):
    p = mod.HostPrefetcher(lambda i: i)
    p.next()
    p.close()
    p.close()
    assert not p._thread.is_alive()


def _wait(cond, what):
    deadline = time.monotonic() + 10.0
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def _gated_counts(mod, telem):
    """Items 0-2 taken from a full queue (no stall), item 3 after a stall
    (its producer held on a gate), item 4's producer held until the
    counts are read."""
    reg = telem.default_registry()
    reg.reset()
    gates = {3: threading.Event(), 4: threading.Event()}

    def fn(i):
        if i in gates:
            gates[i].wait(timeout=10.0)
        return i

    p = mod.HostPrefetcher(fn, depth=2)
    try:
        got = []
        for _ in range(3):
            _wait(lambda: p._q.qsize() >= 1 and (
                p._q.full() or reg.get("prefetch/produced") >= 3),
                "a ready item")
            got.append(p.next())
        _wait(lambda: p._q.empty(), "the queue to drain")
        threading.Timer(0.05, gates[3].set).start()
        got.append(p.next())
        _wait(lambda: reg.get("prefetch/produced") == 4, "item 3's count")
        snap = reg.snapshot()
        counts = {k: v for k, v in snap.items()
                  if k.startswith("prefetch/") and k != "prefetch/stall_s"}
        stall_s = snap["prefetch/stall_s"]
    finally:
        gates[4].set()
        p.close()
    assert got == [0, 1, 2, 3]
    return counts, stall_s


def test_counts_match_jax():
    t, t_s = _gated_counts(tpf, ttelem)
    j, j_s = _gated_counts(jpf, jtelem)
    assert t == j
    assert t == {"prefetch/produced": 4, "prefetch/consumed": 4,
                 "prefetch/stalls": 1, "prefetch/queue_depth": 0}
    assert t_s > 0 and j_s > 0


def test_next_batch_fault_site():
    """An ``ioerror`` spec at ``after=2, times=1`` raises from the third
    ``next()`` only; the stream goes on after it (the item is not lost);
    a latency spec delays the scheduled call."""
    faults.install([faults.FaultSpec("data.next_batch", "ioerror",
                                     after=2, times=1)])
    try:
        with tpf.HostPrefetcher(lambda i: i) as p:
            assert [p.next(), p.next()] == [0, 1]
            with pytest.raises(faults.InjectedIOError,
                               match="data.next_batch"):
                p.next()
            assert [p.next(), p.next()] == [2, 3]
        st = faults.stats()
        assert st["fired"] == 1 and st["specs"][0]["calls"] == 5
        faults.install([faults.FaultSpec("data.next_batch", "latency",
                                         ms=80.0, after=1)])
        with tpf.HostPrefetcher(lambda i: i) as p:
            p.next()
            _wait(lambda: p._q.full(), "a full queue")
            t0 = time.perf_counter()
            assert p.next() == 1
            assert time.perf_counter() - t0 >= 0.08
    finally:
        faults.clear()
    with tpf.HostPrefetcher(lambda i: i) as p:  # disarmed: no site cost
        assert p.next() == 0

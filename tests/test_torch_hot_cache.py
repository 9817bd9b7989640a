"""The port's ``DeviceHotCache`` (``parallel/host_table.py``) against the
JAX package's, on the CPU: one sequence of id sets (hot ids that recur,
cold ids that do not) over a 1,000 × 8 master, at capacities 64 and 128,
full precision and the int8 and int4 lanes.  After every ``ensure`` the
slots, the id→slot and slot→id maps and the LRU ticks are equal; every
``fetch`` is bitwise JAX's (the master's rows, or the same dequantised
codes); the ``host_table/*`` counters and gauges are equal; the port's
cache tensor is updated in place (its storage never changes).
``ensure_with_rows`` drops the rows of ids that became resident since
their gather in both, and the errors carry JAX's messages."""

import numpy as np
import pytest
import torch

from hyperspace_tpu.parallel import host_table as jht
from hyperspace_tpu.telemetry import registry as jtelem
from hyperspace_torch.parallel import host_table as tht
from hyperspace_torch.telemetry import registry as ttelem

ROWS, W = 1000, 8
KEYS = ("cache_capacity", "cache_hits", "cache_misses", "cache_hit_rate",
        "cache_evictions", "upload_rows", "upload_bytes", "gather_rows")


@pytest.fixture
def arr():
    return np.random.default_rng(0).standard_normal((ROWS, W)).astype(
        np.float32) * 0.3


def _id_sets(capacity, n=14, seed=1):
    """Unique id sets of at most ``capacity``: a recurring hot pool plus
    fresh cold ids, so hits, misses and evictions all happen."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(ROWS, capacity // 2, replace=False)
    sets = []
    for i in range(n):
        keep = hot[rng.random(len(hot)) < 0.6]
        cold = rng.choice(ROWS, capacity - len(keep) - i % 5, replace=False)
        sets.append(np.unique(np.concatenate([keep, cold])))
    return sets


def _counters(reg):
    snap = reg.default_registry().snapshot()
    return {k: snap.get(f"host_table/{k}") for k in KEYS}


def _pair(arr, capacity, quant=None):
    for reg in (jtelem, ttelem):
        reg.default_registry().reset()
    jm = jht.HostEmbedTable.from_array(arr.copy(), shards=3)
    tm = tht.HostEmbedTable.from_array(arr.copy(), shards=3)
    return (jht.DeviceHotCache(jm, capacity, quant=quant),
            tht.DeviceHotCache(tm, capacity, quant=quant, device="cpu"))


def _same_books(j, t):
    np.testing.assert_array_equal(t._slot_of, j._slot_of)
    np.testing.assert_array_equal(t._slot_id, j._slot_id)
    np.testing.assert_array_equal(t._last_used, j._last_used)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("capacity", [64, 128])
def test_ensure_and_fetch_match_jax(arr, capacity, quant):
    j, t = _pair(arr, capacity, quant)
    assert (t.capacity, t.nbytes, tuple(t.array.shape)) == (
        j.capacity, j.nbytes, tuple(j.array.shape))
    ptr = t.array.data_ptr()
    for ids in _id_sets(capacity):
        js, ts = j.ensure(ids), t.ensure(ids)
        np.testing.assert_array_equal(ts, js)
        assert ts.dtype == js.dtype
        _same_books(j, t)
        got = t.fetch(ts)
        np.testing.assert_array_equal(got, j.fetch(js))
        if quant is None:
            np.testing.assert_array_equal(got, arr[ids])
    assert t.array.data_ptr() == ptr
    np.testing.assert_array_equal(t.array.numpy(), np.asarray(j.array))
    if quant is not None:
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    tc, jc = _counters(ttelem), _counters(jtelem)
    assert tc == jc
    assert tc["cache_evictions"] > 0 and tc["cache_hits"] > 0


def test_training_update_through_array_and_stale_rows(arr):
    """A chunk's update lands through ``array``; a gather taken before
    some ids became resident does not overwrite their newer rows."""
    j, t = _pair(arr, 64)
    first = np.arange(0, 40)
    j.ensure(first)
    t.ensure(first)
    j.array = j.array + 1.0
    t.array = t.array + 1.0
    ids = np.arange(20, 60)                  # 20..39 resident, 40..59 not
    pre = arr[ids]                           # gathered "ahead", all misses
    mask = np.ones(len(ids), bool)
    js = j.ensure_with_rows(ids, pre, mask)
    ts = t.ensure_with_rows(ids, pre, mask)
    np.testing.assert_array_equal(ts, js)
    _same_books(j, t)
    got = t.fetch(ts)
    np.testing.assert_array_equal(got, j.fetch(js))
    np.testing.assert_array_equal(got[:20], arr[20:40] + 1.0)  # kept
    np.testing.assert_array_equal(got[20:], arr[40:60])        # uploaded
    assert _counters(ttelem) == _counters(jtelem)


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def _cache(m, a, cap=64, **kw):
    tab = m.HostEmbedTable.from_array(a)
    if m is tht:
        kw["device"] = "cpu"
    return m.DeviceHotCache(tab, cap, **kw)


@pytest.mark.parametrize("bad", [
    lambda m, a: _cache(m, a, 0),
    lambda m, a: _cache(m, a, quant="pq"),
    lambda m, a: _cache(m, a).ensure(np.arange(65)),
    lambda m, a: _cache(m, a).ensure(np.array([3, 4, 3])),
    lambda m, a: _cache(m, a).ensure_with_rows(
        np.arange(5), None, np.ones(5, bool)),
    lambda m, a: setattr(_cache(m, a), "array", _cache(m, a).array[:3]),
    lambda m, a: setattr(_cache(m, a, quant="int8"), "array",
                         _cache(m, a, quant="int8").array),
])
def test_errors_match_jax(arr, bad):
    assert _message(lambda: bad(tht, arr.copy())) == _message(
        lambda: bad(jht, arr.copy()))


def test_capacity_is_capped_at_the_table(arr):
    j, t = _pair(arr[:50], 64)
    assert t.capacity == j.capacity == 50
    assert t.array.dtype == torch.float32

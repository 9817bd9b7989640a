"""The port's ``HostEmbedTable`` (``parallel/host_table.py``) against the
JAX package's: the same numpy table (from a seed) with 1 and 3 shards
gives bitwise equal ``gather`` across shard bounds, ``write_back`` (a
repeated id: the last write wins in both), ``append_rows`` and its ids,
``iter_chunks`` (blocks and starts; none crosses a shard), ``to_array``
and ``_slice_rows``; the errors carry JAX's messages."""

import numpy as np
import pytest

from hyperspace_tpu.parallel import host_table as jht
from hyperspace_torch.parallel import host_table as tht


@pytest.fixture
def arr():
    return np.random.default_rng(0).standard_normal(
        (1003, 7)).astype(np.float32)


def _pair(arr, shards):
    return (jht.HostEmbedTable.from_array(arr.copy(), shards=shards),
            tht.HostEmbedTable.from_array(arr.copy(), shards=shards))


@pytest.mark.parametrize("shards", [1, 3])
def test_access_is_bitwise_jax(arr, shards):
    j, t = _pair(arr, shards)
    assert (t.num_rows, t.width, t.num_shards, t.nbytes, t.dtype) == (
        j.num_rows, j.width, j.num_shards, j.nbytes, j.dtype)
    rng = np.random.default_rng(1)
    ids = np.concatenate([rng.integers(0, 1003, 64), [333, 334, 335, 0,
                                                      1002]])
    np.testing.assert_array_equal(t.gather(ids), j.gather(ids))
    rows = rng.standard_normal((len(ids), 7)).astype(np.float32)
    for tab in (j, t):
        tab.write_back(ids, rows)
    np.testing.assert_array_equal(t.to_array(), j.to_array())
    new = rng.standard_normal((5, 7)).astype(np.float32)
    np.testing.assert_array_equal(t.append_rows(new), j.append_rows(new))
    assert t.append_rows(new[:0]).shape == j.append_rows(new[:0]).shape
    assert (t.num_rows, t.num_shards) == (j.num_rows, j.num_shards)
    np.testing.assert_array_equal(t.gather([1003, 1007, 2]),
                                  j.gather([1003, 1007, 2]))
    for chunk in (100, 1024):
        tb, jb = list(t.iter_chunks(chunk)), list(j.iter_chunks(chunk))
        assert [s for s, _ in tb] == [s for s, _ in jb]
        for (_, x), (_, y) in zip(tb, jb):
            np.testing.assert_array_equal(x, y)
    for lo, hi in ((0, 10), (330, 340), (1000, 1006)):
        np.testing.assert_array_equal(t._slice_rows(lo, hi),
                                      j._slice_rows(lo, hi))


def test_build_generates_shard_by_shard():
    def fill(start, rows):
        return np.full((rows, 3), start, np.float32)

    j = jht.HostEmbedTable.build(1000, 3, fill, shard_rows=256)
    t = tht.HostEmbedTable.build(1000, 3, fill, shard_rows=256)
    assert t.num_shards == j.num_shards == 4
    np.testing.assert_array_equal(t.to_array(), j.to_array())


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("bad", [
    lambda m, a: m.HostEmbedTable([]),
    lambda m, a: m.HostEmbedTable([a[:, :3], a[:, :4]]),
    lambda m, a: m.HostEmbedTable.from_array(a[0]),
    lambda m, a: m.HostEmbedTable.build(10, 3, lambda s, r: np.zeros((r, 2))),
    lambda m, a: m.HostEmbedTable.from_array(a).gather([0, 1003]),
    lambda m, a: m.HostEmbedTable.from_array(a).gather([-1]),
    lambda m, a: m.HostEmbedTable.from_array(a).write_back([0, 1], a[:1]),
    lambda m, a: m.HostEmbedTable.from_array(a).append_rows(a[:2, :3]),
])
def test_errors_match_jax(arr, bad):
    assert _message(lambda: bad(tht, arr.copy())) == _message(
        lambda: bad(jht, arr.copy()))

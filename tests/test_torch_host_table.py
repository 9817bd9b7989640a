"""The port's ``HostEmbedTable`` (``parallel/host_table.py``) against the
JAX package's: the same numpy table (from a seed) with 1 and 3 shards
gives bitwise equal ``gather`` across shard bounds, ``write_back`` (a
repeated id: the last write wins in both), ``append_rows`` and its ids,
``iter_chunks`` (blocks and starts; none crosses a shard), ``to_array``
and ``_slice_rows``; the errors carry JAX's messages.

The checkpoint half: the port's ``save_sharded`` read back by JAX's
``load_sharded``, JAX's ``save_owned_rows`` (one process, and three
writing in turn) read by the port's ``load_sharded`` and ``load_rows``,
and the port's ``save_owned_rows`` by JAX's, all bitwise at 1, 3 and 7
shards either side, with ``io_rows_peak`` within max(saved shard,
destination shard) rows; a JAX Orbax manifest is refused, naming its
codec."""

import json
import os

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


def _rows(n, shards):
    return -(-n // shards)


@pytest.mark.parametrize("mem", [1, 3])
@pytest.mark.parametrize("saved", [1, 3, 7])
@pytest.mark.parametrize("dest", [1, 3, 7])
def test_save_sharded_reads_back_in_jax(arr, tmp_path, mem, saved, dest):
    t = tht.HostEmbedTable.from_array(arr.copy(), shards=mem)
    d = str(tmp_path / "t")
    tht.reset_io_peak()
    t.save_sharded(d, shards=saved)
    assert tht.io_rows_peak() <= max(_rows(1003, mem), _rows(1003, saved))
    with open(os.path.join(d, tht.MANIFEST)) as f:
        meta = json.load(f)
    assert meta["codec"] == "npy" and meta["shards"] == saved
    assert meta["version"] == tht.FORMAT_VERSION == jht.FORMAT_VERSION
    j = jht.HostEmbedTable.load_sharded(d, shards=dest)
    assert j.num_shards == dest
    np.testing.assert_array_equal(j.to_array(), arr)
    tht.reset_io_peak()
    back = tht.HostEmbedTable.load_sharded(d, shards=dest)
    assert tht.io_rows_peak() <= max(_rows(1003, saved), _rows(1003, dest))
    np.testing.assert_array_equal(back.to_array(), arr)
    assert back.num_shards == dest


@pytest.mark.parametrize("procs", [1, 3])
@pytest.mark.parametrize("dest", [1, 3, 7])
def test_jax_owned_rows_read_by_the_port(arr, tmp_path, procs, dest):
    d = str(tmp_path / "o")
    j = jht.HostEmbedTable.from_array(arr.copy(), shards=2)
    for pi in range(procs):
        jht.save_owned_rows(j, d, process_index=pi, process_count=procs)
    t = tht.HostEmbedTable.load_sharded(d, shards=dest)
    np.testing.assert_array_equal(t.to_array(), arr)
    for lo, hi in ((0, 1003), (300, 700), (334, 335), (500, 500)):
        tht.reset_io_peak()
        np.testing.assert_array_equal(tht.load_rows(d, lo, hi), arr[lo:hi])
        np.testing.assert_array_equal(tht.load_rows(d, lo, hi),
                                      jht.load_rows(d, lo, hi))
        assert tht.io_rows_peak() <= max(hi - lo, 0)


@pytest.mark.parametrize("procs", [1, 3])
def test_port_owned_rows_read_by_jax(arr, tmp_path, procs):
    d = str(tmp_path / "p")
    t = tht.HostEmbedTable.from_array(arr.copy(), shards=3)
    calls = []
    for pi in range(procs):
        tht.save_owned_rows(t, d, process_index=pi, process_count=procs,
                            barrier=lambda: calls.append(1))
    assert len(calls) == 2 * procs
    assert sorted(os.listdir(d)) == sorted(
        [tht.MANIFEST] + [f"shard_{i:05d}.npy" for i in range(procs)])
    for shards in (1, 3, 7):
        np.testing.assert_array_equal(
            jht.HostEmbedTable.load_sharded(d, shards=shards).to_array(),
            arr)
    np.testing.assert_array_equal(jht.load_rows(d, 100, 900), arr[100:900])


def test_an_orbax_manifest_is_refused(arr, tmp_path):
    d = tmp_path / "orbax"
    d.mkdir()
    with open(d / tht.MANIFEST, "w") as f:   # JAX save_sharded's manifest
        json.dump({"version": 1, "num_rows": 1003, "width": 7,
                   "dtype": "float32", "shards": 1, "bounds": [0, 1003]}, f)
    for fn in (lambda: tht.HostEmbedTable.load_sharded(str(d)),
               lambda: tht.load_rows(str(d), 0, 10)):
        with pytest.raises(ValueError, match="codec 'orbax'"):
            fn()


@pytest.mark.parametrize("bad", [
    lambda m, d, a: m.save_owned_rows(m.HostEmbedTable.from_array(a), d,
                                      process_index=3, process_count=3),
    lambda m, d, a: m.load_rows(d, 5, 2000),
    lambda m, d, a: m.load_rows(d, -1, 3),
    lambda m, d, a: m.HostEmbedTable.load_sharded(d + "v"),
    lambda m, d, a: m.load_rows(d + "v", 0, 1),
])
def test_checkpoint_errors_match_jax(arr, tmp_path, bad):
    d = str(tmp_path / "e")
    tht.save_owned_rows(tht.HostEmbedTable.from_array(arr), d)
    os.makedirs(d + "v")
    with open(os.path.join(d + "v", tht.MANIFEST), "w") as f:
        json.dump({"version": 2, "codec": "npy"}, f)
    assert _message(lambda: bad(tht, d, arr.copy())) == _message(
        lambda: bad(jht, d, arr.copy()))

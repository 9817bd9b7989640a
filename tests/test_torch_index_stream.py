"""The port's host-streamed IVF build (``serve/index.py``) against the
JAX package's, on the same clustered ball table (numpy, from a seed):
for an ndarray source under ``host_resident=True`` and for a
``HostEmbedTable`` source of 3 shards (streamed by construction), the
cells and counts are identical and the centroids within the f32 tier
(rtol 1e-5, atol 1e-6: the two sum each cell in another order).  The
streamed build from the resident build's seeds assigns every row alike,
one ``[_BUILD_CHUNK, D]`` block on the device at a time; the
``seed_sample``/``host_resident`` validation errors carry JAX's
messages."""

import numpy as np
import pytest

from hyperspace_tpu.parallel.host_table import HostEmbedTable as JTable
from hyperspace_tpu.serve import index as jidx
from hyperspace_torch.parallel.host_table import HostEmbedTable as TTable
from hyperspace_torch.serve import index as tidx
from hyperspace_torch.telemetry import registry as telem
from tests.test_torch_ivf_pq import clustered

SPEC = ("poincare", 1.0)
N, D, NCELLS = 9000, 6, 24


@pytest.fixture(scope="module")
def table():
    return clustered(N, D, seed=4)


@pytest.mark.parametrize("source", ["ndarray", "host_table"])
def test_streamed_build_matches_jax(table, source):
    kw = dict(iters=3, seed=2, seed_sample=1500)
    if source == "ndarray":
        want = jidx.build_index(table, SPEC, NCELLS, host_resident=True,
                                **kw)
        got = tidx.build_index(table, SPEC, NCELLS, host_resident=True,
                               device="cpu", **kw)
    else:
        want = jidx.build_index(JTable.from_array(table.copy(), shards=3),
                                SPEC, NCELLS, **kw)
        got = tidx.build_index(TTable.from_array(table.copy(), shards=3),
                               SPEC, NCELLS, device="cpu", **kw)
    np.testing.assert_array_equal(got.cells, want.cells)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=1e-5,
                               atol=1e-6)
    assert (got.num_nodes, got.iters, got.seed) == (N, 3, 2)


def test_streamed_equals_resident_from_the_same_seeds(table):
    """``seed_sample`` below N seeds both builds from the same sample, so
    the streamed build (blocks copied one at a time) and the resident
    one assign alike; the device held at most one block of rows."""
    kw = dict(iters=3, seed=7, seed_sample=2000, device="cpu")
    res = tidx.build_index(table, SPEC, NCELLS, host_resident=False, **kw)
    st = tidx.build_index(table, SPEC, NCELLS, host_resident=True, **kw)
    np.testing.assert_array_equal(st.cells, res.cells)
    np.testing.assert_allclose(st.centroids, res.centroids, rtol=1e-5,
                               atol=1e-6)
    peak = telem.default_registry().snapshot()[
        "index/build_device_rows_peak"]
    assert peak == tidx._BUILD_CHUNK == jidx._BUILD_CHUNK
    assert tidx.HOST_BUILD_ROWS == jidx.HOST_BUILD_ROWS
    assert tidx.SEED_SAMPLE_DEFAULT == jidx.SEED_SAMPLE_DEFAULT


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["host_table_resident", "small_sample",
                                  "stream_small_default"])
def test_validation_errors_match_jax(table, case):
    small = table[:600]
    if case == "host_table_resident":
        def call(m, T, **d):
            return m.build_index(T.from_array(small.copy()), SPEC, 8,
                                 host_resident=False, **d)
    elif case == "small_sample":
        def call(m, T, **d):
            return m.build_index(small, SPEC, 40, seed_sample=20, **d)
    else:
        def call(m, T, **d):
            return m.build_index(small[:30], SPEC, 31, host_resident=True,
                                 **d)
    assert _message(lambda: call(tidx, TTable, device="cpu")) == _message(
        lambda: call(jidx, JTable))

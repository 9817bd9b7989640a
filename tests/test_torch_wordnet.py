"""The port's WordNet-style data (``hyperspace_torch/data/wordnet.py``)
against the JAX package: the closure's pair set against JAX's pure-Python
DFS (``_closure_numpy``) on a DAG with several parents a node and a cycle,
the synthetic trees, and the TSV loaders on files the test writes."""

import time

import numpy as np
import pytest

from hyperspace_tpu.data import wordnet as J
from hyperspace_torch.data import wordnet as T


def _pair_set(pairs):
    return set(map(tuple, np.asarray(pairs).tolist()))


def _dag(n, seed):
    rng = np.random.default_rng(seed)
    edges = [(u, int(p)) for u in range(1, n)
             for p in rng.choice(u, size=min(u, int(rng.integers(1, 4))),
                                 replace=False)]
    return np.asarray(edges, np.int32)


@pytest.mark.parametrize("n,seed", [(40, 0), (120, 1)])
def test_closure_set_equals_jax_on_a_dag(n, seed):
    edges = _dag(n, seed)
    got = T.transitive_closure(edges, n)
    assert got.dtype == np.int32 and got.shape[1] == 2
    assert _pair_set(got) == _pair_set(J._closure_numpy(edges, n))
    assert len(_pair_set(got)) == len(got)             # no duplicates


def test_closure_with_a_cycle_duplicate_edges_and_isolated_nodes():
    edges = np.asarray([(1, 0), (2, 1), (0, 2), (3, 2), (3, 2), (5, 3)],
                       np.int32)
    got = T.transitive_closure(edges, 7)
    assert _pair_set(got) == _pair_set(J._closure_numpy(edges, 7))
    assert (0, 0) in _pair_set(got)                    # via the cycle
    assert T.transitive_closure(np.zeros((0, 2), np.int32), 3).shape == (0, 2)


@pytest.mark.parametrize("depth,branching", [(2, 5), (1, 4), (3, 3),
                                             (4, 2)])
def test_synthetic_tree_equals_jax(depth, branching):
    j = J.synthetic_tree(depth, branching)
    t = T.synthetic_tree(depth, branching)
    assert t.num_nodes == j.num_nodes and t.num_pairs == j.num_pairs
    assert t.adjacency_set() == j.adjacency_set()


def test_wordnet_scale_trees_close_in_seconds():
    t0 = time.perf_counter()
    ds = T.synthetic_tree(5, 9)
    assert (ds.num_nodes, ds.num_pairs) == (66_430, 323_847)
    big = T.synthetic_tree(6, 9)
    assert big.num_nodes == 597_871
    # every node at depth k has k ancestors: Σ_k k·9^k
    assert big.num_pairs == sum(k * 9 ** k for k in range(7))
    assert time.perf_counter() - t0 < 20.0


@pytest.mark.parametrize("closed", [True, False])
def test_load_tsv_matches_jax(tmp_path, closed):
    edges = _dag(30, 5)
    names = [f"n{i:02d}.x" for i in range(30)]
    rows = edges if not closed else J._closure_numpy(edges, 30)
    path = tmp_path / "closure.tsv"
    with open(path, "w") as f:
        f.write("# child\tparent\n")
        for u, v in rows:
            f.write(f"{names[u]}\t{names[v]}\n")
        f.write("malformed-line\n")
    j = J.load_closure_tsv(str(path), already_closed=closed)
    t = T.load_closure_tsv(str(path), already_closed=closed)
    assert t.names == j.names and t.num_nodes == j.num_nodes
    assert t.adjacency_set() == j.adjacency_set()
    if closed:
        np.testing.assert_array_equal(t.pairs, j.pairs)
    je, jn = J.load_edges_tsv(str(path))
    te, tn = T.load_edges_tsv(str(path))
    np.testing.assert_array_equal(te, je)
    assert tn == jn

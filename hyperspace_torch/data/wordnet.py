"""WordNet-style hierarchies (counterpart of
``hyperspace_tpu/data/wordnet.py``): the transitive closure of a
``child<TAB>parent`` edge list as (node, ancestor) pairs, and complete
trees of a chosen size that stand in for the WordNet noun closure (no
WordNet file is in the repository).

The closure is one vectorised numpy computation: the (node, ancestor)
pairs found last are joined with the ancestors' parent lists until no new
pair appears.  Its pair set equals the JAX package's; the order differs
(here ascending by node, then ancestor)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ClosureDataset:
    """A hierarchy as (child, ancestor) pairs over ``num_nodes`` ids."""

    pairs: np.ndarray  # [P, 2] int32 (u, v): v is an ancestor of u
    num_nodes: int
    names: list[str] | None = None

    @property
    def num_pairs(self) -> int:
        return int(self.pairs.shape[0])

    def adjacency_set(self) -> set[tuple[int, int]]:
        return {(int(u), int(v)) for u, v in self.pairs}


def load_edges_tsv(path: str) -> tuple[np.ndarray, list[str]]:
    """Read ``child<TAB>parent`` lines (``#`` lines and lines without a
    tab skipped); returns (edges [E, 2] int32, names by id in order of
    first appearance)."""
    ids: dict[str, int] = {}
    edges = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2 or parts[0].startswith("#"):
                continue
            for t in parts[:2]:
                ids.setdefault(t, len(ids))
            edges.append((ids[parts[0]], ids[parts[1]]))
    names = [None] * len(ids)
    for t, i in ids.items():
        names[i] = t
    return np.asarray(edges, np.int32).reshape(-1, 2), names


def transitive_closure(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """All (node, ancestor) pairs reachable through the parent relation,
    [P, 2] int32, ascending."""
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    if len(edges) == 0:
        return np.zeros((0, 2), np.int32)
    n = np.int64(num_nodes)
    # parent lists as CSR over the child id
    order = np.argsort(edges[:, 0], kind="stable")
    parents = edges[order, 1]
    starts = np.searchsorted(edges[order, 0], np.arange(num_nodes + 1))
    deg = np.diff(starts)
    known = np.unique(edges[:, 0] * n + edges[:, 1])
    frontier = known
    while len(frontier):
        u, a = frontier // n, frontier % n
        k = deg[a]
        if not k.sum():
            break
        # each frontier pair (u, a) → (u, p) for every parent p of a
        pos = np.repeat(starts[a] - np.cumsum(k) + k, k) + np.arange(k.sum())
        cand = np.unique(np.repeat(u, k) * n + parents[pos])
        frontier = cand[~np.isin(cand, known, assume_unique=True)]
        known = np.union1d(known, frontier)
    return np.stack([known // n, known % n], axis=1).astype(np.int32)


def load_closure_tsv(path: str, already_closed: bool = True) -> ClosureDataset:
    """A closure TSV (``already_closed``: its lines are the pairs), or an
    edge list closed here."""
    edges, names = load_edges_tsv(path)
    n = len(names)
    pairs = edges if already_closed else transitive_closure(edges, n)
    return ClosureDataset(pairs=pairs, num_nodes=n, names=names)


def synthetic_tree(depth: int, branching: int, seed: int = 0) -> ClosureDataset:
    """The complete ``branching``-ary tree of the given depth, closed;
    node 0 is the root and ids go level by level, a parent's children
    consecutive (the JAX package's numbering)."""
    del seed
    edges, first, width = [], 0, 1
    for _ in range(depth):
        parent = first + np.arange(width, dtype=np.int64)
        child = first + width + np.arange(width * branching, dtype=np.int64)
        edges.append(np.stack([child, np.repeat(parent, branching)], 1))
        first, width = first + width, width * branching
    n = first + width
    edges = np.concatenate(edges) if edges else np.zeros((0, 2), np.int64)
    return ClosureDataset(pairs=transitive_closure(edges, n), num_nodes=n,
                          names=None)

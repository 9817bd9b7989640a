"""Graph data for HGCN (counterpart of ``hyperspace_tpu/data/graphs.py``):
the padded, receiver-sorted edge layout, the link-prediction split, the
node-classification masks, the synthetic hierarchy and the locality
relabelings.

Host work is numpy only.  The JAX package dispatches some of it to a
C++ library (``data/_native``) and keeps these numpy versions as its
parity oracles; the port runs the numpy versions, which give the same
arrays for the same seed.  Two exceptions are deliberate: there is no
on-disk prep cache, and ``split_edges`` samples its held-out negatives
with the numpy rejection sampler, so they are valid non-edges but not
the JAX package's draws (which come from the C++ sampler first).

Layout (as in the JAX package): edges symmetrized, self-loops added,
deduplicated and sorted by (receiver, sender), padded to a multiple of
``pad_multiple`` with inert (N−1, N−1) edges whose ``edge_mask`` is
False; ``rev_perm`` maps each edge to its reverse; ``deg`` is the masked
in-degree; ``csr_plan`` and the cluster split are built once per graph.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from hyperspace_torch.kernels.cluster import ClusterSplit, build_cluster_split
from hyperspace_torch.kernels.segment import build_csr_plan


@dataclasses.dataclass
class Graph:
    """A static-shape graph on the host: padded edge list + masks."""

    x: np.ndarray  # [N, F] float32 node features
    senders: np.ndarray  # [E_pad] int32
    receivers: np.ndarray  # [E_pad] int32, sorted ascending
    edge_mask: np.ndarray  # [E_pad] bool (False = padding)
    num_nodes: int
    rev_perm: np.ndarray | None = None  # [E_pad] int32 edge -> reverse edge
    deg: np.ndarray | None = None  # [N] float32 masked in-degree
    csr_plan: tuple | None = None  # kernels.segment.CsrPlan work items
    cluster_split: ClusterSplit | None = None  # mean-aggregation split
    labels: np.ndarray | None = None  # [N] int32 (node tasks)
    num_classes: int = 0
    train_mask: np.ndarray | None = None  # [N] bool
    val_mask: np.ndarray | None = None
    test_mask: np.ndarray | None = None

    @property
    def num_edges(self) -> int:
        return int(self.edge_mask.sum())


@dataclasses.dataclass
class DeviceGraph:
    """The graph's tensors on one device: the single argument the layers
    take for message passing.  Optional fields are None when the host
    graph lacks them."""

    x: torch.Tensor                  # [N, F]
    senders: torch.Tensor            # [E] int32
    receivers: torch.Tensor          # [E] int32, sorted
    edge_mask: torch.Tensor          # [E] bool
    num_nodes: int
    rev_perm: Optional[torch.Tensor] = None   # [E] int32 involution
    deg: Optional[torch.Tensor] = None        # [N] float32
    plan: Optional[tuple] = None              # 3 × [T] int32 CSR items
    cluster: Any = None                       # nn.scatter.ClusterAgg


def index_tensor(a, device) -> torch.Tensor:
    """Host ids as an int32 tensor on ``device`` (the kernels' id type;
    PyTorch indexes with it directly)."""
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def to_device(g: Graph, device) -> DeviceGraph:
    """Put a host :class:`Graph` on ``device`` as a :class:`DeviceGraph`."""
    cluster = None
    if g.cluster_split is not None:
        from hyperspace_torch.nn.scatter import ClusterAgg

        cluster = ClusterAgg.from_host(g.cluster_split, device)
    dev = torch.device(device)
    return DeviceGraph(
        x=torch.as_tensor(np.asarray(g.x, np.float32), device=dev),
        senders=index_tensor(g.senders, dev),
        receivers=index_tensor(g.receivers, dev),
        edge_mask=torch.as_tensor(np.asarray(g.edge_mask, bool), device=dev),
        num_nodes=g.num_nodes,
        rev_perm=None if g.rev_perm is None else index_tensor(g.rev_perm,
                                                               dev),
        deg=None if g.deg is None else torch.as_tensor(g.deg, device=dev),
        plan=None if g.csr_plan is None
        else tuple(torch.as_tensor(a, device=dev) for a in g.csr_plan),
        cluster=cluster,
    )


@dataclasses.dataclass
class LinkSplit:
    """Edge split for link prediction: ``graph`` holds only the training
    edges; val/test arrays are [K, 2] (u, v) pairs."""

    graph: Graph
    train_pos: np.ndarray
    val_pos: np.ndarray
    val_neg: np.ndarray
    test_pos: np.ndarray
    test_neg: np.ndarray


def _pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _prepare_edges_numpy(edges, num_nodes, *, pad_multiple=1024):
    """The edge-layout pipeline (symmetrized, with self-loops); returns
    (senders, receivers, mask, rev_perm, deg)."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    loops = np.stack([np.arange(num_nodes)] * 2, axis=1)
    e = np.concatenate([e, e[:, ::-1], loops], axis=0)
    # dedupe + sort by (receiver, sender) via flat receiver-major keys
    key = e[:, 1] * num_nodes + e[:, 0]
    e = e[np.unique(key, return_index=True)[1]]
    e_pad = _pad_to(max(len(e), 1), pad_multiple)
    senders = np.full(e_pad, num_nodes - 1, np.int32)
    receivers = np.full(e_pad, num_nodes - 1, np.int32)
    mask = np.zeros(e_pad, bool)
    senders[: len(e)] = e[:, 0]
    receivers[: len(e)] = e[:, 1]
    mask[: len(e)] = True

    # reverse of (s, r) has key s·N + r; keys are sorted, so searchsorted
    # gives its index.  Padding maps to itself.
    keys_sorted = e[:, 1] * num_nodes + e[:, 0]
    rev_perm = np.arange(e_pad, dtype=np.int32)
    rev_perm[: len(e)] = np.searchsorted(
        keys_sorted, e[:, 0] * num_nodes + e[:, 1]).astype(np.int32)
    deg = np.bincount(receivers[mask], minlength=num_nodes).astype(np.float32)
    return senders, receivers, mask, rev_perm, deg


def _check_edge_range(edges, num_nodes: int) -> None:
    e = np.asarray(edges)
    if len(e) and (e.min() < 0 or e.max() >= num_nodes):
        raise IndexError(
            f"edge ids out of range [0, {num_nodes}): min {e.min()}, "
            f"max {e.max()}")


def cluster_min_pair_for(use_att: bool) -> int:
    """The cluster-pair density threshold: 256 edges for mean
    aggregation, 128 for attention (the JAX package's tuned values)."""
    return 128 if use_att else 256


# real-edge count from which cluster="auto" builds the cluster split
CLUSTER_AUTO_MIN_EDGES = 200_000


def prepare(
    edges: np.ndarray,
    num_nodes: int,
    x: np.ndarray,
    *,
    pad_multiple: int = 1024,
    cluster: str | bool = "auto",
    cluster_min_pair: int = 256,
    **node_fields,
) -> Graph:
    """Symmetrize, add self-loops, dedupe, sort by receiver, pad; build
    ``deg``, the CSR plan and (``cluster=True``, or ``"auto"`` at ≥200,000
    real edges) the cluster split.  ``node_fields`` (``labels``,
    ``num_classes``, ``train_mask``, ``val_mask``, ``test_mask``) ride
    along unchanged: the layout renames no node, so any relabeling
    (:func:`apply_locality_order`) comes before, on ``x`` and labels
    alike, and masks are drawn in the new names."""
    _check_edge_range(edges, num_nodes)
    senders, receivers, mask, rev_perm, deg = _prepare_edges_numpy(
        edges, num_nodes, pad_multiple=pad_multiple)
    split = None
    n_real = int(mask.sum())
    if cluster is True or (cluster == "auto"
                           and n_real >= CLUSTER_AUTO_MIN_EDGES):
        split = build_cluster_split(senders, receivers, mask, deg,
                                    num_nodes, rev_perm=rev_perm,
                                    min_pair_edges=cluster_min_pair)
    return Graph(
        x=np.asarray(x, np.float32),
        senders=senders,
        receivers=receivers,
        edge_mask=mask,
        num_nodes=num_nodes,
        rev_perm=rev_perm,
        deg=deg,
        csr_plan=tuple(build_csr_plan(receivers, num_nodes)),
        cluster_split=split,
        **node_fields,
    )


def _sample_negatives(num_nodes: int, k: int, rng,
                      edge_set: set) -> np.ndarray:
    """``k`` uniform non-edges (u < v, u ≠ v, not in ``edge_set``) by
    rejection."""
    out = []
    while len(out) < k:
        cand = rng.integers(0, num_nodes, size=(2 * (k - len(out)) + 16, 2))
        for u, v in cand.tolist():
            if u == v:
                continue
            a, b = (u, v) if u < v else (v, u)
            if (a, b) in edge_set:
                continue
            out.append((a, b))
            if len(out) == k:
                break
    return np.asarray(out, np.int64).reshape(-1, 2)


def split_edges(
    edges: np.ndarray,
    num_nodes: int,
    x: np.ndarray,
    *,
    val_frac: float = 0.05,
    test_frac: float = 0.10,
    seed: int = 0,
    pad_multiple: int = 1024,
    cluster_min_pair: int = 256,
) -> LinkSplit:
    """Hold out edges for LP eval; message passing uses only train edges.
    Negatives are uniform non-edges (Chami et al. 2019)."""
    e = np.asarray(edges, np.int64)
    rng = np.random.default_rng(seed)
    # undirected canonical form for splitting
    canon = np.sort(e, axis=1)
    canon = canon[np.unique(canon[:, 0] * num_nodes + canon[:, 1],
                            return_index=True)[1]]
    perm = rng.permutation(len(canon))
    n_val = int(len(canon) * val_frac)
    n_test = int(len(canon) * test_frac)
    val_pos = canon[perm[:n_val]]
    test_pos = canon[perm[n_val: n_val + n_test]]
    train_pos = canon[perm[n_val + n_test:]]
    edge_set = set(zip(canon[:, 0].tolist(), canon[:, 1].tolist()))
    val_neg = _sample_negatives(num_nodes, len(val_pos), rng, edge_set)
    test_neg = _sample_negatives(num_nodes, len(test_pos), rng, edge_set)
    g = prepare(train_pos, num_nodes, x, pad_multiple=pad_multiple,
                cluster_min_pair=cluster_min_pair)
    return LinkSplit(graph=g, train_pos=train_pos.astype(np.int32),
                     val_pos=val_pos.astype(np.int32),
                     val_neg=val_neg.astype(np.int32),
                     test_pos=test_pos.astype(np.int32),
                     test_neg=test_neg.astype(np.int32))


def synthetic_hierarchy(
    num_nodes: int = 1024,
    branching: int = 3,
    feat_dim: int = 32,
    ancestor_hops: int = 3,
    extra_edge_frac: float = 0.02,
    num_classes: int = 4,
    seed: int = 0,
):
    """A noisy hierarchy with community-correlated features: a
    ``branching``-ary tree plus ancestor edges up to ``ancestor_hops``
    levels and a few random cross edges.  Class = top-level subtree;
    features = class prototype + noise + a depth coordinate.  Returns
    (edges [E,2], x [N,F], labels [N], num_classes); the draws follow the
    JAX package's exactly, so the same seed gives the same arrays."""
    rng = np.random.default_rng(seed)
    parent = np.zeros(num_nodes, np.int64)
    parent[1:] = (np.arange(1, num_nodes) - 1) // branching
    edges = []
    for i in range(1, num_nodes):
        anc = i
        for _ in range(max(1, ancestor_hops)):
            anc = int(parent[anc])
            edges.append((i, anc))
            if anc == 0:
                break
    n_extra = int(num_nodes * extra_edge_frac)
    for _ in range(n_extra):
        u, v = rng.integers(0, num_nodes, 2)
        if u != v:
            edges.append((int(u), int(v)))
    edges = np.asarray(edges, np.int64)

    # class of a node = which depth-1 subtree it falls under
    depth = np.zeros(num_nodes, np.int64)
    top = np.zeros(num_nodes, np.int64)
    for i in range(1, num_nodes):
        depth[i] = depth[parent[i]] + 1
        top[i] = i if depth[i] == 1 else top[parent[i]]
    labels = (top % num_classes).astype(np.int32)
    labels[0] = 0

    protos = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    x = protos[labels] + 0.4 * rng.normal(
        size=(num_nodes, feat_dim)).astype(np.float32)
    x[:, 0] = depth / max(depth.max(), 1)
    return edges, x, labels, num_classes


def node_split_masks(num_nodes: int, train_frac=0.6, val_frac=0.2,
                     seed: int = 0):
    """(train, val, test) boolean masks [N]: a seeded permutation cut at
    ``train_frac`` and ``train_frac + val_frac``."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_nodes)
    n_tr = int(num_nodes * train_frac)
    n_va = int(num_nodes * val_frac)
    tr = np.zeros(num_nodes, bool)
    va = np.zeros(num_nodes, bool)
    te = np.zeros(num_nodes, bool)
    tr[perm[:n_tr]] = True
    va[perm[n_tr: n_tr + n_va]] = True
    te[perm[n_tr + n_va:]] = True
    return tr, va, te


def locality_order(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """BFS relabeling that clusters neighbourhoods into contiguous id
    ranges: ``order[rank] = old_id``, BFS from the highest-degree node of
    each component, neighbours in edge order."""
    e = np.asarray(edges, np.int64)
    _check_edge_range(e, num_nodes)
    e = np.concatenate([e, e[:, ::-1]], axis=0)
    e = e[np.argsort(e[:, 0], kind="stable")]
    indptr = np.searchsorted(e[:, 0], np.arange(num_nodes + 1)).tolist()
    nbr = e[:, 1].tolist()
    deg = np.diff(indptr)
    seeds = np.argsort(-deg, kind="stable").tolist()
    visited = bytearray(num_nodes)
    out = np.empty(num_nodes, np.int64)
    pos = si = 0
    q: deque = deque()
    while pos < num_nodes:
        while si < num_nodes and visited[seeds[si]]:
            si += 1
        root = seeds[si]
        visited[root] = 1
        q.append(root)
        while q:
            u = q.popleft()
            out[pos] = u
            pos += 1
            for v in nbr[indptr[u]: indptr[u + 1]]:
                if not visited[v]:
                    visited[v] = 1
                    q.append(v)
    return out


def _lpa_sweeps(snd: np.ndarray, rcv: np.ndarray, num_nodes: int,
                sweeps: int, rng) -> np.ndarray:
    """Semi-asynchronous label propagation over a symmetric edge list:
    each sweep computes every node's majority neighbour label (ties to
    the smaller label) and applies it to a random half of the nodes."""
    lab = np.arange(num_nodes, dtype=np.int64)
    for _ in range(sweeps):
        nl = lab[snd]
        o = np.lexsort((nl, rcv))
        r_s, l_s = rcv[o], nl[o]
        new_pair = np.r_[True, (r_s[1:] != r_s[:-1]) | (l_s[1:] != l_s[:-1])]
        starts = np.flatnonzero(new_pair)
        counts = np.diff(np.r_[starts, len(r_s)])
        pr, pl = r_s[starts], l_s[starts]
        ordp = np.lexsort((-counts, pr))
        firsts = np.flatnonzero(np.r_[True, pr[ordp][1:] != pr[ordp][:-1]])
        upd_r, upd_l = pr[ordp][firsts], pl[ordp][firsts]
        m = rng.random(len(upd_r)) < 0.5
        lab2 = lab.copy()
        lab2[upd_r[m]] = upd_l[m]
        lab = lab2
    return lab


def community_order(edges: np.ndarray, num_nodes: int,
                    sweeps: int = 16, split_rounds: int = 2,
                    split_above: int = 1024, seed: int = 0) -> np.ndarray:
    """Community-clustered relabeling: label-propagation groups (giant
    groups re-clustered on their own subgraph), ordered by (group's first
    BFS rank, BFS rank).  A graph isomorphism: only the layout changes."""
    e = np.asarray(edges, np.int64)
    _check_edge_range(e, num_nodes)
    rng = np.random.default_rng(seed)
    sym = np.concatenate([e, e[:, ::-1]], axis=0)
    snd, rcv = sym[:, 0], sym[:, 1]
    lab = _lpa_sweeps(snd, rcv, num_nodes, sweeps, rng)
    for _ in range(split_rounds):
        szmap = np.bincount(lab)
        big = szmap[lab] > split_above
        keep = big[snd] & big[rcv] & (lab[snd] == lab[rcv])
        if not keep.sum():
            break
        sub = _lpa_sweeps(snd[keep], rcv[keep], num_nodes, max(sweeps - 6, 4),
                          rng)
        lab = np.where(big, lab.max() + 1 + sub, lab)
    bfs = locality_order(e, num_nodes)
    rank = np.empty(num_nodes, np.int64)
    rank[bfs] = np.arange(num_nodes)
    minr = np.full(int(lab.max()) + 1, num_nodes, np.int64)
    np.minimum.at(minr, lab, rank)
    return np.lexsort((rank, minr[lab]))


def apply_locality_order(edges: np.ndarray, x: np.ndarray,
                         labels: Optional[np.ndarray] = None,
                         method: str = "bfs"):
    """Relabel a graph with :func:`locality_order` (``"bfs"``) or
    :func:`community_order` (``"community"``).  Returns (edges, x, labels,
    order) with node ``order[rank]`` renamed to ``rank``."""
    n = x.shape[0]
    if method not in ("community", "bfs"):
        raise ValueError(f"unknown reorder method {method!r}")
    e_arr = np.asarray(edges, np.int64)
    order = (community_order(e_arr, n) if method == "community"
             else locality_order(e_arr, n))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    new_edges = rank[e_arr]
    new_x = np.asarray(x)[order]
    new_labels = None if labels is None else np.asarray(labels)[order]
    return new_edges, new_x, new_labels, order

"""Graph data for HGCN (counterpart of ``hyperspace_tpu/data/graphs.py``):
the padded, receiver-sorted edge layout, the link-prediction split, the
node-classification masks, the on-disk loaders and writers, the
synthetic graphs and the locality relabelings.

Host work is numpy, with two stages in C++ (``data/native.py``): the
edge layout of :func:`prepare` and the BFS of :func:`locality_order`.
Each runs its numpy version when no C++ compiler is found; the numpy
versions are the parity oracles (bitwise the same arrays), and a
prepared :class:`Graph` records which ran (``prep``).  The layout, the
locality order and the link-prediction split are served from the
persistent cache of :mod:`hyperspace_torch.data.prep_cache` when
``cache`` allows it (``"auto"``: from 200,000 raw edges).
``split_edges`` samples its held-out negatives with the numpy rejection
sampler, so they are valid non-edges but not the JAX package's draws
(which come from its C++ sampler first).

Layout (as in the JAX package): edges symmetrized, self-loops added,
deduplicated and sorted by (receiver, sender), padded to a multiple of
``pad_multiple`` with inert (N−1, N−1) edges whose ``edge_mask`` is
False; ``rev_perm`` maps each edge to its reverse; ``deg`` is the masked
in-degree; ``csr_plan`` and the cluster split are built once per graph.

The readers and writers of the OGB csv layout use numpy and Python's
``%`` formatting only (no pandas): ``np.loadtxt`` gives the same arrays
as the JAX package's pandas reader on the same files, and the writer
prints ``%.6g`` as pandas' ``float_format`` does, so either package's
files load the same in both.
"""

from __future__ import annotations

import dataclasses
import os
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
    prep: str | None = None  # the layout's builder: "native" or "numpy"

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


def _prepare_edges_numpy(edges, num_nodes, *, symmetrize=True,
                         self_loops=True, pad_multiple=1024):
    """The numpy edge-layout pipeline: the fallback of :func:`prepare`
    and the parity oracle of ``native.prepare_edges``.  Returns (senders,
    receivers, mask, rev_perm, deg); ``rev_perm`` is None unless
    ``symmetrize``."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    if symmetrize and len(e):
        e = np.concatenate([e, e[:, ::-1]], axis=0)
    if self_loops:
        loops = np.stack([np.arange(num_nodes)] * 2, axis=1)
        e = np.concatenate([e, loops], axis=0) if len(e) else loops
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

    rev_perm = None
    if symmetrize:
        # reverse of (s, r) has key s·N + r; keys are sorted, so
        # searchsorted gives its index.  Padding maps to itself.
        keys_sorted = e[:, 1] * num_nodes + e[:, 0]
        rev_perm = np.arange(e_pad, dtype=np.int32)
        rev_perm[: len(e)] = np.searchsorted(
            keys_sorted, e[:, 0] * num_nodes + e[:, 1]).astype(np.int32)
    deg = np.bincount(receivers[mask], minlength=num_nodes).astype(np.float32)
    return senders, receivers, mask, rev_perm, deg


def _check_edge_range(edges, num_nodes: int) -> None:
    """IndexError on an out-of-range id, before any native stage runs (the
    C++ stages do no bounds check)."""
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
# raw-edge count from which cache="auto" caches (data/prep_cache.py):
# below it the prep is cheaper than hashing and disk IO
CACHE_AUTO_MIN_EDGES = 200_000


def prepare(
    edges: np.ndarray,
    num_nodes: int,
    x: np.ndarray,
    *,
    symmetrize: bool = True,
    self_loops: bool = True,
    pad_multiple: int = 1024,
    cluster: str | bool = "auto",
    cluster_min_pair: int = 256,
    cache: Any = "auto",
    **node_fields,
) -> Graph:
    """Symmetrize, add self-loops, dedupe, sort by receiver, pad; build
    ``deg``, the CSR plan and (``cluster=True``, or ``"auto"`` at ≥200,000
    real edges; symmetric layouts only) the cluster split.  With
    ``symmetrize=False`` the layout has ``rev_perm=None``, which the
    HGCN layers refuse.  The layout is served from the prep cache when
    ``cache`` allows it (``"auto"``: from 200,000 raw edges; ``True``
    or a :class:`~hyperspace_torch.data.prep_cache.PrepCache` forces it,
    ``False`` turns it off).  ``node_fields`` (``labels``,
    ``num_classes``, ``train_mask``, ``val_mask``, ``test_mask``) ride
    along unchanged: the layout renames no node, so any relabeling
    (:func:`apply_locality_order`) comes before, on ``x`` and labels
    alike, and masks are drawn in the new names."""
    _check_edge_range(edges, num_nodes)
    from hyperspace_torch.data import prep_cache

    e_arr = np.asarray(edges)
    pc = prep_cache.resolve(cache,
                            auto_ok=len(e_arr) >= CACHE_AUTO_MIN_EDGES)

    def build():
        return _build_edge_layout(
            e_arr, num_nodes, symmetrize=symmetrize, self_loops=self_loops,
            pad_multiple=pad_multiple, cluster=cluster,
            cluster_min_pair=cluster_min_pair)

    if pc is not None:
        layout = pc.get_or_build(
            "edge-layout",
            (e_arr.astype(np.int64, copy=False), num_nodes, symmetrize,
             self_loops, pad_multiple, str(cluster), cluster_min_pair),
            build)
    else:
        layout = build()
    return Graph(x=np.asarray(x, np.float32), num_nodes=num_nodes, **layout,
                 **node_fields)


def _build_edge_layout(edges, num_nodes, *, symmetrize, self_loops,
                       pad_multiple, cluster, cluster_min_pair) -> dict:
    """The cacheable core of :func:`prepare`: every edge-derived field of
    the :class:`Graph` (no x, labels or masks), and ``prep``, the path
    that built it."""
    from hyperspace_torch.data import native

    kw = dict(symmetrize=symmetrize, self_loops=self_loops,
              pad_multiple=pad_multiple)
    try:
        senders, receivers, mask, rev_perm, deg = native.prepare_edges(
            edges, num_nodes, **kw)
        path = "native"
        if not symmetrize:
            rev_perm = None
    except (ImportError, OSError):
        senders, receivers, mask, rev_perm, deg = _prepare_edges_numpy(
            edges, num_nodes, **kw)
        path = "numpy"
    split = None
    n_real = int(mask.sum())
    if symmetrize and (cluster is True or (
            cluster == "auto" and n_real >= CLUSTER_AUTO_MIN_EDGES)):
        # the involution backward needs a symmetric edge set
        split = build_cluster_split(senders, receivers, mask, deg,
                                    num_nodes, rev_perm=rev_perm,
                                    min_pair_edges=cluster_min_pair)
    return dict(senders=senders, receivers=receivers, edge_mask=mask,
                rev_perm=rev_perm, deg=deg,
                csr_plan=tuple(build_csr_plan(receivers, num_nodes)),
                cluster_split=split, prep=path)


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
    cache: Any = "auto",
    **node_fields,
) -> LinkSplit:
    """Hold out edges for LP eval; message passing uses only train edges.
    Negatives are uniform non-edges (Chami et al. 2019).  The host split
    is deterministic in (edges, num_nodes, fractions, seed), so it is
    cached with the graph's layout (``cache``: see :func:`prepare`)."""
    e = np.asarray(edges, np.int64)

    def build() -> dict:
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
        return dict(
            train_pos=train_pos.astype(np.int32),
            val_pos=val_pos.astype(np.int32),
            val_neg=_sample_negatives(num_nodes, len(val_pos), rng,
                                      edge_set).astype(np.int32),
            test_pos=test_pos.astype(np.int32),
            test_neg=_sample_negatives(num_nodes, len(test_pos), rng,
                                       edge_set).astype(np.int32))

    from hyperspace_torch.data import prep_cache

    pc = prep_cache.resolve(cache, auto_ok=len(e) >= CACHE_AUTO_MIN_EDGES)
    if pc is not None:
        arrs = pc.get_or_build(
            "lp-split", (e, num_nodes, val_frac, test_frac, seed), build)
    else:
        arrs = build()
    g = prepare(arrs["train_pos"], num_nodes, x, pad_multiple=pad_multiple,
                cluster_min_pair=cluster_min_pair, cache=cache,
                **node_fields)
    return LinkSplit(graph=g, **arrs)


# --- on-disk loaders and writers ----------------------------------------------


def load_cora(root: str):
    """Planetoid raw format: ``cora.content`` (id, features, label a
    line) and ``cora.cites`` (cited, citing id a line; citations of
    unknown ids are dropped).  Returns (edges [E,2], x [N,F], labels
    [N], num_classes), labels numbered in order of first appearance."""
    content = os.path.join(root, "cora.content")
    cites = os.path.join(root, "cora.cites")
    ids, feats, labels, label_ids = {}, [], [], {}
    with open(content) as f:
        for line in f:
            parts = line.strip().split()
            ids[parts[0]] = len(ids)
            feats.append([float(t) for t in parts[1:-1]])
            lab = parts[-1]
            label_ids.setdefault(lab, len(label_ids))
            labels.append(label_ids[lab])
    edges = []
    with open(cites) as f:
        for line in f:
            a, b = line.strip().split()
            if a in ids and b in ids:
                edges.append((ids[a], ids[b]))
    return (np.asarray(edges, np.int64).reshape(-1, 2),
            np.asarray(feats, np.float32), np.asarray(labels, np.int32),
            len(label_ids))


def write_cora_layout(root: str, edges: np.ndarray, x: np.ndarray,
                      labels: np.ndarray) -> None:
    """Write a graph in the Planetoid raw format :func:`load_cora` reads:
    node ``i`` as paper id ``i``, its features as ``%.6g`` and its label
    as ``class_<label>``, tab-separated; an edge (u, v) as the line
    ``u<TAB>v``."""
    os.makedirs(root, exist_ok=True)
    x = np.asarray(x, np.float32)
    labels = np.asarray(labels).reshape(-1)
    row = "%d\t" + "\t".join(["%.6g"] * x.shape[1]) + "\tclass_%d\n"
    with open(os.path.join(root, "cora.content"), "w") as f:
        for i, (feat, lab) in enumerate(zip(x.tolist(), labels.tolist())):
            f.write(row % (i, *feat, lab))
    with open(os.path.join(root, "cora.cites"), "w") as f:
        f.write(_format_rows(np.asarray(edges, np.int64), "%d", "\t"))


def _read_csv(path: str, dtype) -> np.ndarray:
    """A headerless csv matrix [rows, cols] (``np.loadtxt``'s C reader:
    the same arrays as pandas' on the same files, floats parsed as
    doubles and rounded to ``dtype``)."""
    return np.loadtxt(path, delimiter=",", dtype=dtype, ndmin=2)


def _format_rows(a: np.ndarray, fmt: str, sep: str = ",") -> str:
    """Rows of the 2-d array ``a`` as text, each value by ``fmt``, values
    by ``sep``, a row a line (Python's ``%``, 256 rows at a time)."""
    rows, cols = a.shape
    line = sep.join([fmt] * cols) + "\n"
    flat = a.ravel().tolist()
    out = []
    for i in range(0, rows, 256):
        m = min(256, rows - i)
        out.append((line * m) % tuple(flat[i * cols:(i + m) * cols]))
    return "".join(out)


def load_ogbn_arxiv(root: str):
    """OGB extracted-csv layout (``raw/edge.csv``, ``raw/node-feat.csv``,
    ``raw/node-label.csv``).  Returns (edges [E,2] int64, x [N,F] f32,
    labels [N] int32, num_classes)."""
    raw = os.path.join(root, "raw")
    edges = _read_csv(os.path.join(raw, "edge.csv"), np.int64)
    x = np.ascontiguousarray(
        _read_csv(os.path.join(raw, "node-feat.csv"), np.float32))
    labels = _read_csv(os.path.join(raw, "node-label.csv"), np.int64)
    return (edges, x, labels.astype(np.int32).reshape(-1),
            int(labels.max()) + 1)


def write_ogb_csv_layout(root: str, edges: np.ndarray, x: np.ndarray,
                         labels: np.ndarray) -> None:
    """Write a graph to the OGB extracted-csv layout
    :func:`load_ogbn_arxiv` reads (``raw/{edge,node-feat,node-label}.csv``:
    ids as ``%d``, features as ``%.6g``), the disk end of the disk →
    load → prepare → train pipeline."""
    raw = os.path.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    for name, a, fmt in (
            ("edge.csv", np.asarray(edges, np.int64).reshape(-1, 2), "%d"),
            ("node-feat.csv", np.asarray(x, np.float32), "%.6g"),
            ("node-label.csv", np.asarray(labels, np.int64).reshape(-1, 1),
             "%d")):
        with open(os.path.join(raw, name), "w") as f:
            f.write(_format_rows(a, fmt))


# --- synthetic graphs ---------------------------------------------------------


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


def community_power_law_graph(
    num_nodes: int = 169_343,
    num_edges: int = 1_166_243,
    num_classes: int = 40,
    feat_dim: int = 128,
    gamma: float = 2.6,
    p_in: float = 0.72,
    p_sub: float = 0.55,
    sub_size: int = 400,
    triadic_frac: float = 0.15,
    seed: int = 0,
):
    """Community-structured power-law graph at citation-network
    statistics (by default ogbn-arxiv's: 169,343 nodes, 1,166,243
    directed edges, 128 features, 40 classes).

    - degree-corrected SBM: degree propensities from a truncated power
      law (exponent ``gamma``), both endpoints drawn by propensity;
    - ``num_classes`` communities of power-law sizes; a ``p_in``
      fraction of edges stays in the sender's community, and of those a
      ``p_sub`` fraction in its ~``sub_size``-node sub-community;
    - triadic closure: ``triadic_frac`` of the edges join two
      receivers of one sender.

    Class = community; features = community prototype + noise.  Returns
    (edges [E, 2] directed, x [N, F], labels [N], num_classes); the draws
    follow the JAX package's exactly, so the same seed gives the same
    arrays."""
    rng = np.random.default_rng(seed)
    # truncated power-law degree propensities (inverse-transform Pareto)
    u = rng.random(num_nodes)
    prop = np.minimum(u ** (-1.0 / (gamma - 1.0)), num_nodes ** 0.5)
    prop /= prop.sum()
    # power-law community sizes via Dirichlet over a decaying base measure
    base = (1.0 / np.arange(1, num_classes + 1)) ** 0.8
    sizes = rng.dirichlet(base * num_classes)
    comm = rng.choice(num_classes, size=num_nodes, p=sizes)

    # sub-communities: each community's members in ~sub_size groups
    # (globally unique sub ids)
    sub = np.zeros(num_nodes, np.int64)
    next_sub = 0
    for c in range(num_classes):
        members = np.flatnonzero(comm == c)
        n_sub = max(1, len(members) // sub_size)
        sub[members] = next_sub + rng.integers(0, n_sub, len(members))
        next_sub += n_sub

    n_base = int(num_edges * (1.0 - triadic_frac))
    senders = rng.choice(num_nodes, size=n_base, p=prop)
    receivers = np.empty(n_base, np.int64)
    r_scope = rng.random(n_base)
    in_comm = r_scope < p_in
    in_sub = r_scope < p_in * p_sub
    out_idx = np.flatnonzero(~in_comm)
    receivers[out_idx] = rng.choice(num_nodes, size=len(out_idx), p=prop)

    def _fill_grouped(group_of, take_mask):
        """Propensity-weighted receiver draw within the sender's group."""
        take = np.flatnonzero(take_mask)
        if len(take) == 0:
            return
        gids = group_of[senders[take]]
        order = np.argsort(gids, kind="stable")
        take = take[order]
        gids = gids[order]
        starts = np.flatnonzero(np.r_[True, gids[1:] != gids[:-1]])
        ends = np.r_[starts[1:], len(gids)]
        for st, en in zip(starts, ends):
            members = np.flatnonzero(group_of == gids[st])
            pc = prop[members] / prop[members].sum()
            receivers[take[st:en]] = members[
                rng.choice(len(members), size=en - st, p=pc)]

    _fill_grouped(sub, in_sub)
    _fill_grouped(comm, in_comm & ~in_sub)
    edges = np.stack([senders, receivers], axis=1)
    edges = edges[edges[:, 0] != edges[:, 1]]

    # triadic closure: sort by sender, draw pivot edges, join each
    # pivot's receiver to its sender-sorted neighbour's receiver
    n_tri = num_edges - len(edges)
    if n_tri > 0:
        pivots = rng.choice(len(edges), size=n_tri)
        bysend = np.argsort(edges[:, 0], kind="stable")
        a = edges[bysend[pivots], :]
        b = edges[bysend[np.minimum(pivots + 1, len(edges) - 1)], :]
        share = a[:, 0] == b[:, 0]
        tri = np.stack([a[share, 1], b[share, 1]], axis=1)
        tri = tri[tri[:, 0] != tri[:, 1]]
        edges = np.concatenate([edges, tri], axis=0)[:num_edges]

    protos = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    labels = comm.astype(np.int32)
    x = protos[labels] + 0.4 * rng.normal(
        size=(num_nodes, feat_dim)).astype(np.float32)
    return edges.astype(np.int64), x, labels, num_classes


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


# the synthetic stand-ins load_graph makes without files on disk
SYNTHETIC_DEFAULTS = {
    "cora": dict(num_nodes=2048, feat_dim=64, num_classes=7),
    "ogbn-arxiv": dict(num_nodes=16384, feat_dim=128, num_classes=40)}


def load_graph(name: str, root: str | None = None, **synth_kw):
    """The dataset ``name`` from its files under ``root`` (``cora``:
    ``cora.content``; ``ogbn-arxiv``: ``raw/edge.csv``), else a
    :func:`synthetic_hierarchy` of :data:`SYNTHETIC_DEFAULTS` updated by
    ``synth_kw``.  Returns (edges, x, labels, num_classes, source), source
    "disk" or "synthetic"."""
    if root is not None:
        if name == "cora" and os.path.exists(
                os.path.join(root, "cora.content")):
            return (*load_cora(root), "disk")
        if name == "ogbn-arxiv" and os.path.exists(
                os.path.join(root, "raw", "edge.csv")):
            return (*load_ogbn_arxiv(root), "disk")
    kw = {**SYNTHETIC_DEFAULTS.get(name, {}), **synth_kw}
    return (*synthetic_hierarchy(**kw), "synthetic")


def locality_order(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """BFS relabeling that clusters neighbourhoods into contiguous id
    ranges: ``order[rank] = old_id``, BFS from the highest-degree node of
    each component, neighbours in edge order.  Runs the C++ walk
    (``data/_native/localorder.cc``), or :func:`_locality_order_python`
    without a compiler; both give the same order."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    _check_edge_range(e, num_nodes)
    from hyperspace_torch.data import native

    try:
        return native.locality_order(e, num_nodes)
    except (ImportError, OSError):
        return _locality_order_python(e, num_nodes)


def _locality_order_python(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """The Python BFS: the fallback and the parity oracle of
    ``native.locality_order``."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
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
                         method: str = "bfs", cache: Any = "auto"):
    """Relabel a graph with :func:`locality_order` (``"bfs"``) or
    :func:`community_order` (``"community"``).  Returns (edges, x, labels,
    order) with node ``order[rank]`` renamed to ``rank``.  The order is
    deterministic in (edges, n, method), so it is cached (``cache``: see
    :func:`prepare`)."""
    n = x.shape[0]
    if method not in ("community", "bfs"):
        raise ValueError(f"unknown reorder method {method!r}")
    from hyperspace_torch.data import prep_cache

    e_arr = np.asarray(edges, np.int64)
    pc = prep_cache.resolve(cache,
                            auto_ok=len(e_arr) >= CACHE_AUTO_MIN_EDGES)

    def build():
        return (community_order(e_arr, n) if method == "community"
                else locality_order(e_arr, n))

    order = (pc.get_or_build("local-order", (e_arr, n, method), build)
             if pc is not None else build())
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    new_edges = rank[e_arr]
    new_x = np.asarray(x)[order]
    new_labels = None if labels is None else np.asarray(labels)[order]
    return new_edges, new_x, new_labels, order

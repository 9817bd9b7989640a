"""Cluster-pair aggregation (counterpart of
``hyperspace_tpu/kernels/cluster.py``).

``cluster_aggregate(h, w, receivers, senders, plan, n)`` is
``out[r] = Σ_{e: receivers_e = r} w_e · h[senders_e]`` over the
block-dense ("clustered") edges, without an [E, F] message array,
accumulated in float32 and returned in h's dtype.  When h is bf16 each
weight is rounded to bf16 before its product, as the TPU kernel does in
its bf16 mode.  For tensors on a CUDA device the wrapper launches the
hand-written kernel ``csrc/cluster.cu``; for tensors on the CPU it runs
:func:`cluster_aggregate_plain`.

The host side — the (receiver block, sender block, chunk) plan and the
split of a graph's edges into clustered pairs and stragglers — is
ported array-equal to the JAX package.  The CUDA kernel needs only the
edges' (receiver block, sender block) order, not the plan; the wrapper
takes the plan for the same signature and ignores it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from hyperspace_torch.kernels import _support as S
from hyperspace_torch.kernels.segment import CARD_DTYPES, build_csr_plan, \
    round_up

_BN = 256   # receiver-block rows
_BS = 256   # sender-block rows
_BK = 512   # edges per chunk of the JAX plan


class ClusterPlan(NamedTuple):
    """Work items of the JAX kernel, receiver-block-major: four [T] int32
    arrays; ``first`` marks each receiver block's first item."""

    rb: np.ndarray
    sb: np.ndarray
    chunk: np.ndarray
    first: np.ndarray


def build_cluster_plan(receivers: np.ndarray, senders: np.ndarray,
                       num_nodes: int, bn: int = _BN, bs: int = _BS,
                       bk: int = _BK) -> ClusterPlan:
    """Plan (rb, sb, chunk) items over edges pre-sorted by (rb, sb); every
    receiver block gets at least one item."""
    r = np.asarray(receivers)
    s = np.asarray(senders)
    e_pad = round_up(max(len(r), 1), bk)
    nchunks = e_pad // bk
    nb = -(-num_nodes // bn)
    key = (r // bn).astype(np.int64) * ((num_nodes // bs) + 1) + s // bs
    if len(key) > 1 and not np.all(np.diff(key) >= 0):
        raise ValueError("cluster plan needs edges sorted by (rb, sb)")
    starts = (np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) if len(key)
              else np.zeros(0, np.int64))
    ends = np.r_[starts[1:], len(key)] if len(starts) else starts
    p_rb = ((r[starts] // bn).astype(np.int32) if len(starts)
            else np.zeros(0, np.int32))
    p_sb = ((s[starts] // bs).astype(np.int32) if len(starts)
            else np.zeros(0, np.int32))
    c0 = np.minimum(starts // bk, nchunks - 1)
    c1 = np.clip(-(-ends // bk), c0 + 1, nchunks)
    counts = (c1 - c0).astype(np.int64)

    rb_items = np.repeat(p_rb, counts)
    sb_items = np.repeat(p_sb, counts)
    chunk_items = (np.arange(counts.sum(), dtype=np.int64)
                   - np.repeat(np.cumsum(counts) - counts, counts)
                   + np.repeat(c0, counts)).astype(np.int32)

    # receiver blocks without a clustered edge get one dummy item
    present = np.zeros(nb, bool)
    present[p_rb] = True
    missing = np.flatnonzero(~present).astype(np.int32)
    rb_items = np.concatenate([rb_items, missing])
    sb_items = np.concatenate([sb_items, np.zeros(len(missing), np.int32)])
    chunk_items = np.concatenate([chunk_items,
                                  np.zeros(len(missing), np.int32)])

    order = np.argsort(rb_items, kind="stable")
    rb_items = rb_items[order].astype(np.int32)
    sb_items = sb_items[order].astype(np.int32)
    chunk_items = chunk_items[order].astype(np.int32)
    first = np.zeros(len(rb_items), np.int32)
    first[np.flatnonzero(np.r_[True, rb_items[1:] != rb_items[:-1]])] = 1
    return ClusterPlan(rb_items, sb_items, chunk_items, first)


def cluster_aggregate_plain(h: torch.Tensor, w: torch.Tensor,
                            receivers: torch.Tensor, senders: torch.Tensor,
                            num_nodes: int) -> torch.Tensor:
    """The same sum in plain PyTorch: messages w_e·h[s_e] in
    promote(h, float32) — with w rounded to bf16 first when h is bf16 —
    summed by receiver, then cast to h's dtype."""
    acc_dt = torch.promote_types(h.dtype, torch.float32)
    if h.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16)
    msgs = w.to(acc_dt)[:, None] * h[senders].to(acc_dt)
    out = torch.zeros((num_nodes, h.shape[1]), dtype=acc_dt, device=h.device)
    out.index_add_(0, receivers, msgs)
    return out.to(h.dtype)


def _launch(h: torch.Tensor, w: torch.Tensor, receivers: torch.Tensor,
            senders: torch.Tensor, num_nodes: int) -> torch.Tensor:
    S.check_cuda("cluster_aggregate", CARD_DTYPES, h)
    S.check_cuda("cluster_aggregate", (torch.float32,), w)
    S.check_cuda("cluster_aggregate", (torch.int32,), receivers, senders)
    if len({h.device, w.device, receivers.device}) != 1:
        raise ValueError("cluster_aggregate: tensors on several devices")
    e = receivers.shape[0]
    f = h.shape[1]
    ptr = torch.empty(-(-num_nodes // _BN) + 1, dtype=torch.int32,
                      device=h.device)
    out = torch.empty((num_nodes, f), dtype=h.dtype, device=h.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = S.function("cluster", "hs_cluster_aggregate",
                    [P, P, P, P, P, P, I, I, I, I, P])
    S.check(fn(h.data_ptr(), w.data_ptr(), receivers.data_ptr(),
               senders.data_ptr(), ptr.data_ptr(), out.data_ptr(), e,
               num_nodes, f, int(h.dtype == torch.bfloat16),
               S.stream_ptr(h)), "cluster_aggregate")
    cluster_aggregate.launches += 1
    return out


def cluster_aggregate(h: torch.Tensor, w: torch.Tensor,
                      receivers: torch.Tensor, senders: torch.Tensor, plan,
                      num_nodes: int) -> torch.Tensor:
    """out[r] = Σ_{e: receivers_e = r} w_e · h[senders_e].

    ``h: [N, F]``, ``w: [E]`` float32 (0 on padding), ``receivers`` and
    ``senders``: [E] int32, sorted by (receiver // 256, sender // 256) as
    :func:`build_cluster_split` leaves them; ``plan`` the JAX kernel's
    :class:`ClusterPlan` (accepted for the same signature, not needed
    here).  An empty edge set gives zeros.  CUDA tensors go through
    ``csrc/cluster.cu``; CPU tensors through
    :func:`cluster_aggregate_plain`."""
    del plan
    if h.ndim != 2 or not (w.shape == receivers.shape == senders.shape):
        raise ValueError(f"cluster_aggregate: want [N, F] h and [E] edges; "
                         f"got {tuple(h.shape)}, {tuple(w.shape)}, "
                         f"{tuple(receivers.shape)}, {tuple(senders.shape)}")
    if h.device.type == "cpu" and receivers.device.type == "cpu":
        return cluster_aggregate_plain(h, w, receivers, senders, num_nodes)
    if h.device.type != "cuda":
        raise ValueError(f"cluster_aggregate: unsupported device {h.device}")
    if receivers.shape[0] == 0:
        return torch.zeros((num_nodes, h.shape[1]), dtype=h.dtype,
                           device=h.device)
    return _launch(h, w, receivers, senders, num_nodes)


cluster_aggregate.launches = 0


class ClusterSplit(NamedTuple):
    """Host result of :func:`build_cluster_split`: the clustered edges
    ((rb, sb)-sorted, with their plan) and the stragglers (receiver-
    sorted, padded, with their CSR plan); ``*_wf``/``*_wb`` are the mean
    weights 1/deg of each edge's receiver and sender (the involution
    backward's weights).  ``s_rev_local``/``s_mask`` are the straggler
    involution and validity mask, None without ``rev_perm``."""

    c_recv: np.ndarray
    c_send: np.ndarray
    c_wf: np.ndarray
    c_wb: np.ndarray
    c_plan: ClusterPlan
    s_recv: np.ndarray
    s_send: np.ndarray
    s_wf: np.ndarray
    s_wb: np.ndarray
    s_plan: tuple
    frac_clustered: float
    s_rev_local: np.ndarray | None = None
    s_mask: np.ndarray | None = None


def build_cluster_split(senders: np.ndarray, receivers: np.ndarray,
                        edge_mask: np.ndarray, deg: np.ndarray,
                        num_nodes: int, bn: int = _BN, bs: int = _BS,
                        bk: int = _BK, min_pair_edges: int = 256,
                        rev_perm: np.ndarray | None = None) -> ClusterSplit:
    """Route (receiver block, sender block) pairs with at least
    ``min_pair_edges`` edges to the cluster kernel and the rest to the
    straggler CSR path.  Both subsets are closed under edge reversal
    (a pair and its mirror have equal counts) when ``bn == bs``."""
    if bn != bs:
        raise ValueError(
            f"build_cluster_split requires bn == bs (got bn={bn}, bs={bs}): "
            "the split is closed under edge reversal only under identical "
            "receiver and sender blockings")
    mask = np.asarray(edge_mask)
    pos = np.flatnonzero(mask)
    r = np.asarray(receivers)[mask]
    s = np.asarray(senders)[mask]
    d = np.maximum(np.asarray(deg), 1.0).astype(np.float32)
    nsb = num_nodes // bs + 1
    key = (r // bn).astype(np.int64) * nsb + s // bs
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    _, inv, counts = np.unique(key_s, return_inverse=True,
                               return_counts=True)
    dense = counts[inv] >= min_pair_edges
    c_idx = order[dense]
    s_idx = np.sort(order[~dense])          # back to receiver-ascending
    c_recv, c_send = r[c_idx], s[c_idx]
    s_recv, s_send = r[s_idx], s[s_idx]

    c_plan = build_cluster_plan(c_recv, c_send, num_nodes, bn, bs, bk)
    e_s = round_up(max(len(s_recv), 1), bk)
    s_recv_p = np.full(e_s, num_nodes - 1, np.int32)
    s_send_p = np.zeros(e_s, np.int32)
    s_wf = np.zeros(e_s, np.float32)
    s_wb = np.zeros(e_s, np.float32)
    s_recv_p[: len(s_recv)] = s_recv
    s_send_p[: len(s_send)] = s_send
    s_wf[: len(s_recv)] = 1.0 / d[s_recv]
    s_wb[: len(s_recv)] = 1.0 / d[s_send]
    s_plan = tuple(build_csr_plan(s_recv_p, num_nodes, bn=128, bk=bk))

    maps: dict = {}
    if rev_perm is not None:
        rp = np.asarray(rev_perm)
        loc = np.full(len(mask), -1, np.int64)
        loc[pos[s_idx]] = np.arange(len(s_idx))
        s_rev_local = np.arange(e_s, dtype=np.int32)
        s_rev_local[: len(s_idx)] = loc[rp[pos[s_idx]]]
        if len(s_idx) and s_rev_local[: len(s_idx)].min() < 0:
            raise AssertionError(
                "straggler set not closed under edge reversal")
        s_mask = np.zeros(e_s, bool)
        s_mask[: len(s_idx)] = True
        maps = dict(s_rev_local=s_rev_local, s_mask=s_mask)

    return ClusterSplit(
        c_recv=c_recv.astype(np.int32), c_send=c_send.astype(np.int32),
        c_wf=(1.0 / d[c_recv]), c_wb=(1.0 / d[c_send]),
        c_plan=c_plan,
        s_recv=s_recv_p, s_send=s_send_p, s_wf=s_wf, s_wb=s_wb,
        s_plan=s_plan,
        frac_clustered=float(len(c_recv)) / max(len(r), 1),
        **maps,
    )

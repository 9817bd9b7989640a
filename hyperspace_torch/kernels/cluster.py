"""Cluster-pair aggregation (counterpart of
``hyperspace_tpu/kernels/cluster.py``).

Three functions over the block-dense ("clustered") edges, none writing
an [E, F] message array, all accumulating in float32:

- ``cluster_aggregate(h, w, receivers, senders, plan, n)`` is
  ``out[r] = Σ_{e: receivers_e = r} w_e · h[senders_e]``, returned in h's
  dtype (the mean path);
- ``cluster_att_fwd`` gives the attention arm's unnormalised
  ``[N, F+1]`` (num | den) partials, the weights computed from the two
  score vectors; ``cluster_att_bwd`` its backward.

When h is bf16 each weight is rounded to bf16 before its product, and
the attention backward rounds the cotangent rows to bf16, as the TPU
kernels do in their bf16 mode.  For tensors on a CUDA device the
wrappers launch the hand-written kernels in ``csrc/cluster.cu``; for
tensors on the CPU they run their ``*_plain`` versions.

The host side — the (receiver block, sender block, chunk) plan and the
split of a graph's edges into clustered pairs and stragglers — is
ported array-equal to the JAX package.  The CUDA kernels do not use
that plan (the wrappers take it for the same signature and ignore it):
all three read the port's own row plan
(:class:`ClusterRows`), which :func:`build_cluster_split` builds once per
graph and ``rows=`` passes in; without it, a CUDA call builds one on the
card first (counted in ``row_plan_builds``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from hyperspace_torch.kernels import _support as S
from hyperspace_torch.kernels.segment import CARD_DTYPES, build_csr_plan, \
    round_up, true_div

_BN = 256   # receiver-block rows
_BS = 256   # sender-block rows
_BK = 512   # edges per chunk of the JAX plan

# row plans built on the card by a wrapper called without ``rows=``
row_plan_builds = 0


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


class ClusterRows(NamedTuple):
    """The row plan of an edge set: its edges in row order, stable (a
    row's edges keep their arrival order).  numpy arrays on the host,
    int32 tensors on the card (:func:`rows_on`).

    ``row_ptr [N + 1]``: row i's slots are ``row_ptr[i]:row_ptr[i+1]``;
    ``perm [E]``: each slot's arrival index (its weight's place), None
    where the edges (and weights) are in row order already;
    ``recv``, ``send [E]``: each slot's receiver (ascending) and sender;
    ``rev [E]``: the slot of each slot's reverse edge (an involution),
    None unless asked for."""

    row_ptr: object
    perm: object
    recv: object
    send: object
    rev: object = None


def build_cluster_rows(receivers: np.ndarray, senders: np.ndarray,
                       num_nodes: int, with_rev: bool = False) -> ClusterRows:
    """The :class:`ClusterRows` of an edge list, on the host.  With
    ``with_rev`` the k-th (receiver, sender) = (a, b) slot is paired with
    the k-th (b, a) slot; raises when the edge multiset is not closed
    under reversal."""
    r = np.asarray(receivers).astype(np.int64)
    s = np.asarray(senders).astype(np.int64)
    if r.shape != s.shape or r.ndim != 1:
        raise ValueError(f"cluster rows: want [E] receivers and senders; "
                         f"got {r.shape}, {s.shape}")
    if len(r) and (min(r.min(), s.min()) < 0
                   or max(r.max(), s.max()) >= num_nodes):
        raise ValueError(f"cluster rows: node ids outside [0, {num_nodes})")
    perm = np.argsort(r, kind="stable")
    rr, ss = r[perm], s[perm]
    row_ptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(np.bincount(rr, minlength=num_nodes), out=row_ptr[1:])
    rev = None
    if with_rev:
        fwd = np.lexsort((ss, rr))      # slots by (receiver, sender)
        bwd = np.lexsort((rr, ss))      # slots by (sender, receiver)
        if not (np.array_equal(rr[fwd], ss[bwd])
                and np.array_equal(ss[fwd], rr[bwd])):
            raise ValueError("cluster rows: the edges are not closed under "
                             "reversal")
        rev = np.empty(len(r), np.int32)
        rev[fwd] = bwd
    i32 = np.int32
    return ClusterRows(row_ptr.astype(i32), perm.astype(i32), rr.astype(i32),
                       ss.astype(i32), rev)


def cluster_rows_on_device(receivers: torch.Tensor, senders: torch.Tensor,
                           num_nodes: int,
                           with_rev: bool = False) -> ClusterRows:
    """:func:`build_cluster_rows` on the tensors' device (torch's stable
    sorts), counted in ``row_plan_builds``."""
    global row_plan_builds
    r, s = receivers.long(), senders.long()
    perm = torch.sort(r, stable=True).indices
    rr, ss = r[perm], s[perm]
    row_ptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=r.device)
    torch.cumsum(torch.bincount(rr, minlength=num_nodes), 0,
                 out=row_ptr[1:])
    rev = None
    if with_rev:
        fwd = torch.sort(rr * num_nodes + ss, stable=True).indices
        bwd = torch.sort(ss * num_nodes + rr, stable=True).indices
        if not torch.equal(rr[fwd] * num_nodes + ss[fwd],
                           ss[bwd] * num_nodes + rr[bwd]):
            raise ValueError("cluster rows: the edges are not closed under "
                             "reversal")
        rev = torch.empty_like(fwd).scatter_(0, fwd, bwd).int()
    row_plan_builds += 1
    return ClusterRows(row_ptr.int(), perm.int(), rr.int(), ss.int(), rev)


def rows_on(rows: ClusterRows, device) -> ClusterRows:
    """A host :class:`ClusterRows` as int32 tensors on ``device``."""
    return ClusterRows(*(None if a is None else torch.as_tensor(
        np.asarray(a, np.int32), device=device) for a in rows))


def _check_rows(name: str, rows: ClusterRows, e: int, num_nodes: int,
                need_rev: bool = False) -> None:
    if tuple(rows.row_ptr.shape) != (num_nodes + 1,) or tuple(
            rows.send.shape) != (e,):
        raise ValueError(f"{name}: a row plan of {rows.send.shape[0]} edges "
                         f"over {rows.row_ptr.shape[0] - 1} rows for {e} "
                         f"edges over {num_nodes}")
    if need_rev and rows.rev is None:
        raise ValueError(f"{name}: the row plan has no reverse slots "
                         "(build it with with_rev=True)")


def _rows_for_launch(name: str, rows, receivers: torch.Tensor,
                     senders: torch.Tensor, num_nodes: int,
                     need_rev: bool = False) -> ClusterRows:
    """``rows`` checked for a launch, or built on the card when None."""
    if rows is None:
        rows = cluster_rows_on_device(receivers, senders, num_nodes, need_rev)
    _check_rows(name, rows, receivers.shape[0], num_nodes, need_rev)
    S.check_cuda(name, (torch.int32,), receivers,
                 *(a for a in rows if a is not None))
    return rows


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


def cluster_aggregate(h: torch.Tensor, w: torch.Tensor,
                      receivers: torch.Tensor, senders: torch.Tensor, plan,
                      num_nodes: int,
                      rows: ClusterRows | None = None) -> torch.Tensor:
    """out[r] = Σ_{e: receivers_e = r} w_e · h[senders_e].

    ``h: [N, F]``, ``w: [E]`` float32 (0 on padding), ``receivers`` and
    ``senders``: [E] int32 (:func:`build_cluster_split` leaves them sorted
    by (receiver // 256, sender // 256)); ``plan`` the JAX kernel's
    :class:`ClusterPlan` (accepted for the same signature, not needed
    here); ``rows`` the edges' :class:`ClusterRows` on h's device (on the
    card, built there when None).  An empty edge set gives zeros.  CUDA
    tensors go through ``csrc/cluster.cu``; CPU tensors through
    :func:`cluster_aggregate_plain`."""
    del plan
    if h.ndim != 2 or not (w.shape == receivers.shape == senders.shape):
        raise ValueError(f"cluster_aggregate: want [N, F] h and [E] edges; "
                         f"got {tuple(h.shape)}, {tuple(w.shape)}, "
                         f"{tuple(receivers.shape)}, {tuple(senders.shape)}")
    e, f = receivers.shape[0], h.shape[1]
    if h.device.type == "cpu" and receivers.device.type == "cpu":
        if rows is not None:
            _check_rows("cluster_aggregate", rows, e, num_nodes)
        return cluster_aggregate_plain(h, w, receivers, senders, num_nodes)
    if h.device.type != "cuda":
        raise ValueError(f"cluster_aggregate: unsupported device {h.device}")
    S.check_cuda("cluster_aggregate", CARD_DTYPES, h)
    S.check_cuda("cluster_aggregate", (torch.float32,), w)
    S.check_cuda("cluster_aggregate", (torch.int32,), receivers, senders)
    if len({h.device, w.device, receivers.device}) != 1:
        raise ValueError("cluster_aggregate: tensors on several devices")
    if e == 0:
        return torch.zeros((num_nodes, f), dtype=h.dtype, device=h.device)
    rows = _rows_for_launch("cluster_aggregate", rows, receivers, senders,
                            num_nodes)
    # the kernel reads the weights in row order: the step's are stored so
    w = w if rows.perm is None else w[rows.perm.long()]
    out = torch.empty((num_nodes, f), dtype=h.dtype, device=h.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = S.function("cluster", "hs_cluster_aggregate",
                    [P, P, P, P, P, P, I, I, I, I, P])
    S.check(fn(h.data_ptr(), w.data_ptr(), rows.row_ptr.data_ptr(),
               rows.recv.data_ptr(), rows.send.data_ptr(), out.data_ptr(), e,
               num_nodes, f, int(h.dtype == torch.bfloat16),
               S.stream_ptr(h)), "cluster_aggregate")
    cluster_aggregate.launches += 1
    return out


cluster_aggregate.launches = 0


# --- in-tile attention ----------------------------------------------------------


def att_squash(pre: torch.Tensor, bound: float, slope: float):
    """The bounded-logit softmax weight ``w = exp(B·tanh(leaky(pre)/B))``
    and its derivative ``w·(1 − tanh²)·leaky'(pre)`` (leaky' is 1 at 0),
    as the JAX kernels' ``_att_squash``."""
    pos = pre >= 0
    lam = torch.where(pos, pre, slope * pre)
    th = torch.tanh(true_div(lam, bound))
    w = torch.exp(bound * th)
    dfac = w * (1.0 - th * th) * torch.where(
        pos, torch.ones_like(pre), torch.full_like(pre, slope))
    return w, dfac


def cluster_att_fwd_plain(h: torch.Tensor, alpha_s: torch.Tensor,
                          alpha_r: torch.Tensor, receivers: torch.Tensor,
                          senders: torch.Tensor, num_nodes: int,
                          negative_slope: float = 0.2,
                          bound: float = 30.0) -> torch.Tensor:
    """:func:`cluster_att_fwd` in plain PyTorch, in promote(h, float32)."""
    acc_dt = torch.promote_types(h.dtype, torch.float32)
    pre = alpha_s.to(acc_dt)[senders] + alpha_r.to(acc_dt)[receivers]
    w, _ = att_squash(pre, bound, negative_slope)
    if h.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).to(acc_dt)
    msgs = torch.cat([w[:, None] * h[senders].to(acc_dt), w[:, None]], 1)
    out = torch.zeros((num_nodes, h.shape[1] + 1), dtype=acc_dt,
                      device=h.device)
    return out.index_add_(0, receivers, msgs)


def cluster_att_bwd_plain(g_ext: torch.Tensor, h: torch.Tensor,
                          alpha_s: torch.Tensor, alpha_r: torch.Tensor,
                          receivers: torch.Tensor, senders: torch.Tensor,
                          num_nodes: int, negative_slope: float = 0.2,
                          bound: float = 30.0):
    """:func:`cluster_att_bwd` in plain PyTorch, in promote(h, float32),
    through the involution as the kernel computes it."""
    acc_dt = torch.promote_types(h.dtype, torch.float32)
    f = h.shape[1]
    g = g_ext.to(acc_dt)
    if h.dtype == torch.bfloat16:
        g = g.to(torch.bfloat16).to(acc_dt)
    hf = h.to(acc_dt)
    a_s, a_r = alpha_s.to(acc_dt), alpha_r.to(acc_dt)
    _, dfac = att_squash(a_s[senders] + a_r[receivers], bound,
                         negative_slope)
    w_rev, dfac_rev = att_squash(a_s[receivers] + a_r[senders], bound,
                                 negative_slope)
    if h.dtype == torch.bfloat16:
        w_rev = w_rev.to(torch.bfloat16).to(acc_dt)
    g_s = g[senders]
    dw = torch.sum(g[receivers, :f] * hf[senders], dim=-1) + g[receivers, f]
    dw_rev = torch.sum(g_s[:, :f] * hf[receivers], dim=-1) + g_s[:, f]
    zeros = dict(dtype=acc_dt, device=h.device)
    dh = torch.zeros((num_nodes, f), **zeros).index_add_(
        0, receivers, w_rev[:, None] * g_s[:, :f])
    da_s = torch.zeros(num_nodes, **zeros).index_add_(0, receivers,
                                                      dw_rev * dfac_rev)
    da_r = torch.zeros(num_nodes, **zeros).index_add_(0, receivers,
                                                      dw * dfac)
    return dh, da_s, da_r


def _check_att(name: str, h: torch.Tensor, alpha_s: torch.Tensor,
               alpha_r: torch.Tensor, receivers: torch.Tensor,
               senders: torch.Tensor, num_nodes: int) -> None:
    if (h.ndim != 2 or h.shape[0] != num_nodes or h.shape[1] < 1
            or alpha_s.shape != (num_nodes,)
            or alpha_r.shape != (num_nodes,)
            or receivers.ndim != 1 or senders.shape != receivers.shape):
        raise ValueError(f"{name}: want [N, F] h, [N] scores and [E] edges "
                         f"with N = {num_nodes}; got {tuple(h.shape)}, "
                         f"{tuple(alpha_s.shape)}, {tuple(alpha_r.shape)}, "
                         f"{tuple(receivers.shape)}, {tuple(senders.shape)}")


def _check_att_cuda(name: str, h: torch.Tensor, floats: tuple,
                    ids: tuple) -> None:
    S.check_cuda(name, CARD_DTYPES, h)
    S.check_cuda(name, (torch.float32,), *floats)
    S.check_cuda(name, (torch.int32,), *ids)
    if len({t.device for t in (h, *floats, *ids)}) != 1:
        raise ValueError(f"{name}: tensors on several devices")


def cluster_att_fwd(h: torch.Tensor, alpha_s: torch.Tensor,
                    alpha_r: torch.Tensor, receivers: torch.Tensor,
                    senders: torch.Tensor, plan, num_nodes: int,
                    negative_slope: float = 0.2, bound: float = 30.0,
                    rows: ClusterRows | None = None) -> torch.Tensor:
    """``[N, F+1]`` f32 unnormalised attention partials over the
    clustered edges: ``out[r] = Σ_e w_e·[h[s_e] | 1]`` with
    ``w_e = exp(bound·tanh(leaky(α_s[s_e] + α_r[r_e]) / bound))``.

    ``h: [N, F]`` (bf16 or f32), ``alpha_s``/``alpha_r: [N]`` f32,
    ``receivers``/``senders: [E]`` int32; ``plan`` accepted for the JAX
    signature, not needed; ``rows`` the edges' :class:`ClusterRows` on
    h's device (on the card, built there when None).  CUDA tensors go
    through ``csrc/cluster.cu``; CPU tensors through
    :func:`cluster_att_fwd_plain`."""
    del plan
    _check_att("cluster_att_fwd", h, alpha_s, alpha_r, receivers, senders,
               num_nodes)
    e, f = receivers.shape[0], h.shape[1]
    if h.device.type == "cpu" and receivers.device.type == "cpu":
        if rows is not None:
            _check_rows("cluster_att_fwd", rows, e, num_nodes)
        return cluster_att_fwd_plain(h, alpha_s, alpha_r, receivers,
                                     senders, num_nodes, negative_slope,
                                     bound)
    if h.device.type != "cuda":
        raise ValueError(f"cluster_att_fwd: unsupported device {h.device}")
    _check_att_cuda("cluster_att_fwd", h, (alpha_s, alpha_r),
                    (receivers, senders))
    if e == 0:
        return torch.zeros((num_nodes, f + 1), dtype=torch.float32,
                           device=h.device)
    rows = _rows_for_launch("cluster_att_fwd", rows, receivers, senders,
                            num_nodes)
    out = torch.empty((num_nodes, f + 1), dtype=torch.float32,
                      device=h.device)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = S.function("cluster", "hs_cluster_att_fwd",
                    [P, P, P, P, P, P, P, I, I, I, I, F, F, P])
    S.check(fn(h.data_ptr(), alpha_s.data_ptr(), alpha_r.data_ptr(),
               rows.row_ptr.data_ptr(), rows.recv.data_ptr(),
               rows.send.data_ptr(), out.data_ptr(), e, num_nodes, f,
               int(h.dtype == torch.bfloat16), bound, negative_slope,
               S.stream_ptr(h)), "cluster_att_fwd")
    cluster_att_fwd.launches += 1
    return out


cluster_att_fwd.launches = 0


def cluster_att_bwd(g_ext: torch.Tensor, h: torch.Tensor,
                    alpha_s: torch.Tensor, alpha_r: torch.Tensor,
                    receivers: torch.Tensor, senders: torch.Tensor, plan,
                    num_nodes: int, negative_slope: float = 0.2,
                    bound: float = 30.0, rows: ClusterRows | None = None):
    """Backward of :func:`cluster_att_fwd` from the cotangent
    ``g_ext: [N, F+1]`` f32 (d_num | d_den): returns
    ``(dh [N, F], d_alpha_s [N], d_alpha_r [N])``, f32, each indexed by
    receiver through the edge involution, so the edge set must be closed
    under reversal (the cluster split's is).  ``rows``: the edges'
    :class:`ClusterRows` with ``rev`` on h's device (on the card, built
    there when None).  CUDA tensors go through ``csrc/cluster.cu``; CPU
    tensors through :func:`cluster_att_bwd_plain`."""
    del plan
    _check_att("cluster_att_bwd", h, alpha_s, alpha_r, receivers, senders,
               num_nodes)
    e, f = receivers.shape[0], h.shape[1]
    if g_ext.shape != (num_nodes, f + 1):
        raise ValueError(f"cluster_att_bwd: want a [N, F+1] cotangent; got "
                         f"{tuple(g_ext.shape)} for h {tuple(h.shape)}")
    if h.device.type == "cpu" and receivers.device.type == "cpu":
        if rows is not None:
            _check_rows("cluster_att_bwd", rows, e, num_nodes, need_rev=True)
        return cluster_att_bwd_plain(g_ext, h, alpha_s, alpha_r, receivers,
                                     senders, num_nodes, negative_slope,
                                     bound)
    if h.device.type != "cuda":
        raise ValueError(f"cluster_att_bwd: unsupported device {h.device}")
    _check_att_cuda("cluster_att_bwd", h, (g_ext, alpha_s, alpha_r),
                    (receivers, senders))
    dev = h.device
    if e == 0:
        z = torch.zeros(num_nodes, dtype=torch.float32, device=dev)
        return torch.zeros((num_nodes, f), dtype=torch.float32,
                           device=dev), z, z.clone()
    rows = _rows_for_launch("cluster_att_bwd", rows, receivers, senders,
                            num_nodes, need_rev=True)
    dh = torch.empty((num_nodes, f), dtype=torch.float32, device=dev)
    da_s = torch.empty(num_nodes, dtype=torch.float32, device=dev)
    da_r = torch.empty(num_nodes, dtype=torch.float32, device=dev)
    scratch = torch.empty(e, dtype=torch.float32, device=dev)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = S.function("cluster", "hs_cluster_att_bwd",
                    [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, F, P])
    S.check(fn(g_ext.data_ptr(), h.data_ptr(), alpha_s.data_ptr(),
               alpha_r.data_ptr(), rows.row_ptr.data_ptr(),
               rows.recv.data_ptr(), rows.send.data_ptr(),
               rows.rev.data_ptr(), dh.data_ptr(), da_s.data_ptr(),
               da_r.data_ptr(), scratch.data_ptr(), e, num_nodes, f,
               int(h.dtype == torch.bfloat16), bound, negative_slope,
               S.stream_ptr(h)), "cluster_att_bwd")
    cluster_att_bwd.launches += 1
    return dh, da_s, da_r


cluster_att_bwd.launches = 0


class ClusterSplit(NamedTuple):
    """Host result of :func:`build_cluster_split`: the clustered edges
    ((rb, sb)-sorted, with their plan) and the stragglers (receiver-
    sorted, padded, with their CSR plan); ``*_wf``/``*_wb`` are the mean
    weights 1/deg of each edge's receiver and sender (the involution
    backward's weights).  ``s_rev_local``/``s_mask`` are the straggler
    involution and validity mask, None without ``rev_perm``; ``c_rows``
    the clustered edges' :class:`ClusterRows` (the port's own, for the
    CUDA kernels; with ``rev`` when ``rev_perm`` is given)."""

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
    c_rows: ClusterRows | None = None


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
        c_rows=build_cluster_rows(c_recv, c_send, num_nodes,
                                  with_rev=rev_perm is not None),
    )

"""Poincaré embeddings (Nickel & Kiela 2017) — counterpart of
``hyperspace_tpu/models/poincare_embed.py``.

An embedding table on the curvature-c ball, trained so that ancestors
are close to their descendants: for a positive pair (u, v) and K sampled
negatives n₁..n_K,

    loss = -log [ exp(-d(u,v)) / (exp(-d(u,v)) + Σ exp(-d(u,nᵢ))) ],

with Riemannian SGD (burn-in) or Riemannian Adam (:mod:`optim`).

Four step paths, as in JAX:

- dense (:func:`train_step`): batch and negatives drawn on the device from
  the state's ``torch.Generator``, or hard negatives mined from a drawn
  pool through ``kernels/scan_topk.py`` (``neg_mode="mined"``); the
  gradient and the update cover the whole table;
- sparse (:func:`train_step_sparse`): the batch's unique rows only
  (``torch.unique`` padded to ``B·(2+K)`` slots with the sentinel
  ``num_nodes``, sentinel rows never written back); it syncs the host,
  so it is never graphed;
- planned (:func:`train_step_sparse_planned`) and packed
  (:func:`train_step_planned_packed`): batches and their sorted index
  plans built on the host in numpy (:func:`plan_sparse_steps`), the
  cotangent summed per row by the sorted segment sum
  (``kernels/segment.py:csr_segment_sum``); the packed state keeps table
  and moments side by side, one gather and one scatter a step;
  :func:`train_epoch_planned_hosted` runs it over a device hot-row cache
  for the host-resident trainer (``train/host_embed.py``).

:func:`train_epoch_scan` and :func:`train_epoch_planned_packed` run an
epoch as one chunk (``train/loop.py``: a CUDA graph of one step replayed,
no host read between steps).  On CUDA tensors the ball update of both
optimizers launches ``kernels.expmap`` (and ``kernels.ptransp`` for Adam)
and :func:`evaluate` ranks through ``kernels/distmat.py:pdist``; on the
CPU the same wrappers run their plain versions.

Steps with a table (sparse, planned, packed) donate the state: its
table, moments or packed rows are updated in place, as JAX donates them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from hyperspace_torch import precision as precision_mod
from hyperspace_torch.kernels._support import resolve_device
from hyperspace_torch.manifolds import PoincareBall
from hyperspace_torch.optim.common import apply_updates
from hyperspace_torch.optim.radam import RAdamState, riemannian_adam
from hyperspace_torch.optim.rsgd import RSGDState, riemannian_sgd
from hyperspace_torch.train.loop import make_chunked_stepper


@dataclasses.dataclass(frozen=True)
class PoincareEmbedConfig:
    num_nodes: int = 0
    dim: int = 10  # BASELINE.json configs[0]: 10-dim ball
    c: float = 1.0
    lr: float = 0.3
    neg_samples: int = 10
    batch_size: int = 512
    burnin_steps: int = 100
    burnin_factor: float = 0.01
    init_scale: float = 1e-3
    dtype: Any = torch.float32
    optimizer: str = "rsgd"        # "rsgd" (Nickel & Kiela) or "radam"
    sparse: bool = False           # make_train_step picks train_step_sparse
    # "uniform" draws neg_samples ids a row; "mined" draws a shared pool
    # of mine_pool ids (0 = max(4·neg_samples, 64)) and keeps each row's
    # neg_samples nearest pool members (dense paths only)
    neg_mode: str = "uniform"
    mine_pool: int = 0
    # validated only: the table is a master parameter and the step is all
    # boundary math, so "bf16" computes exactly as "f32" by design
    precision: str = "f32"


class TrainState(NamedTuple):
    table: torch.Tensor              # [N, d] points on the ball
    opt_state: Any                   # RSGDState or RAdamState
    generator: torch.Generator       # the dense steps' draws
    step: torch.Tensor               # 0-dim int64


def init_table(cfg: PoincareEmbedConfig,
               generator: torch.Generator) -> torch.Tensor:
    """Uniform in [-init_scale, init_scale)^d (N&K 2017 init)."""
    u = torch.rand((cfg.num_nodes, cfg.dim), generator=generator,
                   dtype=cfg.dtype, device=generator.device)
    return -cfg.init_scale + u * (2.0 * cfg.init_scale)


def make_optimizer(cfg: PoincareEmbedConfig):
    """RSGD with burn-in, or RAdam with burn-in as a schedule; the whole
    table is tagged with the ball."""
    ball = PoincareBall(cfg.c)
    if cfg.optimizer == "radam":
        lr = cfg.lr
        if cfg.burnin_steps > 0:
            factor, steps = cfg.burnin_factor, cfg.burnin_steps

            def lr(n):
                base = torch.full((), cfg.lr, dtype=torch.float64,
                                  device=n.device)
                return torch.where(n < steps, base * factor, base)
        return riemannian_adam(lr, tags=ball)
    if cfg.optimizer != "rsgd":
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return riemannian_sgd(cfg.lr, tags=ball, burnin_steps=cfg.burnin_steps,
                          burnin_factor=cfg.burnin_factor)


def _ranking_loss(u, cv, u_idx, v_idx, neg_idx, c):
    """-log softmax(-d)[positive]: u [B, d] against cv [B, 1+K, d]
    (column 0 the positive v); negatives equal to v or to u itself are
    masked with -inf.  The loss body every step path shares."""
    d = PoincareBall(c).dist(u[:, None, :], cv)
    logits = -d
    collide = (neg_idx == v_idx[:, None]) | (neg_idx == u_idx[:, None])
    mask = torch.cat([torch.zeros_like(collide[:, :1]), collide], dim=1)
    logits = torch.where(mask, float("-inf"), logits)
    return torch.mean(torch.logsumexp(logits, dim=1) - logits[:, 0])


def loss_fn(table, u_idx, v_idx, neg_idx, c) -> torch.Tensor:
    """Batch loss. u_idx, v_idx: [B]; neg_idx: [B, K]."""
    cand = torch.cat([v_idx[:, None], neg_idx], dim=1)
    return _ranking_loss(table[u_idx], table[cand], u_idx, v_idx, neg_idx,
                         c)


def mine_pool_size(cfg: PoincareEmbedConfig) -> int:
    return cfg.mine_pool or max(4 * cfg.neg_samples, 64)


def _mine_negatives(cfg: PoincareEmbedConfig, table: torch.Tensor,
                    u_idx: torch.Tensor,
                    pool_idx: torch.Tensor) -> torch.Tensor:
    """Each row's ``neg_samples`` nearest members of the pool
    ``pool_idx`` under the ball metric, by one scan-top-k over the pool's
    rows (``kernels/scan_topk.py``); ties go to the earlier pool slot.
    Mining picks ids and carries no gradient."""
    from hyperspace_torch.kernels import scan_topk as fused

    tbl = table.detach()
    _, sel = fused.scan_topk(
        tbl[pool_idx], tbl[u_idx],
        torch.zeros(u_idx.shape, dtype=torch.int32, device=u_idx.device),
        0, spec=("poincare", cfg.c), k=cfg.neg_samples,
        n=pool_idx.shape[0], exclude_self=False)
    return pool_idx[sel.long()]                           # [B, K]


def _check_neg_mode(cfg: PoincareEmbedConfig, *, dense: bool) -> None:
    if cfg.neg_mode not in ("uniform", "mined"):
        raise ValueError(
            f"neg_mode must be 'uniform' or 'mined'; got {cfg.neg_mode!r}")
    if cfg.neg_mode != "mined":
        return
    if not dense:
        raise ValueError(
            "neg_mode='mined' needs the dense step paths (mining reads the "
            "live table; the host-planned sparse paths draw their "
            "negatives before the embeddings exist) — drop sparse=true or "
            "neg_mode")
    if not 0 < cfg.neg_samples <= mine_pool_size(cfg):
        raise ValueError(f"mine_pool={cfg.mine_pool} must hold at least "
                         f"neg_samples={cfg.neg_samples} candidates")
    from hyperspace_torch.kernels import scan_topk as fused

    # mining is the scan kernel itself, with no other route: its caps
    # fail here, at config time
    if not fused.supports(("poincare", cfg.c), k=cfg.neg_samples,
                          dim=cfg.dim):
        raise ValueError(
            f"neg_mode='mined' mines through the fused scan-top-k kernel, "
            f"which caps neg_samples at {fused.FUSED_MAX_K} and dim at "
            f"{fused.FUSED_MAX_DIM}; got neg_samples={cfg.neg_samples}, "
            f"dim={cfg.dim} — lower them or drop neg_mode")


# --- draws ---------------------------------------------------------------------


def _draw_batch(cfg, gen, pairs):
    rows = torch.randint(0, pairs.shape[0], (cfg.batch_size,),
                         generator=gen, device=pairs.device)
    batch = pairs[rows]
    return batch[:, 0], batch[:, 1]


def _draw_ids(cfg, gen, shape, device):
    return torch.randint(0, cfg.num_nodes, shape, generator=gen,
                         device=device)


def _draw_negatives(cfg, state, u_idx, pairs):
    if cfg.neg_mode == "mined":
        pool = _draw_ids(cfg, state.generator, (mine_pool_size(cfg),),
                         pairs.device)
        return _mine_negatives(cfg, state.table, u_idx, pool)
    return _draw_ids(cfg, state.generator,
                     (cfg.batch_size, cfg.neg_samples), pairs.device)


# --- the dense step --------------------------------------------------------------


def _value_and_grad(fn, x):
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        loss = fn(x)
        (g,) = torch.autograd.grad(loss, x)
    return loss.detach(), g


@torch.no_grad()
def step_on_batch(cfg: PoincareEmbedConfig, opt, state: TrainState,
                  u_idx, v_idx, neg_idx=None, pool_idx=None):
    """One dense step on an explicit batch: ``neg_idx`` [B, K] given, or
    mined from ``pool_idx`` (``neg_mode="mined"``).  The body of
    :func:`train_step` after its draws."""
    if neg_idx is None:
        neg_idx = _mine_negatives(cfg, state.table, u_idx, pool_idx)
    loss, g = _value_and_grad(
        lambda t: loss_fn(t, u_idx, v_idx, neg_idx, cfg.c), state.table)
    updates, opt_state = opt.update(g, state.opt_state, state.table)
    table = apply_updates(state.table, updates)
    return TrainState(table, opt_state, state.generator, state.step + 1), loss


def train_step(cfg: PoincareEmbedConfig, opt, state: TrainState,
               pairs: torch.Tensor):
    """One dense step: a batch of ``batch_size`` closure pairs drawn from
    ``pairs`` [P, 2] (int64, on the table's device), negatives drawn or
    mined, the whole-table update.  Returns (state, loss)."""
    _check_neg_mode(cfg, dense=True)
    u_idx, v_idx = _draw_batch(cfg, state.generator, pairs)
    neg_idx = _draw_negatives(cfg, state, u_idx, pairs)
    return step_on_batch(cfg, opt, state, u_idx, v_idx, neg_idx)


def path_counters() -> list:
    """The launch counters of every kernel this workload reaches."""
    from hyperspace_torch import kernels as K
    from hyperspace_torch.kernels import distmat, scan_topk, segment

    return [K.expmap, K.ptransp, scan_topk.scan_topk,
            segment.csr_segment_sum, distmat.pdist]


_CHUNKS: dict = {}


def _chunk(key, make):
    """One chunked stepper per (config, optimizer, length, kind), kept
    like a jitted function, so an epoch captures its graph once."""
    fn = _CHUNKS.get(key)
    if fn is None:
        fn = _CHUNKS[key] = make()
    return fn


def train_epoch_scan(cfg: PoincareEmbedConfig, opt, state: TrainState,
                     pairs: torch.Tensor, steps: int):
    """``steps`` dense steps as one chunk (a CUDA graph of
    :func:`train_step` replayed ``steps`` times; a loop on the CPU): the
    same trajectory as ``steps`` calls of :func:`train_step` from the
    same state and generator.  Returns (state, losses [steps])."""
    _check_neg_mode(cfg, dense=True)
    chunk = _chunk((cfg, opt, steps, "dense"), lambda: make_chunked_stepper(
        lambda st, p: train_step(cfg, opt, st, p), steps,
        counters=path_counters()))
    if steps <= 1:
        state, loss = chunk(state, pairs)
        return state, loss.reshape(1)
    return chunk(state, pairs)


# --- the sparse step -------------------------------------------------------------


def _set_rows_(dst: torch.Tensor, uniq: torch.Tensor,
               vals: torch.Tensor, num_nodes: int) -> None:
    """``dst[uniq] = vals`` in place, slots with ``uniq == num_nodes``
    dropped (JAX's ``mode="drop"``) without a host read: they write the
    first slot's row (always real) with its own value, and duplicate
    indices carrying equal values leave one result."""
    valid = uniq < num_nodes
    idx = torch.where(valid, uniq, uniq[:1])
    src = torch.where(valid[:, None], vals, vals[:1])
    dst.index_copy_(0, idx, src.to(dst.dtype))


def _rows_update(cfg, opt, opt_state, rows, g_rows, uniq, safe):
    """The optimizer on gathered rows; Adam's moment rows gathered and
    written back with the same index set ("lazy" sparse moments, the
    global count).  Returns (new rows, new optimizer state)."""
    if isinstance(opt_state, RAdamState):
        row_state = RAdamState(count=opt_state.count, mu=opt_state.mu[safe],
                               nu=opt_state.nu[safe])
        updates, row_state = opt.update(g_rows, row_state, rows)
        _set_rows_(opt_state.mu, uniq, row_state.mu, cfg.num_nodes)
        _set_rows_(opt_state.nu, uniq, row_state.nu, cfg.num_nodes)
        new_state = RAdamState(row_state.count, opt_state.mu, opt_state.nu)
    else:
        updates, new_state = opt.update(g_rows, opt_state, rows)
    return apply_updates(rows, updates), new_state


def _batch_loss(cfg, flat_rows, u_idx, v_idx, neg_idx):
    """The ranking loss over the gathered rows of the flat index list
    ``[u | v | neg]`` ([B·(2+K), d])."""
    b = u_idx.shape[0]
    cv = torch.cat([flat_rows[b:2 * b, None],
                    flat_rows[2 * b:].reshape(b, -1, flat_rows.shape[-1])],
                   dim=1)
    return _ranking_loss(flat_rows[:b], cv, u_idx, v_idx, neg_idx, cfg.c)


@torch.no_grad()
def sparse_step_on_batch(cfg: PoincareEmbedConfig, opt, state: TrainState,
                         u_idx, v_idx, neg_idx):
    """The body of :func:`train_step_sparse` on an explicit batch."""
    all_idx = torch.cat([u_idx, v_idx, neg_idx.reshape(-1)])
    uniq, inv = torch.unique(all_idx, sorted=True, return_inverse=True)
    uniq = torch.nn.functional.pad(uniq, (0, all_idx.shape[0] - len(uniq)),
                                   value=cfg.num_nodes)
    safe = torch.clamp_max(uniq, cfg.num_nodes - 1)
    rows = state.table[safe]
    loss, g_rows = _value_and_grad(
        lambda r: _batch_loss(cfg, r[inv], u_idx, v_idx, neg_idx), rows)
    new_rows, opt_state = _rows_update(cfg, opt, state.opt_state, rows,
                                       g_rows, uniq, safe)
    _set_rows_(state.table, uniq, new_rows, cfg.num_nodes)
    return TrainState(state.table, opt_state, state.generator,
                      state.step + 1), loss


def train_step_sparse(cfg: PoincareEmbedConfig, opt, state: TrainState,
                      pairs: torch.Tensor):
    """Sparse-row variant of :func:`train_step`: only the batch's unique
    rows are gathered, updated and written back (rsgd: the same update
    as the dense step; radam: lazy moments)."""
    _check_neg_mode(cfg, dense=False)
    u_idx, v_idx = _draw_batch(cfg, state.generator, pairs)
    neg_idx = _draw_ids(cfg, state.generator,
                        (cfg.batch_size, cfg.neg_samples), pairs.device)
    return sparse_step_on_batch(cfg, opt, state, u_idx, v_idx, neg_idx)


def make_train_step(cfg: PoincareEmbedConfig):
    """The configured step function: ``f(cfg, opt, state, pairs)``."""
    _check_neg_mode(cfg, dense=not cfg.sparse)
    return train_step_sparse if cfg.sparse else train_step


# --- host-planned sparse steps -----------------------------------------------------


class SparsePlan(NamedTuple):
    """Index plans of S planned steps (host-built, on the device);
    U = B·(2+K) flat slots a step, sentinel ``num_nodes``."""

    u_idx: torch.Tensor       # [S, B] int64
    v_idx: torch.Tensor       # [S, B] int64
    neg_idx: torch.Tensor     # [S, B, K] int64
    uniq: torch.Tensor        # [S, U] int64 sorted unique rows
    inv_map: torch.Tensor     # [S, U] int64 flat position -> slot
    order: torch.Tensor       # [S, U] int64 occurrences sorted by row
    seg_sorted: torch.Tensor  # [S, U] int32 inv_map[order] (ascending)


def plan_arrays_np(cfg: PoincareEmbedConfig, u_idx, v_idx, neg_idx):
    """The numpy planning pass: the seven plan arrays (int32), equal to
    the JAX package's."""
    steps = u_idx.shape[0]
    u_idx = np.asarray(u_idx, np.int32)
    v_idx = np.asarray(v_idx, np.int32)
    neg_idx = np.asarray(neg_idx, np.int32)
    flat = np.concatenate([u_idx, v_idx, neg_idx.reshape(steps, -1)],
                          axis=1)                             # [S, U]
    order = np.argsort(flat, axis=1, kind="stable").astype(np.int32)
    sorted_ids = np.take_along_axis(flat, order, axis=1)
    new_seg = np.ones_like(sorted_ids, bool)
    new_seg[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    seg_sorted = (np.cumsum(new_seg, axis=1) - 1).astype(np.int32)
    uniq = np.full((steps, flat.shape[1]), cfg.num_nodes, np.int32)
    s_grid, _ = np.nonzero(new_seg)
    uniq[s_grid, seg_sorted[new_seg]] = sorted_ids[new_seg]
    inv_map = np.empty_like(seg_sorted)
    np.put_along_axis(inv_map, order, seg_sorted, axis=1)
    return u_idx, v_idx, neg_idx, uniq, inv_map, order, seg_sorted


def plan_from_indices(cfg: PoincareEmbedConfig, u_idx, v_idx, neg_idx,
                      device="cuda") -> SparsePlan:
    """Plans for explicit [S, B] / [S, B, K] batches, on ``device``."""
    dev = resolve_device(device)
    arrs = plan_arrays_np(cfg, u_idx, v_idx, neg_idx)
    return SparsePlan(*(torch.as_tensor(
        a, dtype=torch.int32 if i == 6 else torch.int64, device=dev)
        for i, a in enumerate(arrs)))


def plan_sparse_steps(cfg: PoincareEmbedConfig, pairs, steps: int,
                      seed: int = 0, device="cuda") -> SparsePlan:
    """Draw ``steps`` batches and negatives on the host (numpy, the same
    draws as the JAX package's from the same seed) and plan them."""
    _check_neg_mode(cfg, dense=False)
    rng = np.random.default_rng(seed)
    pairs = np.asarray(pairs)
    b, k = cfg.batch_size, cfg.neg_samples
    batch = pairs[rng.integers(0, len(pairs), (steps, b))]    # [S, B, 2]
    neg_idx = rng.integers(0, cfg.num_nodes, (steps, b, k))
    return plan_from_indices(cfg, batch[..., 0], batch[..., 1], neg_idx,
                             device)


class _DedupGather(torch.autograd.Function):
    """``rows[inv_map]`` whose backward never scatters: the cotangent is
    gathered into row-sorted occurrence order (``order``) and summed per
    slot by the sorted segment sum over ``seg_sorted``
    (``kernels/segment.py:csr_segment_sum``: the kernel on CUDA, its plain
    version on the CPU), accumulated in at least float32."""

    @staticmethod
    def forward(ctx, rows, inv_map, order, seg_sorted):
        ctx.save_for_backward(order, seg_sorted)
        ctx.slots = rows.shape[0]
        return rows[inv_map]

    @staticmethod
    def backward(ctx, g):
        from hyperspace_torch.kernels.segment import csr_segment_sum

        order, seg_sorted = ctx.saved_tensors
        acc = torch.promote_types(g.dtype, torch.float32)
        d_rows = csr_segment_sum(g[order].to(acc).contiguous(), seg_sorted,
                                 None, ctx.slots)
        return d_rows.to(g.dtype), None, None, None


def _dedup_gather(rows, inv_map, order, seg_sorted):
    return _DedupGather.apply(rows, inv_map, order, seg_sorted)


def _plan_row(plan: SparsePlan, i: torch.Tensor) -> SparsePlan:
    """Row ``i`` (a 0-dim device tensor) of every plan array, read on
    the device."""
    return SparsePlan(*(torch.index_select(a, 0, i.reshape(1))[0]
                        for a in plan))


def _planned_loss(cfg, row: SparsePlan, rows):
    flat = _dedup_gather(rows, row.inv_map, row.order, row.seg_sorted)
    return _batch_loss(cfg, flat, row.u_idx, row.v_idx, row.neg_idx)


@torch.no_grad()
def train_step_sparse_planned(cfg: PoincareEmbedConfig, opt,
                              state: TrainState, plan: SparsePlan):
    """One planned step on plan row ``state.step % S``: the dense step's
    update on the planned batch (duplicates summed per row before the
    metric rescale), radam with lazy moments."""
    row = _plan_row(plan, state.step % plan.u_idx.shape[0])
    safe = torch.clamp_max(row.uniq, cfg.num_nodes - 1)
    rows = state.table[safe]
    loss, g_rows = _value_and_grad(lambda r: _planned_loss(cfg, row, r),
                                   rows)
    new_rows, opt_state = _rows_update(cfg, opt, state.opt_state, rows,
                                       g_rows, row.uniq, safe)
    _set_rows_(state.table, row.uniq, new_rows, cfg.num_nodes)
    return TrainState(state.table, opt_state, state.generator,
                      state.step + 1), loss


# --- packed planned state: one gather and one scatter a step ---------------------


class PackedState(NamedTuple):
    packed: torch.Tensor  # [N, d] (rsgd) or [N, 2d+1] (radam: table|mu|nu)
    aux: Any              # the rest of the optimizer state (counts)
    generator: torch.Generator
    step: torch.Tensor


def pack_state(cfg: PoincareEmbedConfig, state: TrainState) -> PackedState:
    if isinstance(state.opt_state, RAdamState):
        packed = torch.cat([state.table, state.opt_state.mu,
                            state.opt_state.nu], dim=1)
        aux = state.opt_state.count
    else:
        packed, aux = state.table.clone(), state.opt_state
    return PackedState(packed, aux, state.generator, state.step)


def unpack_state(cfg: PoincareEmbedConfig, p: PackedState) -> TrainState:
    d = cfg.dim
    if p.packed.shape[1] > d:  # radam rows: table | mu | nu (nu is [*, 1])
        table = p.packed[:, :d].contiguous()
        opt_state = RAdamState(count=p.aux,
                               mu=p.packed[:, d:2 * d].contiguous(),
                               nu=p.packed[:, 2 * d:].contiguous())
    else:
        table, opt_state = p.packed.clone(), p.aux
    return TrainState(table, opt_state, p.generator, p.step)


def _packed_row_body(cfg: PoincareEmbedConfig, opt, state: PackedState,
                     row: SparsePlan):
    """The packed step on one plan row: one [U, W] gather, the loss
    through :class:`_DedupGather`, the optimizer, one row scatter."""
    d = cfg.dim
    safe = torch.clamp_max(row.uniq, cfg.num_nodes - 1)
    all_rows = state.packed[safe]
    rows = all_rows[:, :d]
    loss, g_rows = _value_and_grad(lambda r: _planned_loss(cfg, row, r),
                                   rows)
    if all_rows.shape[1] > d:  # radam: the moments ride in the packed rows
        row_state = RAdamState(count=state.aux, mu=all_rows[:, d:2 * d],
                               nu=all_rows[:, 2 * d:])
        updates, row_state = opt.update(g_rows, row_state, rows)
        new_all = torch.cat([apply_updates(rows, updates),
                             row_state.mu.to(all_rows.dtype),
                             row_state.nu.to(all_rows.dtype)], dim=1)
        aux = row_state.count
    else:
        updates, aux = opt.update(g_rows, state.aux, rows)
        new_all = apply_updates(rows, updates)
    _set_rows_(state.packed, row.uniq, new_all, cfg.num_nodes)
    return PackedState(state.packed, aux, state.generator,
                       state.step + 1), loss


@torch.no_grad()
def train_step_planned_packed(cfg: PoincareEmbedConfig, opt,
                              state: PackedState, plan: SparsePlan):
    """:func:`train_step_sparse_planned` on a :class:`PackedState`; plan
    row ``state.step % S``."""
    row = _plan_row(plan, state.step % plan.u_idx.shape[0])
    return _packed_row_body(cfg, opt, state, row)


def train_epoch_planned_packed(cfg: PoincareEmbedConfig, opt,
                               state: PackedState, plan: SparsePlan):
    """All S plan rows, front to back, as one chunk (a CUDA graph of one
    packed step replayed S times; a loop on the CPU).  The same
    trajectory as S calls of :func:`train_step_planned_packed` when
    ``state.step % S == 0`` at entry.  Returns (state, losses [S])."""
    return _planned_epoch(cfg, opt, state, plan, "planned")


def train_epoch_planned_hosted(cfg: PoincareEmbedConfig, opt,
                               state: PackedState, plan: SparsePlan):
    """:func:`train_epoch_planned_packed` for the host-resident trainer
    (``train/host_embed.py``): ``state.packed`` is the device hot-row
    cache ``[C, W]`` (``parallel/host_table.DeviceHotCache``), the plan's
    ``uniq`` rows are remapped to cache slots (in no order after the
    first eviction), and ``cfg.num_nodes`` is the capacity C, the
    remapped sentinel.  The same per-row computation as the in-HBM
    epoch, so the host path is bitwise it.  A chunk stepper of its own
    (one capture per (C, S)); on the card the cache tensor the trainer
    hands back is the graph's buffer, so a chunk copies nothing in."""
    return _planned_epoch(cfg, opt, state, plan, "hosted")


def _planned_epoch(cfg, opt, state, plan, kind: str):
    s = plan.u_idx.shape[0]

    @torch.no_grad()
    def body(st, p, i):
        return _packed_row_body(cfg, opt, st, _plan_row(p, i.to(
            p.u_idx.device)))

    if s == 1:
        state, loss = body(state, plan, torch.zeros((), dtype=torch.int64))
        return state, loss.reshape(1)
    chunk = _chunk((cfg, opt, s, kind), lambda: make_chunked_stepper(
        body, s, positional=True, counters=path_counters()))
    return chunk(state, plan)


def graph_captures() -> int:
    """CUDA graphs captured so far by this module's chunk steppers."""
    return sum(getattr(fn, "captures", 0) for fn in _CHUNKS.values())


def init_state(cfg: PoincareEmbedConfig, seed: int = 0, device="cuda"):
    """The initial state and its optimizer, built together; the table
    and every later draw come from one generator seeded from ``seed``."""
    precision_mod.get_policy(cfg.precision)  # validate the name early
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = init_table(cfg, gen)
    opt = make_optimizer(cfg)
    return TrainState(table, opt.init(table), gen,
                      torch.zeros((), dtype=torch.int64, device=dev)), opt


def state_from_jax(cfg: PoincareEmbedConfig, jstate, seed: int = 0,
                   device="cuda"):
    """The port's state from a JAX ``TrainState`` or ``PackedState``
    (anything with its fields, read with ``np.asarray``): table or
    packed rows, ``count``, ``mu``, ``nu`` and the step.  The JAX PRNG
    key is not carried; the generator is seeded from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    step = t(jstate.step, torch.int64)
    if hasattr(jstate, "packed"):
        packed = t(jstate.packed)
        aux = jstate.aux
        aux = t(aux, torch.int64) if packed.shape[1] > cfg.dim else \
            RSGDState(count=t(aux.count, torch.int64))
        return PackedState(packed, aux, gen, step)
    o = jstate.opt_state
    opt_state = RAdamState(t(o.count, torch.int64), t(o.mu), t(o.nu)) \
        if hasattr(o, "mu") else RSGDState(count=t(o.count, torch.int64))
    return TrainState(t(jstate.table), opt_state, gen, step)


# --- evaluation: MAP and mean rank over the closure -------------------------------


@torch.no_grad()
def _rank_chunk(table: torch.Tensor, u_idx: torch.Tensor,
                v_idx: torch.Tensor, c, dist_fn=None) -> torch.Tensor:
    """For each pair (u, v): 1 + the number of nodes strictly closer to
    u than v, u and v themselves not counted; distances by ``dist_fn``
    (default ``kernels/distmat.py:pdist``)."""
    if dist_fn is None:
        from hyperspace_torch.kernels.distmat import pdist as dist_fn

    d_all = dist_fn(table[u_idx], table, c, manifold="poincare")  # [B, N]
    d_pos = torch.gather(d_all, 1, v_idx[:, None])
    closer = (d_all < d_pos).to(torch.int32)
    rows = torch.arange(u_idx.shape[0], device=u_idx.device)
    closer[rows, u_idx] = 0
    closer[rows, v_idx] = 0
    return torch.sum(closer, dim=1) + 1


def evaluate(table: torch.Tensor, pairs, c, batch: int = 1024,
             dist_fn=None) -> dict:
    """Mean rank and MAP of the ground-truth ancestors, ranking all N
    nodes by distance in chunks of ``batch`` pairs (one ``pdist`` a
    chunk, ranks read back once), filtered as N&K do: among u's sorted
    unfiltered ranks the i-th has i other positives above it, so its
    filtered rank is r_i − i and its precision (i+1)/r_i.  ``dist_fn``
    replaces ``pdist`` (same signature), e.g. by its plain version to
    hold the kernel's ranks against it."""
    pairs = np.asarray(pairs)
    table = table.contiguous()
    p = torch.as_tensor(pairs, dtype=torch.int64, device=table.device)
    ranks = torch.cat([_rank_chunk(table, p[s:s + batch, 0],
                                   p[s:s + batch, 1], c, dist_fn)
                       for s in range(0, len(pairs), batch)])
    return rank_metrics(pairs, ranks.cpu().numpy())


def rank_metrics(pairs, ranks) -> dict:
    """Mean rank and MAP from each pair's unfiltered rank (numpy), the
    filtering :func:`evaluate` describes; shared by the product
    embeddings' evaluation."""
    pairs = np.asarray(pairs)
    ranks = np.asarray(ranks).astype(np.int64)
    u = pairs[:, 0].astype(np.int64)
    order = np.lexsort((ranks, u))
    us, rs = u[order], ranks[order]
    first = np.ones(len(us), bool)
    first[1:] = us[1:] != us[:-1]
    starts = np.flatnonzero(first)
    counts = np.diff(np.append(starts, len(us)))
    i = np.arange(len(us)) - np.repeat(starts, counts)
    prec = (i + 1) / np.maximum(rs, i + 1)
    aps = np.add.reduceat(prec, starts) / counts
    return {"mean_rank": float(np.mean(np.maximum(rs - i, 1))),
            "map": float(np.mean(aps))}

"""Host-resident planned-sparse training for embedding tables larger than
one card holds (counterpart of ``hyperspace_tpu/train/host_embed.py``;
``parallel/host_table.py`` holds the table and the cache).

The in-HBM packed trainer (``models/poincare_embed.py``) keeps the whole
``[N, W]`` packed table (embeddings | optimizer moments) on the card.
This runner keeps it in host memory and visits the card with each
chunk's working set only:

1. **Plan on the host** (prefetched): draw ``chunk_steps`` batches and
   negatives, build the steps' sparse plans (``poincare_embed.
   plan_arrays_np``) and union their rows into the chunk's id set, all
   numpy, in a ``data/prefetch.HostPrefetcher`` thread while the card
   runs the previous chunk.
2. **Hot-row gather**: ``DeviceHotCache.ensure`` uploads the rows not
   already on the card; rows that stay hot never cross the link again.
3. **Run the chunk**: ``poincare_embed.train_epoch_planned_hosted``, the
   packed step over the cache with every plan ``uniq`` remapped to a
   cache slot (sentinel → C), a CUDA graph of one step replayed S times
   on the card.  The chunk's plan is copied into device buffers the
   trainer owns, one set a chunk length: a graph holds its arguments by
   address, so every chunk of one length replays one capture, and the
   cache tensor the graph returns is the cache from then on (``ensure``
   writes into it in place).
4. **Write back at the chunk boundary**: fetch the touched rows and
   scatter them into the host master, so the master is current before
   the next chunk's gather.  The fetch waits for the card, by contract.

**Equivalence contract.**  The default (synchronous gather) path is
bitwise the in-HBM packed trainer fed the same per-chunk plans
(:func:`run_planned_inhbm`): remapping rows to slots changes gather and
scatter indices, never values, and the per-row optimizer math couples no
rows.  ``gather_ahead=True`` gathers upcoming chunks' rows in the
prefetch thread while the current chunk runs; a row evicted and touched
again can then be read stale, by at most ``prefetch_depth + 1`` chunks
(depth queued plus one in flight).  Rows that stay cached are always
current, so at ``hot_rows >= N`` the overlap mode is exact again.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from hyperspace_torch.data.prefetch import HostPrefetcher
from hyperspace_torch.models import poincare_embed as pe
from hyperspace_torch.parallel.host_table import DeviceHotCache, HostEmbedTable
from hyperspace_torch.telemetry import registry as _telem
from hyperspace_torch.telemetry.trace import span as _span
from hyperspace_torch.train.telemetry import StepPhases

DEFAULT_CHUNK_STEPS = 8

# the largest table the CLI brings back onto the card for the closing
# evaluation (HostPlannedTrainer.to_state); past it the table is meant
# not to fit, evaluation is skipped and the saved master is the product
EVAL_MAX_ROWS = 1 << 21


def auto_hot_rows(cfg: pe.PoincareEmbedConfig, chunk_steps: int) -> int:
    """Default cache capacity: the chunk's worst-case working set (every
    id distinct), capped at the table."""
    worst = int(chunk_steps) * cfg.batch_size * (2 + cfg.neg_samples)
    return min(cfg.num_nodes, worst)


def chunk_plan_np(cfg: pe.PoincareEmbedConfig, pairs: np.ndarray,
                  steps: int, seed: int, chunk_index: int):
    """Host-drawn batches and sparse plans of chunk ``chunk_index``,
    determined by ``(cfg, pairs, steps, seed, chunk_index)`` (the JAX
    package's draws), so the host-resident and in-HBM trainers consume
    identical plans."""
    rng = np.random.default_rng((int(seed), int(chunk_index)))
    b, k = cfg.batch_size, cfg.neg_samples
    batch = pairs[rng.integers(0, len(pairs), (steps, b))]    # [S, B, 2]
    neg = rng.integers(0, cfg.num_nodes, (steps, b, k))
    return pe.plan_arrays_np(cfg, batch[..., 0], batch[..., 1], neg)


def _chunk_sizes(steps: int, chunk_steps: int) -> list[int]:
    sizes = [chunk_steps] * (steps // chunk_steps)
    if steps % chunk_steps:
        sizes.append(steps % chunk_steps)  # one ragged tail chunk
    return sizes


def _device_plan(bufs: dict, arrays, device) -> pe.SparsePlan:
    """The plan ``arrays`` (numpy) copied into the device buffers of
    their shapes in ``bufs`` (made at first use, then reused: a graph
    captured over them replays for every later plan of those shapes).
    Plan dtypes: int64, ``seg_sorted`` int32."""
    key = (str(device),) + tuple(np.shape(a) for a in arrays)
    plan = bufs.get(key)
    if plan is None:
        plan = bufs[key] = pe.SparsePlan(*(torch.empty(
            np.shape(a), dtype=torch.int32 if i == 6 else torch.int64,
            device=device) for i, a in enumerate(arrays)))
    for t, a in zip(plan, arrays):
        t.copy_(torch.from_numpy(np.ascontiguousarray(
            a, np.int32 if t.dtype == torch.int32 else np.int64)))
    return plan


class HostPlannedTrainer:
    """Drives the per-chunk protocol above over one host master table.

    ``master`` holds packed rows (``pack_state``'s layout: the table for
    rsgd, table | mu | nu for radam); ``aux``, ``generator`` and ``step``
    are the packed state's other leaves (JAX's ``key`` is the port's
    generator, made from ``seed`` when not given).  Build it from a live
    ``TrainState`` with :meth:`from_state` (tables that still fit), or
    hand a master built shard by shard directly (tables that do not).
    The cache and the chunk run on ``device``.
    """

    def __init__(self, cfg: pe.PoincareEmbedConfig, opt,
                 master: HostEmbedTable, aux,
                 generator: Optional[torch.Generator] = None, step=0, *,
                 chunk_steps: int = DEFAULT_CHUNK_STEPS,
                 hot_rows: int = 0, seed: int = 0,
                 gather_ahead: bool = False, prefetch_depth: int = 2,
                 profile: bool = False, phases: StepPhases = None,
                 device="cuda"):
        from hyperspace_torch.kernels._support import resolve_device

        if master.num_rows != cfg.num_nodes:
            raise ValueError(
                f"master has {master.num_rows} rows; cfg.num_nodes is "
                f"{cfg.num_nodes}")
        pe._check_neg_mode(cfg, dense=False)
        dev = resolve_device(device)
        self.cfg, self.opt, self.master, self.device = cfg, opt, master, dev
        self.aux = pytree.tree_map(
            lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, aux)
        self.generator = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(int(seed))
        self.step = torch.as_tensor(step, dtype=torch.int64).to(dev)
        self.chunk_steps = int(chunk_steps)
        if self.chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1; got {chunk_steps}")
        self.hot_rows = int(hot_rows) or auto_hot_rows(cfg, self.chunk_steps)
        self.seed = int(seed)
        self.gather_ahead = bool(gather_ahead)
        self.prefetch_depth = int(prefetch_depth)
        # per-chunk phase timers (train/telemetry.py); profile= makes
        # device_step wait for the chunk's output (the CLI's
        # profile_steps=)
        self.phases = phases or StepPhases(profile=profile,
                                           annotate=profile)
        self.cache = DeviceHotCache(master, self.hot_rows, device=dev)
        # one local config a capacity: the chunk's num_nodes is the cache
        # size C (the remapped sentinel)
        self._cfg_local = dataclasses.replace(
            cfg, num_nodes=self.cache.capacity)
        self._plans: dict = {}

    @classmethod
    def from_state(cls, cfg: pe.PoincareEmbedConfig, opt,
                   state: pe.TrainState, *, shards: int = 1,
                   **kw) -> "HostPlannedTrainer":
        """Pack a live ``TrainState``'s rows into a host master (``shards``
        row ranges); the cache goes on the state's device unless
        ``device=`` says otherwise."""
        p = pe.pack_state(cfg, state)
        kw.setdefault("device", p.packed.device)
        master = HostEmbedTable.from_array(
            np.array(p.packed.detach().cpu().numpy()), shards)
        return cls(cfg, opt, master, p.aux, p.generator, p.step, **kw)

    # --- the per-chunk protocol ----------------------------------------------

    def _make_chunk(self, chunk_index: int, steps: int):
        """Prefetcher body: plan and union on the host; under
        ``gather_ahead`` also the row gather (stale by at most the
        look-ahead).  Host work only."""
        plan = chunk_plan_np(self.cfg, self._pairs, steps, self.seed,
                             chunk_index)
        uniq = plan[3]
        chunk_ids = np.unique(uniq)
        chunk_ids = chunk_ids[chunk_ids < self.cfg.num_nodes]
        rows = self.master.gather(chunk_ids) if self.gather_ahead else None
        return plan, chunk_ids, rows

    def _run_chunk(self, item) -> np.ndarray:
        plan, chunk_ids, pre_rows = item
        cap = self.cache.capacity
        with self.phases.phase("host_gather"):
            if pre_rows is None:
                slots = self.cache.ensure(chunk_ids)
            else:
                slots = self.cache.ensure_with_rows(
                    chunk_ids, pre_rows, np.ones(len(chunk_ids), bool))
        u_idx, v_idx, neg_idx, uniq, inv_map, order, seg = plan
        # global rows -> cache slots; the sentinel (num_nodes) becomes the
        # local sentinel C, which the step's scatter drops
        pos = np.minimum(np.searchsorted(chunk_ids, uniq),
                         max(len(chunk_ids) - 1, 0))
        local_uniq = np.where(uniq >= self.cfg.num_nodes, cap, slots[pos])
        dev_plan = _device_plan(self._plans, (
            u_idx, v_idx, neg_idx, local_uniq, inv_map, order, seg),
            self.device)
        pstate = pe.PackedState(self.cache.array, self.aux, self.generator,
                                self.step)
        out = None
        # device_step: in profile mode the phase waits for the updated
        # cache before it closes (execution, not enqueue)
        with self.phases.phase("device_step", lambda: out.packed):
            with _span("host_chunk_dispatch"):
                out, losses = pe.train_epoch_planned_hosted(
                    self._cfg_local, self.opt, pstate, dev_plan)
        self.cache.array = out.packed
        self.aux, self.generator, self.step = (out.aux, out.generator,
                                               out.step)
        # the chunk-boundary write-back: the master is current before
        # the next chunk's gather (and before an eviction could drop the
        # only fresh copy)
        with self.phases.phase("write_back"):
            self.master.write_back(chunk_ids, self.cache.fetch(slots))
        _telem.inc("host_table/chunks")
        return losses.cpu().numpy()

    def run(self, pairs, steps: int) -> np.ndarray:
        """Train ``steps`` steps in chunks; returns the [steps] losses.

        Plans (and under ``gather_ahead`` rows) are built in a
        :class:`HostPrefetcher` thread, ``prefetch_depth`` chunks ahead
        of the card."""
        self._pairs = np.asarray(pairs)
        sizes = _chunk_sizes(int(steps), self.chunk_steps)
        if not sizes:
            return np.zeros((0,), np.float32)
        losses = []
        with HostPrefetcher(
                lambda i: self._make_chunk(i, sizes[i]),
                depth=self.prefetch_depth) as pf:
            for _ in sizes:
                # data_wait: blocked on the prefetcher, near zero while
                # the planner keeps ahead of the card
                with self.phases.phase("data_wait"):
                    item = pf.next()
                losses.append(self._run_chunk(item))
        return np.concatenate(losses)

    def to_state(self) -> pe.TrainState:
        """The master back on the card as a ``TrainState``: small tables'
        evaluation and export only (a table past one card stays on the
        host; use the master)."""
        packed = torch.as_tensor(self.master.to_array(), device=self.device)
        return pe.unpack_state(self.cfg, pe.PackedState(
            packed, self.aux, self.generator, self.step))


def run_planned_inhbm(cfg: pe.PoincareEmbedConfig, opt,
                      state: pe.TrainState, pairs, steps: int, *,
                      chunk_steps: int = DEFAULT_CHUNK_STEPS,
                      seed: int = 0, plans: Optional[dict] = None
                      ) -> tuple[pe.TrainState, np.ndarray]:
    """The in-HBM reference: the same per-chunk plans
    (:func:`chunk_plan_np`) through the packed planned epoch over the
    whole table on its device; the bitwise baseline of the host-resident
    path.  Returns (state, [steps] losses).

    ``plans`` holds the device plan buffers, one set a plan shape; a
    caller that passes one dict to several calls keeps their graphs
    (a fresh dict, the default, captures anew each call)."""
    pairs = np.asarray(pairs)
    plans = {} if plans is None else plans
    p = pe.pack_state(cfg, state)
    losses = []
    for ci, s in enumerate(_chunk_sizes(int(steps), int(chunk_steps))):
        plan = _device_plan(plans, chunk_plan_np(
            cfg, pairs, s, seed, ci), p.packed.device)
        p, chunk_losses = pe.train_epoch_planned_packed(cfg, opt, p, plan)
        losses.append(chunk_losses.cpu().numpy())
    return pe.unpack_state(cfg, p), np.concatenate(losses)

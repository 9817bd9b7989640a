"""The training loop and chunked stepping (counterpart of
``hyperspace_tpu/train/loop.py``: ``run_loop``, ``resume_chunk``,
``make_chunked_stepper``, ``round_steps_to_chunk``).

:func:`run_loop` is the one step loop every CLI workload goes through:
resume from the newest committed checkpoint, JSONL records at a
boundary-crossing cadence (a chunk that crosses a log or save interval
fires it) with the chunk's loss statistics, numerical-health samples at
the chunk cadence, interval saves and a forced final save.  Its host
reads are at those boundaries only.  The telemetry spine of JAX's loop
(spans, counters, the run manifest, ``metrics_out``,
``profile_steps``) and its divergence guard (``rollback``, ``chaos``)
are not ported.

JAX runs K calls of a step body as one program (``lax.scan``) with the
per-step losses stacked on the device.  Here, for state on a CUDA
device, one step is captured in a ``torch.cuda.CUDAGraph`` that reads
the state from static buffers, writes the new state back into them and
the step's loss into slot ``i`` of a ``[K, ...]`` buffer; a chunk replays it
K times, with no host read in between.  On the CPU the chunk is a plain
loop of the same step.  A capture that fails raises: there is no eager
fallback on the card.

What a graph freezes: Python control flow and Python numbers of the
step.  A step that depends on its step count or a random draw must
compute it on the device (tensor counters; a ``torch.Generator`` in the
state, which the graph registers so that each replay draws fresh
numbers, the same as an eager step from the same generator state would).
Kernel wrappers count their launches in Python, which a replay does not
reach: the stepper adds the captured step's launches once per replay to
the ``counters`` it is given, and takes off those counted while
capturing (a capture records launches, it does not run them).  A
checkpoint restore copies into the live state (``train/checkpoint.py``),
so the static buffers a graph holds are never swapped."""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import torch
import torch.utils._pytree as pytree


def round_steps_to_chunk(steps: int, chunk_steps: int) -> int:
    """The step budget rounded up to a chunk multiple: every chunk runs
    exactly ``chunk_steps`` steps."""
    k = max(int(chunk_steps), 1)
    return -(-int(steps) // k) * k


def _split(state):
    leaves, spec = pytree.tree_flatten(state)
    return leaves, spec


def _tensors(leaves):
    return [x for x in leaves if isinstance(x, torch.Tensor)]


class ChunkedStepper:
    """``chunk(state, *args) -> (state, losses [K, ...])``: K steps of
    ``step_fn(state, *args) -> (state, loss)``, graphed on CUDA; ``loss``
    is a tensor of any one shape (a 0-dim loss, or a vector of a step's
    metrics), stacked along a new first axis.

    ``args`` are the same every step (a graph holds them by address: a
    chunk called with other argument tensors, another state layout or
    another generator captures anew).  With ``positional=True`` the step
    is called as ``step_fn(state, *args, i)``, ``i`` its position in the
    chunk (a 0-dim int64 tensor), for steps that walk a plan front to
    back.  The state passed in is donated: on CUDA the state returned
    holds the graph's static buffers, and a later chunk given that state
    copies nothing."""

    def __init__(self, step_fn: Callable, chunk_steps: int, *,
                 positional: bool = False,
                 counters: Sequence[Callable] = ()):
        self.step_fn, self.k = step_fn, int(chunk_steps)
        self.positional, self.counters = positional, list(counters)
        self.graph = None
        self._key = None

    def _call(self, state, args, i):
        return self.step_fn(state, *args, i) if self.positional \
            else self.step_fn(state, *args)

    def __call__(self, state, *args):
        leaves, spec = _split(state)
        tensors = _tensors(leaves)
        if not tensors:
            raise ValueError("chunked stepper: the state holds no tensor")
        dev = tensors[0].device
        if dev.type == "cpu":
            losses = []
            for j in range(self.k):
                state, loss = self._call(state, args, torch.tensor(j))
                losses.append(loss)
            return state, torch.stack(losses)
        if dev.type != "cuda":
            raise ValueError(f"chunked stepper: unsupported device {dev}")
        key = (spec, tuple((t.shape, t.dtype, t.device) for t in tensors),
               tuple(id(x) for x in leaves if not isinstance(
                   x, torch.Tensor)),
               tuple((a.data_ptr(), a.shape) if isinstance(a, torch.Tensor)
                     else id(a) for a in pytree.tree_leaves(args)))
        if key != self._key:
            self._capture(state, args)
            self._key = key
        for s, t in zip(self._static, tensors):
            if t is not s:
                s.copy_(t)
        self._pos.zero_()
        for _ in range(self.k):
            self.graph.replay()
        for fn, d in zip(self.counters, self._delta):
            fn.launches += d * self.k
        out = iter(self._static)
        leaves = [next(out) if isinstance(x, torch.Tensor) else x
                  for x in leaves]
        return pytree.tree_unflatten(leaves, spec), self._losses.clone()

    def _capture(self, state, args) -> None:
        leaves, spec = _split(state)
        gens = [x for x in leaves if isinstance(x, torch.Generator)]
        if gens and not hasattr(torch.cuda.CUDAGraph,
                                "register_generator_state"):
            raise RuntimeError("chunked stepper: this PyTorch cannot "
                               "register a generator with a CUDA graph")
        self.graph = None
        static = [t.clone() for t in _tensors(leaves)]
        out = iter(static)
        st = pytree.tree_unflatten(
            [next(out) if isinstance(x, torch.Tensor) else x
             for x in leaves], spec)
        dev = static[0].device
        pos = torch.zeros((), dtype=torch.int64, device=dev)
        saved = [g.get_state() for g in gens]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):      # lazy inits outside the capture
            _, loss = self._call(st, args, pos)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        for g, s in zip(gens, saved):
            g.set_state(s)
        losses = torch.zeros((self.k,) + tuple(loss.shape), dtype=loss.dtype,
                             device=dev)
        graph = torch.cuda.CUDAGraph()
        for g in gens:
            graph.register_generator_state(g)
        before = [fn.launches for fn in self.counters]
        with torch.cuda.graph(graph):
            new, loss = self._call(st, args, pos)
            for s, t in zip(static, _tensors(pytree.tree_leaves(new))):
                s.copy_(t)
            losses.index_copy_(0, pos.reshape(1), loss.unsqueeze(0))
            pos.add_(1)
        self._delta = [fn.launches - b for fn, b in zip(self.counters,
                                                        before)]
        for fn, d in zip(self.counters, self._delta):
            fn.launches -= d
        self.graph, self._static, self._pos = graph, static, pos
        self._losses = losses


def make_chunked_stepper(step_fn: Callable, chunk_steps: int, **kw):
    """``chunk_steps`` calls of ``step_fn`` as one chunk
    (:class:`ChunkedStepper`); ``chunk_steps <= 1`` returns ``step_fn``
    unchanged, as JAX does."""
    if int(chunk_steps) <= 1:
        return step_fn
    return ChunkedStepper(step_fn, chunk_steps, **kw)


def resume_chunk(ckpt_dir: Optional[str], resume: bool,
                 chunk_steps: int) -> int:
    """The chunk a resuming batch stream starts at: a run resumed from
    step R has consumed batches of chunks 0..ceil(R/cs)−1 (the last
    perhaps in part), so the stream skips to the next chunk boundary —
    floor would serve the started chunk's first R % cs rows again."""
    if not (ckpt_dir and resume):
        return 0
    from hyperspace_torch.train.checkpoint import peek_latest_step

    cs = max(int(chunk_steps), 1)
    return -(-peek_latest_step(ckpt_dir) // cs)


def _logger(run):
    from hyperspace_torch.train.logging import MetricsLogger

    return MetricsLogger(run.log, stdout=False,
                         tensorboard_dir=getattr(run, "tensorboard_dir",
                                                 None))


def _health_monitor(run, health_fn):
    if health_fn is None or int(getattr(run, "health_every", 0) or 0) <= 0:
        return None, 0
    from hyperspace_torch.telemetry.health import (
        DEFAULT_BOUNDARY_EPS, DEFAULT_VIOLATION_TOL, HealthMonitor)

    hm = HealthMonitor(
        health_fn,
        boundary_eps=float(getattr(run, "health_eps", DEFAULT_BOUNDARY_EPS)),
        violation_tol=float(getattr(run, "health_tol",
                                    DEFAULT_VIOLATION_TOL)),
        abort=bool(getattr(run, "health_abort", False)))
    return hm, int(run.health_every)


def run_loop(run, state, stepper: Callable, project: Optional[Callable] = None,
             steps_per_call: int = 1, health_fn: Optional[Callable] = None):
    """The shared step loop; returns ``(state, last loss)``, the loss nan
    when no step ran.

    ``run`` has ``cli.train.RunConfig``'s fields ``steps``,
    ``eval_every``, ``log``, ``ckpt_dir``, ``ckpt_every``, ``resume`` and,
    optionally, ``tensorboard_dir`` and ``health_every``/``health_eps``/
    ``health_tol``/``health_abort``.  ``stepper(state) -> (state, loss)``
    runs exactly ``steps_per_call`` steps a call; a chunked stepper
    returns the ``[steps_per_call]`` losses, of which the last is the
    logged loss, and the interval's mean, last, min and max ride along
    as ``loss_*``.  A record is written whenever a call crosses a
    multiple of ``eval_every`` (50 when 0), and a chunked run closes with
    a record of the steps after the last one.  ``ckpt_dir`` saves every
    ``ckpt_every`` steps (a chunk that crosses the interval forces it;
    ``ckpt_every <= 0`` saves only the end) and always the last step;
    ``resume`` first copies the newest committed checkpoint into
    ``state`` and applies ``project`` (the re-projection onto the
    manifolds).  ``health_fn(state) -> {name: device scalar}`` is sampled
    every ``health_every`` calls."""
    from hyperspace_torch.optim.metrics import ChunkMetrics

    monitor, health_every = _health_monitor(run, health_fn)
    ck = None
    if run.ckpt_dir:
        from hyperspace_torch.train.checkpoint import CheckpointManager

        ck = CheckpointManager(run.ckpt_dir,
                               save_interval_steps=run.ckpt_every)
    acc = ChunkMetrics() if steps_per_call > 1 else None
    start = 0
    loss = math.nan
    with (ck if ck is not None else contextlib.nullcontext()), \
            _logger(run) as log:
        if (ck is not None and run.resume
                and ck.latest_committed_step() is not None):
            state, start = ck.restore(state, project=project)
        last_saved = None
        every = run.eval_every or 50
        done = start
        chunk_i = 0
        while done < run.steps:
            state, loss = stepper(state)
            chunk_i += 1
            if acc is not None:
                acc.add(loss)
            if loss.dim():          # a chunk's [steps_per_call] losses
                loss = loss[-1]
            prev, done = done, done + steps_per_call
            if (done // every) > (prev // every):
                kw = {"loss": float(loss)}   # the interval's host read
                if acc is not None:
                    stats = acc.flush()
                    if stats is not None:
                        kw.update(stats)
                log.log(done, **kw)
            if monitor is not None and chunk_i % health_every == 0:
                monitor.check(state, done, log)
            if ck is not None and run.ckpt_every > 0:
                iv = run.ckpt_every
                crossed = (done // iv) > (prev // iv)
                if ck.save(done, state,
                           force=crossed and steps_per_call > 1):
                    last_saved = done
        if acc is not None and done > start:
            # the chunks after the last crossed boundary: every step's
            # loss lands in some record's loss_mean
            stats = acc.flush()
            if stats is not None:
                log.log(done, loss=float(loss), **stats)
        if ck is not None and start < run.steps and last_saved != done:
            ck.save(done, state, force=True)
    return state, loss

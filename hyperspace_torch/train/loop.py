"""The training loop and chunked stepping (counterpart of
``hyperspace_tpu/train/loop.py``: ``run_loop``, ``resume_chunk``,
``make_chunked_stepper``, ``round_steps_to_chunk``).

:func:`run_loop` is the one step loop every CLI workload goes through:
resume from the newest committed checkpoint, JSONL records at a
boundary-crossing cadence (a chunk that crosses a log or save interval
fires it) with the chunk's loss statistics, numerical-health samples at
the chunk cadence, interval saves and a forced final save.  Its host
reads are at those boundaries only.  It is also the telemetry spine (the
run manifest, spans, ``ctr/*`` counters in every record, ``metrics_out``,
``profile_steps``) and the divergence guard's trigger (``rollback``, the
``train.step_nan`` fault), as in JAX.

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
import time
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
    back.

    Two ways to hold the state.  By default the state is a tree of
    tensors the step returns anew: it is donated, the graph reads and
    writes static buffers cloned from it, and on CUDA the state returned
    holds those buffers (a later chunk given that state copies nothing).
    With ``live=True`` the step updates the state in place — a state
    whose tensors a module and an optimizer own (``cli.train.
    ModuleState``): its live tensors, every value ``train/checkpoint.py
    :to_tree`` reaches (parameters, buffers, moments, counts,
    accumulators), are the graph's buffers, and the state is returned as
    it was given.  The warm-up call before a capture is a real step: the
    live tensors, the Python numbers and the generators are saved before
    it and restored after it, so a chunk of K replays is bitwise K eager
    steps from the same start.  A step that changes a Python number of
    the state raises (a graph would freeze it: keep counts on the
    device)."""

    def __init__(self, step_fn: Callable, chunk_steps: int, *,
                 positional: bool = False,
                 counters: Sequence[Callable] = (), live: bool = False):
        self.step_fn, self.k = step_fn, int(chunk_steps)
        self.positional, self.counters = positional, list(counters)
        self.live = bool(live)
        self.graph = None
        self._key = None
        self.captures = 0          # graphs captured (a new key captures)

    def _call(self, state, args, i):
        return self.step_fn(state, *args, i) if self.positional \
            else self.step_fn(state, *args)

    def _leaves(self, state):
        if self.live:
            from hyperspace_torch.train.checkpoint import to_tree

            return pytree.tree_flatten(to_tree(state))
        return _split(state)

    def __call__(self, state, *args):
        leaves, spec = self._leaves(state)
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
        if self.live:       # the graph's buffers are these very tensors
            held = tuple(t.data_ptr() for t in tensors) + tuple(
                id(x) for x in leaves if isinstance(x, torch.Generator))
        else:
            held = tuple(id(x) for x in leaves
                         if not isinstance(x, torch.Tensor))
        key = (spec, tuple((t.shape, t.dtype, t.device) for t in tensors),
               held,
               tuple((a.data_ptr(), a.shape) if isinstance(a, torch.Tensor)
                     else id(a) for a in pytree.tree_leaves(args)))
        if key != self._key:
            self._capture(state, args)
            self._key = key
        if not self.live:
            for s, t in zip(self._static, tensors):
                if t is not s:
                    s.copy_(t)
        self._pos.zero_()
        for _ in range(self.k):
            self.graph.replay()
        for fn, d in zip(self.counters, self._delta):
            fn.launches += d * self.k
        if self.live:
            return state, self._losses.clone()
        out = iter(self._static)
        leaves = [next(out) if isinstance(x, torch.Tensor) else x
                  for x in leaves]
        return pytree.tree_unflatten(leaves, spec), self._losses.clone()

    def _capture(self, state, args) -> None:
        if self.live:
            from hyperspace_torch.train.checkpoint import (_to_host,
                                                           load_into, to_tree)

            leaves = pytree.tree_leaves(to_tree(state))
            snapshot = _to_host(to_tree(state))
            st = state
        else:
            leaves, spec = _split(state)
            static = [t.clone() for t in _tensors(leaves)]
            out = iter(static)
            st = pytree.tree_unflatten(
                [next(out) if isinstance(x, torch.Tensor) else x
                 for x in leaves], spec)
        gens = [x for x in leaves if isinstance(x, torch.Generator)]
        if gens and not hasattr(torch.cuda.CUDAGraph,
                                "register_generator_state"):
            raise RuntimeError("chunked stepper: this PyTorch cannot "
                               "register a generator with a CUDA graph")
        self.graph = None
        dev = _tensors(leaves)[0].device
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
        if self.live:
            numbers = _numbers(to_tree(state))
            load_into(state, snapshot)     # undo the warm-up step
            if numbers != _numbers(to_tree(state)):
                raise ValueError(
                    "chunked stepper: the step changes a Python number of "
                    "its state, which a CUDA graph would freeze (keep "
                    "counts in device tensors)")
        losses = torch.zeros((self.k,) + tuple(loss.shape), dtype=loss.dtype,
                             device=dev)
        graph = torch.cuda.CUDAGraph()
        for g in gens:
            graph.register_generator_state(g)
        before = [fn.launches for fn in self.counters]
        with torch.cuda.graph(graph):
            new, loss = self._call(st, args, pos)
            if not self.live:
                for s, t in zip(static, _tensors(pytree.tree_leaves(new))):
                    s.copy_(t)
            losses.index_copy_(0, pos.reshape(1), loss.unsqueeze(0))
            pos.add_(1)
        self._delta = [fn.launches - b for fn, b in zip(self.counters,
                                                        before)]
        for fn, d in zip(self.counters, self._delta):
            fn.launches -= d
        self.graph, self._pos, self._losses = graph, pos, losses
        self._static = None if self.live else static
        self.captures += 1


def _numbers(tree) -> list:
    """The Python numbers of a plain state tree, in order."""
    return [x for x in pytree.tree_leaves(tree)
            if isinstance(x, (bool, int, float))]


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


def run_manifest(run) -> dict:
    """The run's identity, logged first in every telemetry run's JSONL:
    the whole run config, the backend and device, the process topology
    (one process of one) and the package version."""
    import dataclasses

    import hyperspace_torch

    try:
        config = dataclasses.asdict(run)
    except TypeError:           # a duck-typed run object
        config = {k: v for k, v in vars(run).items()
                  if not k.startswith("_")}
    cuda = (str(getattr(run, "device", "cuda")).startswith("cuda")
            and torch.cuda.is_available())
    return {"config": config,
            "backend": "cuda" if cuda else "cpu",
            "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 1,
            "process_index": 0, "process_count": 1,
            "version": hyperspace_torch.__version__}


def _telemetry_setup(run):
    """``(tracer, registry, freshly_enabled)`` per the run's ``telemetry``
    and ``trace_out`` (None, None, False when both are off).
    ``freshly_enabled``: this call turned the process-wide tracer on
    (library use; the CLI turns it on earlier, in ``main``, so the host
    prep's spans record too), and the loop turns it off on exit."""
    telemetry_on = bool(getattr(run, "telemetry", False))
    trace_out = getattr(run, "trace_out", None)
    tracer = reg = None
    fresh = False
    if telemetry_on or trace_out:
        from hyperspace_torch.telemetry import registry, trace

        fresh = not trace.default_tracer().enabled
        tracer = trace.enable(keep_events=bool(trace_out))
        if fresh:               # what it holds is an earlier run's
            tracer.reset()
        reg = registry.default_registry() if telemetry_on else None
    return tracer, reg, fresh


@contextlib.contextmanager
def _tracer_guard(tracer, fresh, trace_out=None):
    """Return the process-wide tracer to its state before the run when
    this run turned it on: dump ``trace_out`` (the CLI dumps later, in
    ``main``), drop the unflushed span aggregates and stop recording."""
    try:
        yield
    finally:
        if tracer is not None and fresh:
            if trace_out:
                try:
                    tracer.dump_chrome_trace(trace_out)
                except OSError:
                    pass        # diagnostics never sink the run
            tracer.flush_fields()
            tracer.enabled = False


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


@torch.no_grad()
def _poison(state, loss):
    """The ``train.step_nan`` fault: every floating tensor of the state
    NaN-ed in place (a graph's buffers keep their addresses), and a NaN
    loss — what a poisoned batch leaves once its step has run."""
    from hyperspace_torch.train.checkpoint import to_tree

    for t in pytree.tree_leaves(to_tree(state)):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            t.fill_(math.nan)
    return state, loss * math.nan


def _rollback_ctrl(run, ck, project, on_rollback):
    """The :class:`RollbackController` per ``rollback`` and
    ``rollback_lr_backoff`` (None when off); ``rollback > 0`` needs a
    checkpoint directory, the rollback target being its last committed
    step."""
    max_rb = int(getattr(run, "rollback", 0) or 0)
    if max_rb <= 0:
        return None
    if ck is None:
        raise ValueError(
            "rollback=N needs ckpt_dir= — the divergence guard rewinds "
            "to the last committed checkpoint")
    from hyperspace_torch.resilience.guard import RollbackController

    return RollbackController(
        ck, max_rollbacks=max_rb,
        lr_backoff=float(getattr(run, "rollback_lr_backoff", 0.5) or 0.5),
        project=project, on_rollback=on_rollback)


def run_loop(run, state, stepper: Callable, project: Optional[Callable] = None,
             steps_per_call: int = 1, health_fn: Optional[Callable] = None,
             on_rollback: Optional[Callable] = None):
    """The shared step loop; returns ``(state, last loss)``, the loss nan
    when no step ran.

    ``run`` has ``cli.train.RunConfig``'s fields ``steps``,
    ``eval_every``, ``log``, ``ckpt_dir``, ``ckpt_every``, ``resume`` and,
    optionally, ``tensorboard_dir``, ``health_every``/``health_eps``/
    ``health_tol``/``health_abort``, the telemetry keys ``telemetry``,
    ``trace_out``, ``metrics_out``/``metrics_every`` and
    ``profile_steps``, and the guard's ``rollback`` (the budget; 0 is
    off) and ``rollback_lr_backoff``.  ``stepper(state) -> (state,
    loss)`` runs exactly ``steps_per_call`` steps a call; a chunked
    stepper returns the ``[steps_per_call]`` losses, of which the last is
    the logged loss, and the interval's mean, last, min and max ride
    along as ``loss_*``.  A record is written whenever a call crosses a
    multiple of ``eval_every`` (50 when 0), and a chunked run closes with
    a record of the steps after the last one.  ``ckpt_dir`` saves every
    ``ckpt_every`` steps (a chunk that crosses the interval forces it;
    ``ckpt_every <= 0`` saves only the end) and always the last step;
    ``resume`` first copies the newest committed checkpoint into
    ``state`` and applies ``project`` (the re-projection onto the
    manifolds).  ``health_fn(state) -> {name: device scalar}`` is sampled
    every ``health_every`` calls.

    Telemetry (``telemetry=True``): the run manifest is the first record,
    each dispatch and boundary flush is a span (``dispatch`` with the
    step and chunk while tracing, ``metrics_flush``), every record
    carries the span aggregates (``span/*``) and the registry's counters
    since the run began (``ctr/*``), and a ``telemetry_summary`` record
    closes the stream.  ``metrics_out`` writes the registry's Prometheus
    text every ``metrics_every`` seconds and at the end.  For the first
    ``profile_steps`` steps each dispatch waits for the card to finish
    its chunk and observes ``train/phase/device_step_ms``.  With any of
    ``telemetry``, ``trace_out``, ``metrics_out`` or ``profile_steps``,
    at no host read: ``train/dispatches`` and ``train/dispatch_ms``; with
    none of them, the dispatch is the stepper's call alone (JAX counts
    both always).

    The guard (``rollback > 0``, which needs ``ckpt_dir``): a non-finite
    loss at a log boundary, at a save boundary (read there only when the
    guard is on: a poisoned state must never become the target) or at the
    run's end, or a health violation, rewinds to the last committed
    checkpoint (:mod:`hyperspace_torch.resilience.guard`);
    ``on_rollback(restored_step, attempt, lr_scale)`` is its hook."""
    from hyperspace_torch.optim.metrics import ChunkMetrics
    from hyperspace_torch.resilience import faults
    from hyperspace_torch.telemetry import registry as telem
    from hyperspace_torch.telemetry.trace import span, tracing

    tracer, reg, fresh_tracer = _telemetry_setup(run)
    profile_steps = int(getattr(run, "profile_steps", 0) or 0)
    if profile_steps > 0:
        from hyperspace_torch.train.telemetry import wait_for
    monitor, health_every = _health_monitor(run, health_fn)
    mwriter = None
    metrics_out = getattr(run, "metrics_out", None)
    if metrics_out:
        from hyperspace_torch.telemetry.exposition import MetricsFileWriter

        mwriter = MetricsFileWriter(
            metrics_out, float(getattr(run, "metrics_every", 30.0)))
    ck = None
    if run.ckpt_dir:
        from hyperspace_torch.train.checkpoint import CheckpointManager

        ck = CheckpointManager(run.ckpt_dir,
                               save_interval_steps=run.ckpt_every)
    ctrl = _rollback_ctrl(run, ck, project, on_rollback)
    acc = ChunkMetrics() if steps_per_call > 1 else None
    # a run that turned telemetry on itself (library use: runs share the
    # process-wide registry) reports its counters from here; the CLI's
    # run counts from main(), its host prep included
    counter_base = (reg.mark()
                    if (reg is not None and fresh_tracer) else None)
    # the dispatch span and counters: only where something reads them
    spine = tracer is not None or mwriter is not None or profile_steps > 0
    start = 0
    loss = math.nan

    def do_rollback(st, dn, log, reason):
        if acc is not None:
            acc.flush()         # the poisoned interval: discarded
        return ctrl.rollback(st, dn, log, reason=reason)

    def record_fields():
        if reg is None:
            return {}
        out = tracer.flush_fields() if tracer is not None else {}
        out.update(reg.snapshot("ctr/", baseline=counter_base))
        return out

    def flush_loss(loss, acc_stats: bool):
        """The boundary's host read of the loss (inside a
        ``metrics_flush`` span), with the interval's statistics."""
        t_flush = time.perf_counter()
        with span("metrics_flush"):
            kw = {"loss": float(loss)}
            if acc_stats:
                stats = acc.flush()
                if stats is not None:
                    kw.update(stats)
        telem.observe("train/metrics_flush_ms",
                      (time.perf_counter() - t_flush) * 1e3)
        return kw

    with _tracer_guard(tracer, fresh_tracer,
                       getattr(run, "trace_out", None)), \
            (ck if ck is not None else contextlib.nullcontext()), \
            _logger(run) as log:
        if reg is not None:
            log.event("run_manifest", **run_manifest(run))
        if (ck is not None and run.resume
                and ck.latest_committed_step() is not None):
            state, start = ck.restore(state, project=project)
        if ctrl is not None and ck.latest_committed_step() is None:
            # a rollback target from the first chunk on
            ck.save(start, state, force=True)
        last_saved = None
        every = run.eval_every or 50
        done = start
        chunk_i = 0
        prof_until = start + profile_steps
        while True:
            while done < run.steps:
                prof = profile_steps > 0 and done < prof_until
                if not spine:
                    state, loss = stepper(state)
                else:
                    t_disp = time.perf_counter()
                    args = ({"step": done, "chunk": steps_per_call}
                            if tracing() else None)
                    with span("dispatch", args=args):
                        state, loss = stepper(state)
                        if prof:
                            wait_for(loss)
                    disp_ms = (time.perf_counter() - t_disp) * 1e3
                    telem.observe("train/dispatch_ms", disp_ms)
                    if prof:
                        telem.observe("train/phase/device_step_ms", disp_ms)
                    telem.inc("train/dispatches")
                if mwriter is not None:
                    try:
                        mwriter.maybe_write()
                    except OSError:
                        pass    # a lost scrape file never sinks the run
                if faults.active() and faults.poison("train.step_nan"):
                    state, loss = _poison(state, loss)
                chunk_i += 1
                if acc is not None:
                    acc.add(loss)
                if loss.dim():          # a chunk's [steps_per_call] losses
                    loss = loss[-1]
                prev, done = done, done + steps_per_call
                if (done // every) > (prev // every):
                    kw = flush_loss(loss, acc is not None)
                    if ctrl is not None and ctrl.divergent(kw["loss"]):
                        state, done = do_rollback(
                            state, done, log,
                            f"non-finite loss at step {done}")
                        loss = math.nan
                        continue
                    log.log(done, **kw, **record_fields())
                if monitor is not None and chunk_i % health_every == 0:
                    if ctrl is None:
                        monitor.check(state, done, log)
                    else:
                        # the guard turns a violation (or the monitor's
                        # abort) into a rollback while its budget lasts
                        try:
                            bad = monitor.problems(
                                monitor.check(state, done, log))
                        except FloatingPointError as e:
                            bad = [str(e)]
                        if bad:
                            state, done = do_rollback(
                                state, done, log,
                                "health: " + "; ".join(bad))
                            loss = math.nan
                            continue
                if ck is not None and run.ckpt_every > 0:
                    iv = run.ckpt_every
                    crossed = (done // iv) > (prev // iv)
                    if ctrl is not None and crossed:
                        if ctrl.divergent(float(loss)):
                            state, done = do_rollback(
                                state, done, log,
                                f"non-finite loss at save boundary, "
                                f"step {done}")
                            loss = math.nan
                            continue
                    if ck.save(done, state,
                               force=crossed and steps_per_call > 1):
                        last_saved = done
            # a chunk past the last boundary can still be poisoned: never
            # close (or save) a diverged run while the guard has budget
            if ctrl is not None and done > start:
                if ctrl.divergent(float(loss)):
                    state, done = do_rollback(
                        state, done, log,
                        f"non-finite loss at run end, step {done}")
                    loss = math.nan
                    continue
            break
        if acc is not None and done > start:
            # the chunks after the last crossed boundary: every step's
            # loss lands in some record's loss_mean
            kw = flush_loss(loss, True)
            if len(kw) > 1:
                log.log(done, **kw, **record_fields())
        if ck is not None and start < run.steps and last_saved != done:
            ck.save(done, state, force=True)
        if reg is not None:
            if ck is not None:
                ck.wait()       # the ckpt/bytes gauge
            summary = reg.snapshot("ctr/", baseline=counter_base)
            if tracer is not None:
                summary.update(tracer.total_fields())
            log.event("telemetry_summary", steps=int(done), **summary)
        if mwriter is not None:
            try:
                mwriter.write()
            except OSError:
                pass
    return state, loss

"""Checkpoint and resume on ``torch.save`` (counterpart of
``hyperspace_tpu/train/checkpoint.py``, which saves through orbax).

What a checkpoint holds.  JAX saves one pytree of arrays with the PRNG
key as a leaf.  The port's training states are NamedTuples, dicts,
lists and dataclasses of tensors, ``torch.Generator`` objects and Python
numbers, and objects with a ``state_dict()``/``load_state_dict()`` pair
(an ``nn.Module`` owns its parameters, ``optim/adamw.py`` its moments and
count).  :func:`to_tree` turns such a state into a plain tree — a
NamedTuple or dataclass becomes a dict keyed by its field names, an
object its ``state_dict()`` — so a checkpoint holds every value a step
changes: parameters, optimizer moments and counts, learned curvatures,
step counts, and each generator as its ``get_state()`` tensor (a
``Generator`` itself does not load under ``weights_only=True``).

Restore in place.  :meth:`CheckpointManager.restore` reads the file with
``torch.load(weights_only=True)`` and copies each value into the live
state it is given: tensors by ``copy_``, generators by ``set_state``,
numbers set on their dataclass or optimizer.  A graphed chunked stepper
(``train/loop.py``) holds its state by address, so a restore never
swaps tensors.  A structure or shape that differs raises.

The commit rule (JAX ``_step_dir_committed``).  A save writes into a
staging directory ``<step>.checkpoint-tmp-<pid>`` and becomes the
all-digit ``<step>`` directory only by the final ``os.rename``.  An empty
directory, or one holding an entry with ``checkpoint-tmp`` in its name
(orbax's staging marker contains it too), is never a restore target,
and :meth:`CheckpointManager.__init__` removes such debris.

Saves are synchronous; the interval gate is orbax's: a step saves when it
is past the newest saved step and a multiple of ``save_interval_steps``,
or when no checkpoint exists yet.  A save that still fails with
``OSError`` after ``save_retries`` more attempts raises.

Telemetry (JAX's names): every save that started counts ``ckpt/saves``,
its seconds into ``ckpt/save_s`` and the ``ckpt/save_ms`` histogram, and
records a ``ckpt_save`` span while the tracer is on; a retried attempt
counts ``ckpt/save_retries``, removed debris ``ckpt/orphans_cleaned``;
:meth:`CheckpointManager.wait` sets the ``ckpt/bytes`` gauge while the
tracer is on.  The ``ckpt.save`` fault site (``resilience/faults.py``)
sits before each attempt's write.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Any, Callable, Optional

import torch

STAGING_MARK = "checkpoint-tmp"
STATE_FILE = "state.pt"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_dataclass_obj(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def to_tree(state: Any):
    """The plain tree of a training state (see the module docstring);
    tensors and generators stay as they are."""
    if isinstance(state, (torch.Tensor, torch.Generator)):
        return state
    if hasattr(state, "state_dict") and hasattr(state, "load_state_dict"):
        return to_tree(state.state_dict())
    if _is_namedtuple(state):
        return {f: to_tree(getattr(state, f)) for f in state._fields}
    if _is_dataclass_obj(state):
        return {f.name: to_tree(getattr(state, f.name))
                for f in dataclasses.fields(state)}
    if isinstance(state, dict):
        return {k: to_tree(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [to_tree(v) for v in state]
    if state is None or isinstance(state, (bool, int, float, str)):
        return state
    raise TypeError(f"checkpoint: cannot save a {type(state).__name__}")


def _to_host(tree):
    """A copy of a plain tree on the host: tensors copied to the CPU,
    generators as their state tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, torch.Generator):
        return tree.get_state().clone()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_host(v) for v in tree]
    return tree


def _mismatch(path: str, what: str):
    return ValueError(f"checkpoint restore: {path}: {what}")


@torch.no_grad()
def load_into(like: Any, saved, path: str = "state"):
    """Copy the saved plain tree ``saved`` into the live state ``like``
    in place and return the state (NamedTuples rebuilt around the same
    tensors, numbers replaced).  Raises where the two differ in
    structure or shape."""
    if isinstance(like, torch.Tensor):
        if (like.dim() == 0 and isinstance(saved, (int, float))
                and not isinstance(saved, bool)):
            # a count a checkpoint held as a number, now a device tensor
            like.fill_(saved)
            return like
        if not isinstance(saved, torch.Tensor) or saved.shape != like.shape:
            got = tuple(saved.shape) if isinstance(saved, torch.Tensor) \
                else type(saved).__name__
            raise _mismatch(path, f"want a tensor of shape "
                            f"{tuple(like.shape)}, got {got}")
        like.copy_(saved)
        return like
    if isinstance(like, torch.Generator):
        if not isinstance(saved, torch.Tensor):
            raise _mismatch(path, "want a generator state")
        like.set_state(saved)
        return like
    if hasattr(like, "state_dict") and hasattr(like, "load_state_dict"):
        like.load_state_dict(load_into(like.state_dict(), saved, path))
        return like
    if _is_namedtuple(like) or _is_dataclass_obj(like) or isinstance(
            like, dict):
        keys = (like._fields if _is_namedtuple(like) else
                [f.name for f in dataclasses.fields(like)]
                if _is_dataclass_obj(like) else list(like))
        if not isinstance(saved, dict) or set(saved) != set(keys):
            got = sorted(map(str, saved)) if isinstance(saved, dict) \
                else type(saved).__name__
            raise _mismatch(path, f"want the keys {sorted(map(str, keys))}, "
                            f"got {got}")
        if isinstance(like, dict):
            return type(like)((k, load_into(like[k], saved[k],
                                            f"{path}.{k}")) for k in keys)
        vals = {k: load_into(getattr(like, k), saved[k], f"{path}.{k}")
                for k in keys}
        if _is_namedtuple(like):
            return type(like)(**vals)
        for k, v in vals.items():
            setattr(like, k, v)
        return like
    if isinstance(like, (list, tuple)):
        if not isinstance(saved, list) or len(saved) != len(like):
            raise _mismatch(path, f"want a sequence of {len(like)}")
        return type(like)(load_into(a, b, f"{path}[{i}]")
                          for i, (a, b) in enumerate(zip(like, saved)))
    if like is None or isinstance(like, (bool, int, float, str)):
        if type(saved) is not type(like) and not (
                isinstance(like, float) and isinstance(saved, int)):
            raise _mismatch(path, f"want a {type(like).__name__}, got "
                            f"{type(saved).__name__}")
        return saved
    raise TypeError(f"checkpoint restore: {path}: cannot restore a "
                    f"{type(like).__name__}")


class CheckpointManager:
    """Step directories under one root, owned by one writer."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1, save_retries: int = 2,
                 retry_backoff_s: float = 0.05):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._interval = int(save_interval_steps)
        self._save_retries = max(int(save_retries), 0)
        self._retry_backoff_s = float(retry_backoff_s)
        self._clean_orphans()
        self._steps = sorted(int(n) for n in os.listdir(self._dir)
                             if n.isdigit())

    def _clean_orphans(self) -> None:
        """Remove what a process killed mid-save left: staging
        directories and all-digit directories that fail the commit
        rule (they would shadow the resume scan forever)."""
        try:
            entries = os.listdir(self._dir)
        except OSError:
            return
        orphans = [os.path.join(self._dir, n) for n in entries
                   if STAGING_MARK in n or (
                       n.isdigit() and os.path.isdir(os.path.join(
                           self._dir, n)) and not _step_dir_committed(
                           os.path.join(self._dir, n)))]
        cleaned = 0
        for path in orphans:
            try:
                if os.path.isdir(path):
                    shutil.rmtree(path)
                else:
                    os.remove(path)
                cleaned += 1
            except OSError as e:
                print(f"[ckpt] failed to clean orphan {path}: {e}",
                      flush=True)
        if cleaned:
            from hyperspace_torch.telemetry import registry as telem

            telem.inc("ckpt/orphans_cleaned", cleaned)
            print(f"[ckpt] cleaned {cleaned} orphaned staging dir(s) under "
                  f"{self._dir} (crash between staging write and commit "
                  "rename)", flush=True)

    def should_save(self, step: int) -> bool:
        """Past the newest saved step, and on the interval or the first."""
        if self._steps and self._steps[-1] >= step:
            return False
        return not self._steps or (self._interval > 0
                                   and step % self._interval == 0)

    def _write(self, step: int, tree) -> None:
        staging = os.path.join(self._dir,
                               f"{int(step)}.{STAGING_MARK}-{os.getpid()}")
        if os.path.exists(staging):
            shutil.rmtree(staging)
        os.makedirs(staging)
        torch.save(tree, os.path.join(staging, STATE_FILE))
        os.rename(staging, os.path.join(self._dir, str(int(step))))

    def _fault_point(self, step: int) -> None:
        """The ``ckpt.save`` fault site: latency sleeps; ``ioerror``
        raises :class:`InjectedIOError` (an ``OSError``: the retry loop
        absorbs it); ``crash_staged`` leaves the debris of a process
        killed between the staging write and the commit rename (an
        uncommitted step directory and a staging directory), then raises
        :class:`InjectedCrash`, which is not retried."""
        from hyperspace_torch.resilience import faults

        spec = faults.due("ckpt.save")
        if spec is None:
            return
        if spec.kind == "latency":
            time.sleep(spec.ms / 1e3)
        elif spec.kind == "ioerror":
            raise faults.InjectedIOError("injected IOError at ckpt.save")
        elif spec.kind == "crash_staged":
            partial = os.path.join(self._dir, str(int(step)))
            os.makedirs(os.path.join(partial, f"tmp.{STAGING_MARK}-0"),
                        exist_ok=True)
            os.makedirs(os.path.join(self._dir,
                                     f"{int(step)}.{STAGING_MARK}-0"),
                        exist_ok=True)
            raise faults.InjectedCrash(
                "injected crash between staging write and commit rename")

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Save if the interval gate (or ``force``) says so; True if it
        saved.  The state is copied to the host first; ``OSError`` is
        retried ``save_retries`` more times with exponential backoff and
        then raised."""
        from hyperspace_torch.resilience import faults
        from hyperspace_torch.telemetry import registry as telem
        from hyperspace_torch.telemetry.trace import default_tracer

        t0 = time.perf_counter()
        if not (force or self.should_save(step)):
            return False
        if step in self._steps:
            raise FileExistsError(f"checkpoint for step {step} exists")
        tree = _to_host(to_tree(state))
        for attempt in range(self._save_retries + 1):
            try:
                if faults.active():
                    self._fault_point(step)
                self._write(step, tree)
                break
            except OSError as e:
                if attempt >= self._save_retries:
                    raise
                telem.inc("ckpt/save_retries")
                delay = self._retry_backoff_s * (2 ** attempt)
                print(f"[ckpt] save step {step} attempt {attempt + 1} "
                      f"failed ({e}); retrying in {delay:.3g}s", flush=True)
                time.sleep(delay)
        self._steps = sorted(self._steps + [int(step)])
        while self._max_to_keep and len(self._steps) > self._max_to_keep:
            shutil.rmtree(os.path.join(self._dir, str(self._steps.pop(0))))
        t1 = time.perf_counter()
        telem.inc("ckpt/saves")
        telem.inc("ckpt/save_s", t1 - t0)
        telem.observe("ckpt/save_ms", (t1 - t0) * 1e3)
        tracer = default_tracer()
        if tracer.enabled:
            tracer.record_span("ckpt_save", t0, t1, args={"step": int(step)})
        return True

    def restore(self, state_like: Any, *, step: Optional[int] = None,
                project: Optional[Callable[[Any], Any]] = None
                ) -> tuple[Any, int]:
        """Copy the newest committed step (or ``step``) into
        ``state_like`` in place, then apply ``project``; returns
        ``(state, step)``.  Raises ``FileNotFoundError`` when there is no
        such committed step."""
        step = self.latest_committed_step() if step is None else step
        tree, step = restore_params_only(self._dir, step=step)
        state = load_into(state_like, tree)
        if project is not None:
            state = project(state)
        return state, step

    def latest_step(self) -> Optional[int]:
        return self._steps[-1] if self._steps else None

    def latest_committed_step(self) -> Optional[int]:
        return _latest_committed_step(self._dir)

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight.  While the
        tracer is on (a telemetry run), sets the ``ckpt/bytes`` gauge to
        the directory's size."""
        from hyperspace_torch.telemetry.trace import default_tracer

        if default_tracer().enabled:
            from hyperspace_torch.telemetry import registry as telem

            telem.set_gauge("ckpt/bytes", dir_bytes(self._dir))

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
        self.close()


def restore_params_only(directory: str, *, step: Optional[int] = None
                        ) -> tuple[Any, int]:
    """A checkpoint's plain tree with no optimizer or model object: dicts
    keyed by field names (``tree["params"]["table"]``), tensors on the
    CPU, generators as their state tensors.  ``step=None`` is the newest
    committed step; an uncommitted or missing step raises
    ``FileNotFoundError``.  Returns ``(tree, step)``."""
    directory = os.path.abspath(directory)
    if step is None:
        step = _latest_committed_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {directory}")
    path = os.path.join(directory, str(int(step)))
    if not _step_dir_committed(path):
        raise FileNotFoundError(
            f"step {step} under {directory} is missing or uncommitted")
    tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    return tree, int(step)


def dir_bytes(directory: str) -> int:
    """Bytes on disk under ``directory`` (a file that vanishes while it
    is walked counts 0; a missing directory is 0)."""
    total = 0
    try:
        for root, _dirs, files in os.walk(directory):
            for name in files:
                try:
                    total += os.path.getsize(os.path.join(root, name))
                except OSError:
                    pass
    except OSError:
        pass
    return total


def _step_dir_committed(path: str) -> bool:
    """A non-empty directory with no staging entry in it, not itself a
    staging directory."""
    if STAGING_MARK in os.path.basename(os.path.normpath(path)):
        return False
    try:
        entries = os.listdir(path)
    except OSError:
        return False
    return bool(entries) and not any(STAGING_MARK in e for e in entries)


def _latest_committed_step(directory: str) -> Optional[int]:
    """The newest all-digit step directory that passes the commit rule:
    the one scan behind the restore target and the resume offset."""
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    for s in sorted((int(n) for n in names if n.isdigit()), reverse=True):
        if _step_dir_committed(os.path.join(directory, str(s))):
            return s
    return None


def peek_latest_step(directory: str) -> int:
    """The newest committed step under ``directory``, 0 if none, without
    a manager (nothing is created on disk)."""
    step = _latest_committed_step(os.path.abspath(directory))
    return 0 if step is None else step


def reproject_params(tags, params=None):
    """A ``project`` function from a tag structure (``optim.tags``):
    ``proj`` on every manifold-tagged leaf, Euclidean leaves as they
    are."""
    from hyperspace_torch.optim.tags import map_tagged

    def apply(tree):
        return map_tagged(lambda t, p: p if t is None else t.proj(p),
                          tags, tree)

    return apply


def reproject_rows(manifold, x: torch.Tensor,
                   tol: Optional[float] = None) -> torch.Tensor:
    """``manifold.proj`` on the rows of ``x`` whose constraint residual
    (``check_point``) exceeds ``tol`` (default 100× the dtype's epsilon:
    1e-5 in float32), every other row bitwise as it is.  JAX re-projects
    every row, but ``proj`` is not bitwise idempotent (the sphere's
    x/‖x‖·r moves an ulp), so a resumed run would leave the run it
    continues; the rows that drifted off (another dtype, a corrupt
    value) are projected all the same."""
    from hyperspace_torch.manifolds import smath

    if tol is None:
        tol = 100.0 * smath.eps_for(x.dtype)
    off = manifold.check_point(x) > tol
    return torch.where(off[..., None], manifold.proj(x), x)

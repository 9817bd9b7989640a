"""The divergence guard (``resilience/guard.py``) and the rollback
branch of ``train/loop.py:run_loop``, against the JAX package on the
CPU; the fault sites the train CLI arms (``ckpt.save`` in
``train/checkpoint.py``, ``train.step_nan`` in ``train/loop.py``) and the
CLI's guard keys, held to their documented contract.

JAX's guard runs here when no fault is armed (its ``faults.install``
seeds ``random.Random`` with a tuple, which Python 3.12 refuses), so the
loop-level cases poison themselves: a toy stepper returns a NaN state
and loss at chosen calls, and a toy health function flags chosen
samples.  The same toy goes through JAX's ``run_loop`` and the port's,
and the two must agree on every record (the loss rows, the ``rollback``
events with their ``step``, ``restored_step``, ``reason``, ``attempt``
and ``lr_scale``, the health rows), the final state and loss, the
``on_rollback`` hook's arguments, the printed incidents, the counters
(``resilience/rollbacks``, ``health/checks``, ``health/warnings``,
``ckpt/saves``), the last committed step, and on
:class:`RollbackExhausted` and :class:`DivergenceError` with their
messages.

The contract cases, on the port alone: a non-finite loss injected by
the ``train.step_nan`` fault at a log boundary rewinds to the last
committed checkpoint, and the run then continues to the very state an
unfaulted run reaches (the restore brings back the generators and
optimizer counts too); an idle guard changes no bit; an injected
``ckpt.save`` IOError is retried and counted, an injected crash is not
retried and leaves debris the next manager cleans.
"""

import io
import json
import math
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from hyperspace_tpu.cli.train import RunConfig as JRun
from hyperspace_tpu.resilience import guard as jguard
from hyperspace_tpu.telemetry import registry as jtelem
from hyperspace_tpu.train import checkpoint as JC
from hyperspace_tpu.train import loop as JL
from hyperspace_torch.cli import train as tcli
from hyperspace_torch.resilience import guard as tguard
from hyperspace_torch.resilience import faults
from hyperspace_torch.resilience.faults import (FaultSpec, InjectedCrash,
                                                InjectedIOError)
from hyperspace_torch.resilience.guard import (DivergenceError,
                                               RollbackController,
                                               RollbackExhausted)
from hyperspace_torch.telemetry import registry as telem
from hyperspace_torch.train import checkpoint as TC
from hyperspace_torch.train import loop as TL
from hyperspace_torch.train.logging import read_jsonl

HYBONET = ["hybonet", "dim=16", "num_heads=2", "num_layers=1",
           "batch_size=8", "device=cpu"]


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    for reg in (jtelem, telem):
        reg.default_registry().reset()
    yield
    faults.clear()
    for reg in (jtelem, telem):
        reg.default_registry().reset()


def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tcli.main(argv) == 0
    return json.loads(buf.getvalue().splitlines()[-1])


def _same(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _plain(recs):
    return [{k: v for k, v in r.items() if k not in ("ts", "host")}
            for r in recs if "event" not in r]


# --- the guard against JAX's loop -------------------------------------------

GUARD_COUNTERS = ("resilience/rollbacks", "health/checks", "health/warnings",
                  "ckpt/saves")


def _toy(side: str, poison, flag, k: int):
    """``(state, stepper, health_fn)`` of the toy run on ``side`` ("j" for
    JAX, "t" for the port): a step takes ``x`` to ``x / 2 + 1`` and
    ``step`` to ``step + 1`` with the loss ``(x[0] + step) / 8``; a call
    runs ``k`` steps (their losses stacked when ``k > 1``); the calls
    numbered in ``poison`` (from 1) return ``x`` and the losses NaN, what
    a poisoned batch leaves; the health samples numbered in ``flag``
    report one non-finite value."""
    calls, samples = [0], [0]
    if side == "j":
        state = {"x": jnp.zeros(3, jnp.float32),
                 "step": jnp.zeros((), jnp.int32)}
        nan, stack = jnp.float32(jnp.nan), jnp.stack
        as_f32 = (lambda n: n.astype(jnp.float32))
        count = jnp.asarray
    else:
        state = {"x": torch.zeros(3),
                 "step": torch.zeros((), dtype=torch.int32)}
        nan, stack = torch.tensor(math.nan), torch.stack
        as_f32 = (lambda n: n.to(torch.float32))
        count = torch.tensor

    def stepper(st):
        calls[0] += 1
        losses = []
        for _ in range(k):
            x, n = st["x"] * 0.5 + 1.0, st["step"] + 1
            st = {"x": x, "step": n}
            losses.append((x[0] + as_f32(n)) / 8)
        if calls[0] in poison:
            st = {"x": st["x"] * nan, "step": st["step"]}
            losses = [v * nan for v in losses]
        return st, (stack(losses) if k > 1 else losses[0])

    def health(st):
        samples[0] += 1
        return {"nonfinite": count(1 if samples[0] in flag else 0)}

    return state, stepper, health


def _guarded_run(side: str, tmp, name: str, kw: dict, poison=(), flag=(),
                 k: int = 1, capsys=None):
    """One toy run through ``side``'s ``run_loop``: what a guard can be
    seen to do, each value on the host."""
    log = str(tmp / f"{name}-{side}.jsonl")
    ck = str(tmp / f"{name}-{side}")
    state, stepper, health = _toy(side, set(poison), set(flag), k)
    hooked, out = [], {}
    reg = (jtelem if side == "j" else telem).default_registry()
    reg.reset()
    if side == "j":
        run, loop_ = JRun(log=log, ckpt_dir=ck, **kw), JL
    else:
        run, loop_ = tcli.RunConfig(log=log, ckpt_dir=ck, device="cpu",
                                    **kw), TL
    try:
        state, loss = loop_.run_loop(
            run, state, stepper, steps_per_call=k,
            health_fn=health if kw.get("health_every") else None,
            on_rollback=lambda *a: hooked.append(a))
        out["state"] = {key: np.asarray(v).tolist()
                        for key, v in state.items()}
        out["loss"] = float(loss)
    except (jguard.RollbackExhausted, tguard.RollbackExhausted,
            jguard.DivergenceError, tguard.DivergenceError) as e:
        out["raised"] = (type(e).__name__, str(e))
    out["records"] = [{key: v for key, v in r.items()
                       if key not in ("ts", "host")}
                      for r in read_jsonl(log)]
    out["hooked"] = hooked
    out["counters"] = {c: reg.get(c) for c in GUARD_COUNTERS}
    mgr = (JC if side == "j" else TC).CheckpointManager(ck)
    out["committed"] = mgr.latest_committed_step()
    if side == "j":
        mgr.close()
    if capsys is not None:
        out["printed"] = [line for line in capsys.readouterr().out.splitlines()
                          if line.startswith(("[resilience]", "[health]"))]
    return out


GUARD_CASES = {
    # the third step NaN; the log boundary at step 4 rewinds to step 2
    "log_boundary": (dict(steps=8, eval_every=2, ckpt_every=2, rollback=1),
                     (3,), (), 1),
    # no log boundary before step 8: the save boundary at 4 reads the loss
    "save_boundary": (dict(steps=8, eval_every=8, ckpt_every=2, rollback=1),
                      (3,), (), 1),
    # no boundary after step 4: the run's end reads the NaN
    "run_end": (dict(steps=6, eval_every=8, ckpt_every=4, rollback=1),
                (5,), (), 1),
    # two incidents, the second at attempt 2 with lr_scale 0.25 ** 2
    "two_rollbacks": (dict(steps=8, eval_every=2, ckpt_every=2, rollback=2,
                           rollback_lr_backoff=0.25), (3, 7), (), 1),
    # chunks of 2 steps: the interval's loss_* statistics are discarded
    "chunked": (dict(steps=8, eval_every=4, ckpt_every=4, rollback=1),
                (3,), (), 2),
    # the third health sample flags: a rollback, not a warning
    "health": (dict(steps=6, eval_every=1, ckpt_every=2, health_every=1,
                    rollback=1), (), (3,), 1),
    # the same flag without the guard: a warning, the run goes on
    "health_unguarded": (dict(steps=6, eval_every=1, ckpt_every=2,
                              health_every=1), (), (3,), 1),
    # every call from the third on is NaN: past the budget of one
    "exhausted": (dict(steps=8, eval_every=2, ckpt_every=2, rollback=1),
                  range(3, 40), (), 1),
    # the guard on, no incident
    "idle": (dict(steps=8, eval_every=2, ckpt_every=2, rollback=1),
             (), (), 1),
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_guard_matches_jax_run_loop(case, tmp_path, capsys):
    kw, poison, flag, k = GUARD_CASES[case]
    j, t = (_guarded_run(side, tmp_path, case, kw, poison, flag, k, capsys)
            for side in "jt")
    assert t == j
    rollbacks = [r for r in t["records"] if r.get("event") == "rollback"]
    assert len(rollbacks) == t["counters"]["resilience/rollbacks"]
    assert len(rollbacks) == {"health_unguarded": 0, "idle": 0,
                              "two_rollbacks": 2}.get(case, 1)
    if case == "exhausted":
        assert t["raised"][0] == "RollbackExhausted"
    else:
        assert "raised" not in t and t["state"]["step"] == kw["steps"]
        assert math.isfinite(t["loss"])


def test_guard_idle_matches_the_unguarded_run(tmp_path):
    """With the guard on and no incident the port's records, state and
    loss are the unguarded run's (the guard's one initial save aside),
    as JAX's are."""
    kw = dict(steps=8, eval_every=2, ckpt_every=2)
    for side in "jt":
        plain = _guarded_run(side, tmp_path, "plain", kw)
        idle = _guarded_run(side, tmp_path, "idle", dict(kw, rollback=2))
        for key in ("records", "state", "loss", "committed", "hooked"):
            assert plain[key] == idle[key], (side, key)


def test_divergence_without_a_commit_matches_jax(tmp_path):
    """No committed checkpoint to rewind to: the same error and message,
    and the same refusals of a bad budget or backoff."""
    got = {}
    for side, G, CM, st in (
            ("j", jguard, JC.CheckpointManager, {"x": jnp.zeros(2)}),
            ("t", tguard, TC.CheckpointManager, {"x": torch.zeros(2)})):
        ck = CM(str(tmp_path / side))
        ctrl = G.RollbackController(ck, max_rollbacks=2, lr_backoff=0.25)
        errs = [ctrl.divergent(v) for v in (math.nan, math.inf, 1.0)]
        with pytest.raises(G.DivergenceError) as e:
            ctrl.rollback(st, 7)
        errs.append(str(e.value))
        for bad in (dict(max_rollbacks=0), dict(lr_backoff=0.0),
                    dict(lr_backoff=1.5)):
            with pytest.raises(ValueError) as e:
                G.RollbackController(ck, **bad)
            errs.append(str(e.value))
        got[side] = errs
        if side == "j":
            ck.close()
    assert got["t"] == got["j"]
    assert got["t"][:3] == [True, True, False]


def test_rollback_at_a_nan_restores_the_last_commit(tmp_path):
    """The third dispatch is poisoned; the log boundary at step 4 reads a
    NaN and rewinds to the commit at step 2; the run ends where an
    unfaulted run ends, bit for bit."""
    base = HYBONET + ["steps=8", "ckpt_every=2", "eval_every=2"]
    clean = _cli(base + [f"ckpt_dir={tmp_path / 'a'}"])
    log = tmp_path / "g.jsonl"
    res = _cli(base + [f"ckpt_dir={tmp_path / 'b'}", f"log={log}",
                       "rollback=1", "chaos=train.step_nan:nan:after=2"])
    events = [r for r in read_jsonl(str(log)) if r.get("event") == "rollback"]
    assert len(events) == 1
    ev = events[0]
    assert (ev["step"], ev["restored_step"], ev["attempt"]) == (4, 2, 1)
    assert ev["lr_scale"] == 0.5 and "non-finite loss" in ev["reason"]
    assert res["chaos"]["fired"] == 1 and not faults.active()
    assert math.isfinite(res["loss"]) and res["loss"] == clean["loss"]
    assert telem.default_registry().get("resilience/rollbacks") == 1
    ta, sa = TC.restore_params_only(str(tmp_path / "a"))
    tb, sb = TC.restore_params_only(str(tmp_path / "b"))
    assert sa == sb == 8 and _same(ta, tb)


def test_rollback_budget_exhausted(tmp_path):
    with pytest.raises(RollbackExhausted, match="persisted after 1"):
        _cli(HYBONET + ["steps=8", "ckpt_every=2", "eval_every=2",
                        f"ckpt_dir={tmp_path}", "rollback=1",
                        "chaos=train.step_nan:nan:after=1:times=0"])


def test_divergence_without_a_commit_raises(tmp_path):
    ck = TC.CheckpointManager(str(tmp_path))
    ctrl = RollbackController(ck, max_rollbacks=2, lr_backoff=0.25)
    assert ctrl.divergent(math.nan) and ctrl.divergent(math.inf)
    assert not ctrl.divergent(1.0)
    with pytest.raises(DivergenceError, match="no committed checkpoint"):
        ctrl.rollback({"x": torch.zeros(2)}, 7)
    with pytest.raises(ValueError, match="max_rollbacks"):
        RollbackController(ck, max_rollbacks=0)
    with pytest.raises(ValueError, match="lr_backoff"):
        RollbackController(ck, lr_backoff=0.0)


def test_idle_guard_changes_no_bit(tmp_path):
    base = HYBONET + ["steps=8", "ckpt_every=4", "eval_every=2",
                      "scan_chunk=2"]
    runs = []
    for name, extra in (("off", []), ("on", ["rollback=2"])):
        log = tmp_path / f"{name}.jsonl"
        res = _cli(base + extra + [f"ckpt_dir={tmp_path / name}",
                                   f"log={log}"])
        tree, step = TC.restore_params_only(str(tmp_path / name))
        runs.append((res, tree, step, _plain(read_jsonl(str(log)))))
    (r0, t0, s0, l0), (r1, t1, s1, l1) = runs
    assert r0 == r1 and s0 == s1 == 8 and l0 == l1 and _same(t0, t1)


def _toy_stepper():
    def step(st):
        n = st["step"] + 1
        return {"x": st["x"] * 0.5 + 1.0, "step": n}, n.to(
            torch.float32) / 8.0

    return {"x": torch.zeros(3), "step": torch.zeros((), dtype=torch.int64)}, \
        step


def test_health_violation_triggers_rollback(tmp_path):
    calls = []

    def health(st):
        calls.append(int(st["step"]))
        bad = len(calls) == 3          # the third sample flags
        return {"nonfinite": torch.tensor(1 if bad else 0)}

    state, step = _toy_stepper()
    log = tmp_path / "h.jsonl"
    run = tcli.RunConfig(steps=6, eval_every=1, ckpt_every=2, health_every=1,
                         ckpt_dir=str(tmp_path / "ck"), log=str(log),
                         rollback=1, device="cpu")
    hooked = []
    state, loss = TL.run_loop(run, state, step, health_fn=health,
                              on_rollback=lambda *a: hooked.append(a))
    ev = [r for r in read_jsonl(str(log)) if r.get("event") == "rollback"]
    assert len(ev) == 1 and ev[0]["reason"].startswith("health: ")
    assert (ev[0]["step"], ev[0]["restored_step"]) == (3, 2)
    assert hooked == [(2, 1, 0.5)]
    assert int(state["step"]) == 6 and float(loss) == 6 / 8
    assert telem.default_registry().get("health/warnings") == 1
    assert telem.default_registry().get("health/checks") == len(calls)


def test_save_ioerror_is_retried_and_counted(tmp_path):
    faults.install([FaultSpec("ckpt.save", "ioerror", times=2)])
    ck = TC.CheckpointManager(str(tmp_path), retry_backoff_s=0.0)
    assert ck.save(1, {"x": torch.ones(2)}, force=True)
    reg = telem.default_registry()
    assert reg.get("ckpt/save_retries") == 2 and reg.get("ckpt/saves") == 1
    assert reg.get("fault/fired") == 2
    assert reg.snapshot()["hist/ckpt/save_ms"]["count"] == 1
    assert ck.latest_committed_step() == 1
    faults.install([FaultSpec("ckpt.save", "ioerror", times=3)])
    with pytest.raises(InjectedIOError):
        ck.save(2, {"x": torch.ones(2)}, force=True)
    assert reg.get("ckpt/saves") == 1 and ck.latest_committed_step() == 1


def test_save_crash_is_not_retried_and_its_debris_is_cleaned(tmp_path):
    faults.install([FaultSpec("ckpt.save", "crash_staged")])
    ck = TC.CheckpointManager(str(tmp_path), retry_backoff_s=0.0)
    with pytest.raises(InjectedCrash):
        ck.save(3, {"x": torch.ones(2)}, force=True)
    reg = telem.default_registry()
    assert reg.get("ckpt/save_retries") == 0 and reg.get("ckpt/saves") == 0
    assert ck.latest_committed_step() is None
    faults.clear()
    ck2 = TC.CheckpointManager(str(tmp_path))
    assert reg.get("ckpt/orphans_cleaned") == 2
    assert ck2.latest_committed_step() is None
    assert ck2.save(3, {"x": torch.ones(2)}, force=True)


def test_cli_save_ioerror_run_completes(tmp_path):
    res = _cli(HYBONET + ["steps=4", "ckpt_every=2", f"ckpt_dir={tmp_path}",
                          "chaos=ckpt.save:ioerror:times=2"])
    assert res["chaos"]["fired"] == 2 and math.isfinite(res["loss"])
    assert telem.default_registry().get("ckpt/save_retries") == 2
    assert TC.peek_latest_step(str(tmp_path)) == 4


@pytest.mark.parametrize("argv,match", [
    (["rollback=1"], "rollback=N needs ckpt_dir"),
    (["chaos=data.next_batch:ioerror:prob=2"],
     "data.next_batch.*prob must be in"),
    (["metrics_out=m.prom", "metrics_every=0"], "metrics_every=0"),
    (["chaos=ckpt.save:explode"], "fault kind"),
    (["chaos=ckpt.save"], "want site:kind")])
def test_cli_exits_on_guard_usage_errors(argv, match):
    with pytest.raises(SystemExit, match=match):
        tcli.main(HYBONET + ["steps=1", *argv])
    assert not faults.active()


def _key_value(key, tmp_path):
    return {"telemetry": "1", "trace_out": str(tmp_path / "t.json"),
            "metrics_out": str(tmp_path / "m.prom"), "metrics_every": "5",
            "profile_steps": "2", "chaos": "ckpt.save:ioerror",
            "chaos_seed": "1", "rollback": "1",
            "rollback_lr_backoff": "0.25"}[key]


@pytest.mark.parametrize("key", [
    "telemetry", "trace_out", "metrics_out", "metrics_every",
    "profile_steps", "chaos", "chaos_seed", "rollback",
    "rollback_lr_backoff"])
def test_cli_spine_and_guard_keys_are_taken(key, tmp_path):
    """The keys that exited "not ported" before this slice run."""
    assert key not in tcli.NOT_PORTED
    res = _cli(HYBONET + ["steps=2", f"ckpt_dir={tmp_path / 'ck'}",
                          f"{key}={_key_value(key, tmp_path)}"])
    assert res["workload"] == "hybonet" and math.isfinite(res["loss"])
    assert ("chaos" in res) == (key == "chaos")
    assert not faults.active()

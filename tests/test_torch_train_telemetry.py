"""The train plane's telemetry spine — ``train/loop.py:run_loop`` with
``telemetry``, ``metrics_out`` and ``profile_steps``, ``train/telemetry.py``,
``train/profiling.py``, ``train/debug.py`` and the registry — against
the JAX package on the CPU.

The same Poincaré-embedding run (the depth-3 tree, dim 4, chunks of 4
steps, a checkpoint every 4 steps, health sampled every chunk) goes
through JAX's loop and the port's: the manifest is the first record with
the same keys and config keys (the port adds ``device``), the records
carry the same ``span/*`` names and the counters both packages count
(``train/dispatches``, ``ckpt/saves``, ``health/checks``) with equal
values, and each closes with a ``telemetry_summary``.  Losses differ
(each side draws its own batches) and are not compared here.
"""

import dataclasses
import importlib
import json
import math

import jax.numpy as jnp
import pytest
import torch

from hyperspace_tpu.cli.train import RunConfig as JRun
from hyperspace_tpu.data.wordnet import synthetic_tree as j_tree
from hyperspace_tpu.manifolds import PoincareBall as JBall
from hyperspace_tpu.models import poincare_embed as jpe
from hyperspace_tpu.telemetry import health as jhealth
from hyperspace_tpu.telemetry import registry as jtelem
from hyperspace_tpu.telemetry import trace as jtrace
from hyperspace_tpu.train import loop as JL
from hyperspace_tpu.train import profiling as jprof
from hyperspace_torch.cli import train as tcli
from hyperspace_torch.data.wordnet import synthetic_tree as t_tree
from hyperspace_torch.manifolds import PoincareBall as TBall
from hyperspace_torch.models import poincare_embed as tpe
from hyperspace_torch.telemetry import health as thealth
from hyperspace_torch.telemetry import registry as ttelem
from hyperspace_torch.telemetry import trace as ttrace
from hyperspace_torch.train import debug as tdebug
from hyperspace_torch.train import loop as TL
from hyperspace_torch.train import profiling as tprof
from hyperspace_torch.train import telemetry as ttel
from hyperspace_torch.train.logging import read_jsonl

K = 4
SHARED_COUNTERS = ("train/dispatches", "ckpt/saves", "health/checks")


@pytest.fixture(autouse=True)
def _clean_telemetry():
    tracers = (jtrace.default_tracer(), ttrace.default_tracer())
    was = [(t.enabled, t.keep_events) for t in tracers]
    for reg in (jtelem, ttelem):
        reg.default_registry().reset()
    for t in tracers:
        t.reset()
        t.enabled = False
    yield
    for reg in (jtelem, ttelem):
        reg.default_registry().reset()
    for t, (en, keep) in zip(tracers, was):
        t.reset()
        t.enabled, t.keep_events = en, keep


_J = {}


def _jax_stepper():
    """JAX's chunked step, compiled once for the module."""
    if not _J:
        ds = j_tree(depth=3, branching=3)
        cfg = jpe.PoincareEmbedConfig(num_nodes=ds.num_nodes, dim=4,
                                      batch_size=16, neg_samples=4)
        _, opt = jpe.init_state(cfg, 1)
        step = jpe.make_train_step(cfg)
        pairs = jnp.asarray(ds.pairs)
        _J.update(cfg=cfg, chunk=JL.make_chunked_stepper(
            lambda st: step(cfg, opt, st, pairs), K))
    return _J


def _run(side: str, tmp, name: str, **kw):
    """One run of ``kw`` through ``side``'s loop; its records."""
    log = str(tmp / f"{name}-{side}.jsonl")
    kw = dict(dict(steps=12, eval_every=4, ckpt_every=4, health_every=1,
                   ckpt_dir=str(tmp / f"{name}-{side}")), **kw)
    if side == "j":
        j = _jax_stepper()
        state, _ = jpe.init_state(j["cfg"], 1)
        JL.run_loop(JRun(log=log, **kw), state, j["chunk"],
                    steps_per_call=K,
                    health_fn=jhealth.make_health_fn(
                        JBall(1.0), params_of=lambda st: st.table))
    else:
        ds = t_tree(depth=3, branching=3)
        cfg = tpe.PoincareEmbedConfig(num_nodes=ds.num_nodes, dim=4,
                                      batch_size=16, neg_samples=4)
        state, opt = tpe.init_state(cfg, 1, "cpu")
        step = tpe.make_train_step(cfg)
        pairs = torch.as_tensor(ds.pairs, dtype=torch.int64)
        chunk = TL.make_chunked_stepper(
            lambda st: step(cfg, opt, st, pairs), K)
        TL.run_loop(tcli.RunConfig(log=log, device="cpu", **kw), state,
                    chunk, steps_per_call=K,
                    health_fn=thealth.make_health_fn(
                        TBall(1.0), params_of=lambda st: st.table))
    return read_jsonl(log)


def _fields(recs, prefix):
    return {k for r in recs for k in r if k.startswith(prefix)}


def test_manifest_is_first_with_jax_keys(tmp_path):
    j, t = (_run(s, tmp_path, "m", telemetry=True) for s in "jt")
    jm, tm = j[0], t[0]
    assert jm["event"] == tm["event"] == "run_manifest"
    assert set(tm) == set(jm)
    assert set(tm["config"]) == set(jm["config"]) | {"device"}
    assert tm["config"]["telemetry"] and tm["config"]["steps"] == 12
    assert (tm["backend"], tm["device_kind"], tm["device_count"],
            tm["process_index"], tm["process_count"]) == ("cpu", "cpu", 1,
                                                          0, 1)


def test_records_carry_the_same_spans_and_counters(tmp_path):
    j, t = (_run(s, tmp_path, "s", telemetry=True) for s in "jt")
    assert _fields(t, "span/") == _fields(j, "span/")
    assert {"span/dispatch_n", "span/metrics_flush_n",
            "span/ckpt_save_n"} <= _fields(t, "span/")
    for name in SHARED_COUNTERS:
        assert f"ctr/{name}" in _fields(t, "ctr/")
    js, ts = j[-1], t[-1]
    assert js["event"] == ts["event"] == "telemetry_summary"
    for name in SHARED_COUNTERS:
        assert ts[f"ctr/{name}"] == js[f"ctr/{name}"], name
    assert ts["ctr/train/dispatches"] == 3 and ts["steps"] == js["steps"]
    steps = [r for r in t if "loss" in r]
    assert [r["ctr/train/dispatches"] for r in steps] == [1, 2, 3]
    assert all(r["span/dispatch_s"] > 0 for r in steps)


def test_telemetry_off_adds_nothing(tmp_path):
    on = _run("t", tmp_path, "on", telemetry=True)
    ttelem.default_registry().reset()
    off = _run("t", tmp_path, "off")
    assert all("event" not in r for r in off)
    assert not (_fields(off, "ctr/") | _fields(off, "span/")
                | _fields(off, "hist/"))

    def plain(recs):
        return [{k: v for k, v in r.items() if k not in ("ts", "host")
                 and not k.startswith(("ctr/", "span/", "hist/"))}
                for r in recs if "event" not in r]

    assert plain(off) == plain(on)
    # nothing in the hot loop: no dispatch span, count or histogram
    snap = ttelem.default_registry().snapshot()
    assert "train/dispatches" not in snap
    assert "hist/train/dispatch_ms" not in snap
    assert not ttrace.default_tracer().enabled


def test_second_in_process_run_reports_only_its_own_counts(tmp_path):
    for i, steps in enumerate((8, 12)):
        recs = _run("t", tmp_path, f"r{i}", telemetry=True, steps=steps,
                    ckpt_dir=None)
        summary = recs[-1]
        assert summary["event"] == "telemetry_summary"
        assert summary["ctr/train/dispatches"] == steps // K
        assert summary["span/dispatch_n"] == steps // K
    assert ttelem.default_registry().get("train/dispatches") == 5


def test_profile_steps_histograms_match_jax(tmp_path):
    """``profile_steps=5`` profiles the chunks that start below step 5:
    two of three, on both sides."""
    counts = []
    for side, reg in (("j", jtelem), ("t", ttelem)):
        _run(side, tmp_path, "p", profile_steps=5, ckpt_dir=None)
        snap = reg.default_registry().snapshot()
        counts.append((snap["hist/train/phase/device_step_ms"]["count"],
                       snap["hist/train/dispatch_ms"]["count"]))
    assert counts[1] == counts[0] == (2, 3)


def _parse_prometheus(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out


def test_metrics_out_and_trace_out(tmp_path):
    prom, trace = tmp_path / "m.prom", tmp_path / "t.json"
    _run("t", tmp_path, "x", telemetry=True, metrics_out=str(prom),
         metrics_every=3600.0, trace_out=str(trace))
    vals = _parse_prometheus(prom.read_text())
    assert vals['hyperspace_train_dispatches{process_index="0"}'] == 3
    assert vals['hyperspace_ckpt_saves{process_index="0"}'] == 3
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"dispatch", "metrics_flush", "ckpt_save"} <= names
    assert not ttrace.default_tracer().enabled


def test_step_phases_bounds_are_monotone():
    ph = ttel.StepPhases(profile=True, annotate=True)
    for name in ttel.PHASES:
        with ph.phase(name, block=lambda: torch.ones(2)):
            torch.ones(64).sum()
    bounds = [ph.last_bounds[n] for n in ttel.PHASES]
    flat = [t for b in bounds for t in b]
    assert flat == sorted(flat)
    assert all(ph.last[n] >= 0 for n in ttel.PHASES)
    snap = ttelem.default_registry().snapshot()
    for name in ttel.PHASES:
        assert snap[f"hist/train/phase/{name}_ms"]["count"] == 1
    ttel.install_hooks()
    ttel.install_hooks()        # idempotent, and arms no counter
    assert ttel.PHASES == ("data_wait", "host_gather", "device_step",
                           "write_back")


def test_registry_survives_a_reimport_of_the_package():
    import hyperspace_torch.telemetry as T

    ttelem.inc("test/reimport", 3)
    T2 = importlib.reload(T)
    assert T2.default_registry() is ttelem.default_registry()
    assert T2.default_registry().get("test/reimport") == 3
    assert ttelem.default_registry().get("test/reimport") == 3


def test_benchmark_step_and_cost_match_jax():
    keys = set(jprof.benchmark_step(lambda: jnp.ones(3), warmup=0, iters=2))
    got = tprof.benchmark_step(lambda: torch.ones(3), warmup=0, iters=2)
    assert set(got) == keys and got["iters"] == 2
    a = torch.ones(8, 16)
    b = torch.ones(16, 4)
    want = jprof.compiled_cost(lambda x, y: x @ y, jnp.ones((8, 16)),
                               jnp.ones((16, 4)))
    got = tprof.compiled_cost(lambda x, y: x @ y, a, b)
    assert got == {"flops": 2 * 8 * 16 * 4}
    if "flops" in want:
        assert want["flops"] == got["flops"]
    assert "bytes accessed" not in got


def test_nan_checks_raise_in_the_backward():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"):
        with tdebug.nan_checks():
            (torch.sqrt(x - 2.0) * 0.0).sum().backward()
    with tdebug.nan_checks(False):
        (torch.sqrt(x - 2.0) * 0.0).sum().backward()
    assert math.isnan(float(x.grad[0]))
    tdebug.assert_replicas_match(torch.ones(2))


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "prof")):
        torch.ones(32).cumsum(0)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert "traceEvents" in events


def test_run_manifest_of_a_duck_typed_run():
    @dataclasses.dataclass
    class Run:
        steps: int = 3
        device: str = "cpu"

    man = TL.run_manifest(Run())
    assert man["config"] == {"steps": 3, "device": "cpu"}
    assert man["version"]

"""The port's degradation ladder and fault registry.

``HysteresisLadder`` and ``parse_chaos`` are held to the JAX package's on
the same inputs, exactly.  The fault streams are held to their contract
only: JAX seeds ``random.Random`` with a tuple, which Python 3.12
refuses, so JAX's ``install`` raises here and cannot serve as an oracle
(``test_jax_install_refuses_on_this_python`` records that).  The port
seeds each stream with an int derived from (seed, site, kind)."""

import random
import sys
import time

import numpy as np
import pytest

from hyperspace_tpu.resilience import degrade as jdeg
from hyperspace_tpu.resilience import faults as jfaults
from hyperspace_torch.resilience import degrade as tdeg
from hyperspace_torch.resilience import faults
from hyperspace_torch.telemetry import registry as telem


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _run_ladder(mod, levels, readings, **kw) -> tuple:
    changes = []
    lad = mod.HysteresisLadder(levels, on_change=lambda o, n:
                               changes.append((o, n)), **kw)
    return [lad.observe(p) for p in readings], changes, lad.level


LADDER_CASES = [
    dict(levels=1),
    dict(levels=3),
    dict(levels=5, high=0.6, low=0.1),
    dict(levels=4, down_after=3, up_after=2),
    dict(levels=6, high=1.0, low=0.0, down_after=2, up_after=5),
]


@pytest.mark.parametrize("case", range(len(LADDER_CASES)))
@pytest.mark.parametrize("seed", [0, 1])
def test_ladder_transitions_equal_jax(case, seed):
    kw = dict(LADDER_CASES[case])
    levels = kw.pop("levels")
    rng = np.random.default_rng([seed, case])
    # bursts of overload, calm and mid readings, with the watermarks
    # themselves in the mix
    readings = []
    for _ in range(40):
        v = rng.choice([0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0,
                        float(rng.random())])
        readings += [float(v)] * int(rng.integers(1, 10))
    got = _run_ladder(tdeg, levels, readings, **kw)
    want = _run_ladder(jdeg, levels, readings, **kw)
    assert got == want
    assert any(o < n for o, n in got[1]) or levels == 1


@pytest.mark.parametrize("kw", [dict(levels=0), dict(levels=2, high=0.2,
                                                     low=0.5),
                                dict(levels=2, down_after=0)])
def test_ladder_rejects_bad_knobs_as_jax(kw):
    for mod in (tdeg, jdeg):
        with pytest.raises(ValueError):
            mod.HysteresisLadder(**kw)


CHAOS = [
    "serve.dispatch:latency:ms=50:times=3",
    "ckpt.save:ioerror:times=2",
    "train.step_nan:nan:after=4",
    "data.next_batch:ioerror:prob=0.05",
    "serve.dispatch:latency:ms=5:prob=0.5, serve.dispatch:ioerror:prob=0.3",
    " ckpt.save : crash_staged : times = 0 ,",
    "serve.dispatch:ioerror:after=2:times=1:ms=0",
]
BAD_CHAOS = ["", ",", "serve.dispatch", "x:bogus", "x:latency:ms",
             "x:latency:speed=3", "x:latency:times=-1", "x:latency:prob=2",
             "x:latency:times=a"]


def _spec_tuple(s) -> tuple:
    return (s.site, s.kind, s.times, s.after, s.ms, s.prob)


@pytest.mark.parametrize("text", CHAOS)
def test_parse_chaos_equals_jax(text):
    got = [_spec_tuple(s) for s in faults.parse_chaos(text)]
    want = [_spec_tuple(s) for s in jfaults.parse_chaos(text)]
    assert got == want


@pytest.mark.parametrize("text", BAD_CHAOS)
def test_parse_chaos_errors_equal_jax(text):
    with pytest.raises(ValueError) as te:
        faults.parse_chaos(text)
    with pytest.raises(ValueError) as je:
        jfaults.parse_chaos(text)
    assert str(te.value) == str(je.value)


def test_jax_install_refuses_on_this_python():
    """Why JAX is no oracle for the streams: its tuple seed raises on
    Python 3.12 (the port's int seed does not)."""
    spec = jfaults.FaultSpec(site="serve.dispatch", kind="latency", ms=1.0)
    if sys.version_info >= (3, 11):
        with pytest.raises(TypeError):
            jfaults.install([spec])
    jfaults.clear()
    faults.install([faults.FaultSpec(site="serve.dispatch", kind="latency",
                                     ms=1.0)])
    assert faults.active()


def _fires(specs, seed: int, calls: int = 400) -> list:
    faults.install(specs, seed=seed)
    out = []
    for _ in range(calls):
        s = faults.due("serve.dispatch")
        out.append(None if s is None else s.kind)
    stats = faults.stats()
    faults.clear()
    return out, stats


def test_fault_streams_reproducible_and_independent(capfd):
    lat = faults.FaultSpec(site="serve.dispatch", kind="latency", ms=0.0,
                           prob=0.5)
    err = faults.FaultSpec(site="serve.dispatch", kind="ioerror", prob=0.5)
    a, sa = _fires([lat], seed=7)
    b, _ = _fires([lat], seed=7)
    c, _ = _fires([lat], seed=8)
    assert a == b                       # reproducible per seed
    assert a != c                       # the seed matters
    assert sa["specs"][0]["calls"] == 400
    assert 120 < sa["fired"] < 280      # Bernoulli(0.5) over 400 calls
    # the stream is random.Random(stream_seed(seed, site, kind))
    rng = random.Random(faults.stream_seed(7, "serve.dispatch", "latency"))
    assert a == ["latency" if rng.random() < 0.5 else None
                 for _ in range(400)]
    # two specs on one site draw independent streams: the ioerror spec
    # alone fires on another pattern than the latency spec alone
    e, _ = _fires([err], seed=7)
    fired_l = [x is not None for x in a]
    fired_e = [x is not None for x in e]
    assert fired_l != fired_e
    assert faults.stream_seed(7, "serve.dispatch", "latency") != \
        faults.stream_seed(7, "serve.dispatch", "ioerror")
    assert faults.stream_seed(7, "serve.dispatch", "latency") != \
        faults.stream_seed(7, "ckpt.save", "latency")
    assert "[faults] fired" in capfd.readouterr().err


def test_fault_window_schedule_and_counters():
    reg = telem.default_registry()
    base = reg.mark()
    faults.install(faults.parse_chaos(
        "serve.dispatch:ioerror:after=2:times=2"))
    got = []
    for _ in range(6):
        try:
            faults.hit("serve.dispatch")
            got.append("ok")
        except faults.InjectedIOError:
            got.append("io")
    assert got == ["ok", "ok", "io", "io", "ok", "ok"]
    assert faults.due("other.site") is None
    snap = reg.snapshot(baseline=base)
    assert snap["fault/armed"] == 1 and snap["fault/fired"] == 2
    faults.install(faults.parse_chaos("serve.dispatch:latency:ms=30"))
    t0 = time.perf_counter()
    faults.hit("serve.dispatch")
    assert time.perf_counter() - t0 >= 0.03
    faults.install(faults.parse_chaos("train.step_nan:nan:times=0"))
    assert faults.poison("train.step_nan") and faults.poison("train.step_nan")
    faults.install(faults.parse_chaos("ckpt.save:crash_staged"))
    with pytest.raises(faults.InjectedCrash):
        faults.hit("ckpt.save")
    faults.install([])
    assert not faults.active() and faults.stats() == {}
    assert not faults.install_chaos(None)
    assert faults.install_chaos("serve.dispatch:latency:ms=1", seed=3)
    with pytest.raises(TypeError):
        faults.install(["serve.dispatch:latency"])

"""The port's telemetry modules against the JAX package's on the same
inputs: histograms (buckets, counts, quantiles, merge, since) and the
registry (``mark``/``snapshot`` deltas, threads included) exactly, the
SLO window on a fake clock exactly, the Prometheus text byte for byte,
and span trees and Chrome ``trace_events`` by structure (times aside).
No device work: everything here is host Python."""

import json
import threading

import numpy as np
import pytest

from hyperspace_tpu.telemetry import exposition as jexpo
from hyperspace_tpu.telemetry import histogram as jhist
from hyperspace_tpu.telemetry import registry as jreg
from hyperspace_tpu.telemetry import spans as jspans
from hyperspace_tpu.telemetry import trace as jtrace
from hyperspace_tpu.telemetry import window as jwin
from hyperspace_torch.telemetry import exposition as texpo
from hyperspace_torch.telemetry import histogram as thist
from hyperspace_torch.telemetry import registry as treg
from hyperspace_torch.telemetry import spans as tspans
from hyperspace_torch.telemetry import trace as ttrace
from hyperspace_torch.telemetry import window as twin

QS = (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)


def _values(seed: int, n: int = 2000) -> list:
    """Log-normal latencies in ms plus the edges: zero, negative, below
    ``lo``, at and past ``hi``, a bucket boundary and a NaN."""
    rng = np.random.default_rng(seed)
    v = np.exp(rng.normal(0.0, 2.5, n)).tolist()
    return v + [0.0, -3.0, 1e-4, 1e-3, 1.1 ** 7 * 1e-3, 1e5, 3e7,
                float("nan")]


def _snap_tuple(s) -> tuple:
    return (s.counts, s.count, s.sum, s.vmin, s.vmax, s.lo, s.hi, s.growth)


def _pair(values, **kw):
    j, t = jhist.Histogram(**kw), thist.Histogram(**kw)
    for x in values:
        j.observe(x)
        t.observe(x)
    return j.snapshot(), t.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scheme", [{}, dict(lo=0.5, hi=50.0, growth=1.3)])
def test_histogram_buckets_counts_quantiles_exact(seed, scheme):
    js, ts = _pair(_values(seed), **scheme)
    assert _snap_tuple(ts) == _snap_tuple(js)
    for q in QS:
        assert ts.quantile(q) == js.quantile(q)
    assert ts.fields() == js.fields()
    assert ts.fields((0.5, 0.999)) == js.fields((0.5, 0.999))


def test_histogram_empty_merge_and_since_exact():
    je, te = jhist.Histogram().snapshot(), thist.Histogram().snapshot()
    assert te.fields() == je.fields() and te.quantile(0.5) is None
    ja, ta = _pair(_values(3, 500))
    jb, tb = _pair(_values(4, 700))
    assert _snap_tuple(ta.merge(tb)) == _snap_tuple(ja.merge(jb))
    # a baseline taken part-way: the delta distribution and its extremes
    vals = _values(5, 800)
    j, t = jhist.Histogram(), thist.Histogram()
    for x in vals[:300]:
        j.observe(x)
        t.observe(x)
    jb0, tb0 = j.snapshot(), t.snapshot()
    for x in vals[300:]:
        j.observe(x)
        t.observe(x)
    jd, td = j.snapshot().since(jb0), t.snapshot().since(tb0)
    assert _snap_tuple(td) == _snap_tuple(jd)
    assert td.fields() == jd.fields()
    # a stale baseline (after a reset) degrades to zeros in both
    j.reset()
    t.reset()
    assert (_snap_tuple(t.snapshot().since(tb0))
            == _snap_tuple(j.snapshot().since(jb0)))
    with pytest.raises(ValueError):
        ta.merge(thist.Histogram(growth=1.2).snapshot())


def _ops(reg) -> list:
    """One operation sequence with marks between; returns every
    snapshot taken (baselined and not)."""
    out = []
    reg.inc("serve/requests")
    reg.inc("serve/cache_hit", 3)
    reg.inc("ckpt/save_s", 0.25)
    reg.set_gauge("serve/degrade_level", 2)
    for x in (1.0, 2.5, 40.0, 0.002):
        reg.observe("serve/e2e_ms", x)
    m1 = reg.mark()
    out.append(reg.snapshot())
    reg.inc("serve/requests", 2)
    reg.set_gauge("serve/cache_hit_rate", 0.5)
    reg.observe("serve/e2e_ms", 7.0)
    reg.observe("serve/dispatch_ms", 3.0)
    out.append(reg.snapshot("ctr/", baseline=m1))
    m2 = reg.mark()
    out.append(reg.snapshot(baseline=m2))      # nothing since: empty hists
    reg.inc("serve/shed")
    out.append(reg.snapshot("ctr/", baseline=m2))
    out.append(reg.get("serve/requests"))
    out.append(reg.get("never/touched"))
    c, g, h = reg.export(hist_names=("serve/e2e_ms",))
    out.append((c, g, {k: _snap_tuple(v) for k, v in h.items()}))
    reg.reset()
    out.append(reg.snapshot())
    return out


def test_registry_mark_snapshot_deltas_exact():
    assert _ops(treg.Registry()) == _ops(jreg.Registry())


@pytest.mark.parametrize("threads", [2, 8])
def test_registry_threads_give_the_same_totals(threads):
    """Concurrent inc/observe/set_gauge from many threads: the totals
    (integer-valued, so any summation order is exact) and every delta
    against a mark taken before the threads match JAX's."""
    def drive(reg) -> dict:
        reg.inc("serve/requests", 5)
        base = reg.mark()
        barrier = threading.Barrier(threads)

        def work(i):
            barrier.wait()
            for j in range(300):
                reg.inc("serve/requests")
                reg.inc("serve/slots", 8)
                reg.observe("serve/e2e_ms", float(1 + (i * 300 + j) % 97))
            reg.set_gauge(f"serve/gauge_{i}", i)

        ts = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return {"full": reg.snapshot(), "delta": reg.snapshot(baseline=base)}

    got, want = drive(treg.Registry()), drive(jreg.Registry())
    assert got == want
    assert got["delta"]["serve/requests"] == 300 * threads
    assert got["delta"]["hist/serve/e2e_ms"]["count"] == 300 * threads


def _window_script(win_mod, reg_mod) -> list:
    """One SloWindow session on a fake clock (seconds from 1000)."""
    reg = reg_mod.Registry()
    w = win_mod.SloWindow(10.0, slots=5, registry=reg, now=1000.0)
    out = [w.report(now=1000.0)]
    rng = np.random.default_rng(7)
    t = 1000.0
    for step in range(60):
        t += 0.5
        for _ in range(int(rng.integers(1, 6))):
            reg.inc("serve/requests")
            reg.observe("serve/e2e_ms", float(np.exp(rng.normal(1.0, 1.0))))
        if step % 7 == 0:
            reg.inc("serve/shed", 2)
        if step % 11 == 0:
            reg.inc("serve/deadline_exceeded")
            reg.inc("serve/errors")
        w.tick(now=t)
        if step % 9 == 0:
            out.append(w.report(now=t))
            out.append(w.latency_pressure(5.0, now=t))
            out.append(w.latency_pressure(0.0, now=t))
    out.append(w.report(now=t + 30.0))   # everything aged out
    return out


def test_slo_window_on_a_fake_clock_exact():
    assert _window_script(twin, treg) == _window_script(jwin, jreg)
    with pytest.raises(ValueError):
        twin.SloWindow(0.0)
    with pytest.raises(ValueError):
        twin.SloWindow(5.0, slots=1)


def _fill_for_exposition(reg) -> None:
    reg.inc("serve/requests", 12)
    reg.inc("serve/cache_hit", 2.5)
    reg.inc("serve/requests@tenant=en", 4)
    reg.inc("serve/requests@tenant=de", 8)
    reg.inc("fault/fired")
    reg.set_gauge("serve/degrade_level", 1)
    reg.set_gauge("serve/cache_hit_rate", 0.3333)
    reg.set_gauge("weird name-with.runes", float("nan"))
    reg.set_gauge("serve/inf", float("inf"))
    for x in _values(11, 300):
        reg.observe("serve/e2e_ms", x)
    for x in (0.5, 0.51, 90.0):
        reg.observe("serve/e2e_ms@tenant=en", x)


@pytest.mark.parametrize("labels", [None, {"job": 'a"b\\c\nd'},
                                    {"process_index": "3"}])
def test_prometheus_text_byte_identical(labels):
    jr, tr = jreg.Registry(), treg.Registry()
    _fill_for_exposition(jr)
    _fill_for_exposition(tr)
    want = jexpo.render_prometheus(jr, labels=labels)
    got = texpo.render_prometheus(tr, labels=labels)
    assert got == want
    assert texpo.render_export(*tr.export()) == jexpo.render_export(
        *jr.export())


def test_exposition_helpers_and_file_writer(tmp_path):
    for name in ("serve/e2e_ms", "a.b-c d", "9lives", "x@tenant=en"):
        assert texpo.sanitize_name(name) == jexpo.sanitize_name(name)
        assert texpo.split_tenant(name) == jexpo.split_tenant(name)
    assert texpo.tenant_metric("serve/shed", "en") == jexpo.tenant_metric(
        "serve/shed", "en")
    assert texpo.tenant_metric("serve/shed", None) == "serve/shed"
    for s in ('a\\b\n"c"', "plain"):
        assert texpo.escape_help(s) == jexpo.escape_help(s)
        assert texpo.escape_label_value(s) == jexpo.escape_label_value(s)
    tr, jr = treg.Registry(), jreg.Registry()
    _fill_for_exposition(tr)
    _fill_for_exposition(jr)
    tw = texpo.MetricsFileWriter(str(tmp_path / "t.prom"), 30.0, registry=tr)
    jw = jexpo.MetricsFileWriter(str(tmp_path / "j.prom"), 30.0, registry=jr)
    assert tw.maybe_write() and jw.maybe_write()
    assert not tw.maybe_write()                 # inside the cadence
    assert ((tmp_path / "t.prom").read_text()
            == (tmp_path / "j.prom").read_text())
    with pytest.raises(ValueError):
        texpo.MetricsFileWriter(str(tmp_path / "x.prom"), 0.0)


def _strip_times(d: dict) -> dict:
    out = {k: v for k, v in d.items() if k not in ("t_off_ms", "dur_ms")}
    if "children" in out:
        out["children"] = [_strip_times(c) for c in out["children"]]
    return out


def _span_tree(sp) -> dict:
    """A request envelope, a lifecycle root adopted into it, nested
    stages with a metric, a hand-stamped child, and a shared flush span
    adopted into two trees and scoped on another thread."""
    sp.enable()
    try:
        with sp.request("topk", "rid-1") as env:
            life = sp.root("topk", "rid-1", meta={"k": 4})
            with sp.use(life):
                with sp.stage("validate"):
                    with sp.stage("inner", meta={"n": 2}):
                        pass
            flush = sp.Span("flush", meta={"flush_id": 1, "members": 2})
            life.adopt(flush)
            other = sp.Span("topk", "rid-2")
            other.adopt(flush)

            def dispatch():
                with sp.use(flush):
                    with sp.stage("device_compute",
                                  metric="serve/stage/device_compute_ms"):
                        pass

            t = threading.Thread(target=dispatch)
            t.start()
            t.join()
            flush.close()
            life.add("serialize", life.t0, life.t0 + 1e-3)
            life.close()
        assert sp.stage("outside") is sp._NULL          # no scope
    finally:
        sp.disable()
    assert sp.root("x") is None and sp.stage("y") is sp._NULL
    return {"env": _strip_times(env.to_dict()),
            "other": _strip_times(other.to_dict())}


def test_span_trees_have_jax_structure():
    jr = jreg.default_registry()
    tr = treg.default_registry()
    jbase, tbase = jr.mark(), tr.mark()
    want = _span_tree(jspans)
    got = _span_tree(tspans)
    assert got == want
    # the stage's metric lands in the registry histogram in both
    for reg, base in ((jr, jbase), (tr, tbase)):
        snap = reg.snapshot(baseline=base)
        assert snap["hist/serve/stage/device_compute_ms"]["count"] == 1


def _trace_events(tr_mod, path) -> dict:
    tracer = tr_mod.Tracer(enabled=True, keep_events=True)
    with tracer.span("query", args={"op": "topk", "buckets": [8]}):
        with tracer.span("dispatch"):
            pass
    tracer.record_span("ckpt_save", 1.0, 1.5, {"step": 3})
    t = threading.Thread(target=lambda: tracer.record_span("worker", 2.0,
                                                           2.25))
    t.start()
    t.join()
    fields = tracer.flush_fields()
    totals = tracer.total_fields()
    n = tracer.dump_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    events = [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid")}
              for e in doc["traceEvents"]]
    # durations of the hand-stamped spans are exact in both
    exact = [e["dur"] for e in doc["traceEvents"]
             if e["name"] in ("ckpt_save", "worker")]
    return {"n": n, "events": events, "exact": exact,
            "fields": sorted(fields), "totals": sorted(totals),
            "unit": doc["displayTimeUnit"],
            "other": sorted(doc["otherData"]),
            "dropped": doc["otherData"]["dropped_events"],
            "again": tracer.dump_chrome_trace(str(path))}


def test_trace_events_have_jax_structure(tmp_path):
    got = _trace_events(ttrace, tmp_path / "t.json")
    want = _trace_events(jtrace, tmp_path / "j.json")
    assert got == want
    assert got["n"] == 4 and got["again"] == 0
    # disabled: the shared null context, nothing recorded
    off = ttrace.Tracer()
    assert off.span("x") is ttrace._NULL


def test_default_tracer_enable_disable_and_cli_session(tmp_path, capsys):
    from hyperspace_torch.telemetry import cli_session

    out = tmp_path / "trace.json"
    with cli_session(False, str(out)):
        assert ttrace.tracing()
        with ttrace.span("query", args={"op": "topk"}):
            pass
    assert not ttrace.tracing()
    doc = json.loads(out.read_text())
    assert [e["name"] for e in doc["traceEvents"]] == ["query"]
    assert "trace events" in capsys.readouterr().out
    with cli_session(False, None):
        assert ttrace.span("x") is ttrace._NULL

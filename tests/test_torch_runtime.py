"""The port's train runtime — ``optim/accum.py``, ``train/logging.py``,
``train/checkpoint.py``, ``telemetry/health.py``, ``train/loop.py``'s
``run_loop`` and ``resume_chunk``, and the CLI's run keys — against the
JAX package on the CPU.

Gradient accumulation is held against ``optax.MultiSteps`` (JAX run
without x64, so both sides are float32 throughout) at rtol 1e-5.  ``run_loop`` runs a toy stepper whose loss is a function of
the step (exact in binary) beside JAX's loop (orbax checkpoints on the
CPU): the JSONL records (``ts``/``host`` left out), the committed
checkpoint steps, the resumed start and ``resume_chunk`` must be equal.
The commit rule is held against JAX's on the same crafted directories.
Last, every CLI workload run N steps straight must equal, bitwise, the
run stopped at N/2 and resumed to N: parameters, optimizer moments and
counts, generator states, printed results and records.  HGCN link
prediction runs under ``torch.use_deterministic_algorithms``: its
decoder's ``z[pairs]`` backward (``index_put_`` with accumulation) sums
in thread order on the CPU, so two straight runs differ without it.
"""

import dataclasses
import io
import json
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperspace_tpu.cli.train import RunConfig as JRun
from hyperspace_tpu.manifolds import PoincareBall as JBall
from hyperspace_tpu.optim.accum import with_grad_accumulation as j_accum
from hyperspace_tpu.optim.radam import riemannian_adam as j_radam
from hyperspace_tpu.telemetry import health as JH
from hyperspace_tpu.train import checkpoint as JC
from hyperspace_tpu.train import loop as JL
from hyperspace_torch.cli import train as tcli
from hyperspace_torch.manifolds import PoincareBall as TBall
from hyperspace_torch.optim.accum import GradAccumulation, MultiStepsState
from hyperspace_torch.optim.accum import with_grad_accumulation as t_accum
from hyperspace_torch.optim.adamw import AdamW
from hyperspace_torch.optim.common import apply_updates
from hyperspace_torch.optim.radam import riemannian_adam as t_radam
from hyperspace_torch.telemetry import health as TH
from hyperspace_torch.train import checkpoint as TC
from hyperspace_torch.train import loop as TL
from hyperspace_torch.train.logging import MetricsLogger, read_jsonl

F32 = dict(rtol=1e-5, atol=1e-7)


# --- gradient accumulation ---------------------------------------------------


def _grads(n, d=5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(d).astype(np.float32) * 0.3,
            rng.standard_normal((n, d)).astype(np.float32))


def test_accum_repeated_grad_is_one_inner_update():
    """JAX's test: MultiSteps(2) fed the same gradient twice is one inner
    update with it, and the middle microstep moves nothing — the
    functional form (``optax.adam``) and the stateful one (AdamW)."""
    p0, (g,) = _grads(1)
    inner = t_radam(1e-2, None)
    opt, st = t_accum(inner, torch.tensor(p0), 2)
    p = torch.tensor(p0)
    up, st = opt.update(torch.tensor(g), st, p)
    p_mid = apply_updates(p, up)
    assert torch.equal(p_mid, p)
    assert int(st.inner_opt_state.count) == 0 and int(st.mini_step) == 1
    up, st = opt.update(torch.tensor(g), st, p_mid)
    p_end = apply_updates(p_mid, up)
    up1, st1 = inner.update(torch.tensor(g), inner.init(p), p)
    assert torch.equal(p_end, apply_updates(p, up1))
    assert int(st.inner_opt_state.count) == 1 and int(st.gradient_step) == 1
    w = torch.tensor(p0)
    acc = GradAccumulation(AdamW({"w": w}, 1e-2, 1e-2), 2)
    acc.step([torch.tensor(g)])
    assert torch.equal(w, torch.tensor(p0)) and acc.inner.count == 0
    acc.step([torch.tensor(g)])
    ref = torch.tensor(p0)
    AdamW({"w": ref}, 1e-2, 1e-2).step([torch.tensor(g)])
    assert torch.equal(w, ref) and acc.inner.count == 1


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("inner", ["adamw", "radam"])
def test_accum_sequence_matches_multisteps(inner, k):
    """2k different microbatch gradients through MultiSteps(k): AdamW
    (``optax.adamw``, the HyboNet optimizer) and Riemannian Adam on the
    ball; parameters, the inner count and the accumulator."""
    p0, gs = _grads(2 * k, seed=k)
    with jax.enable_x64(False):
        jo = (optax.adamw(1e-2, weight_decay=1e-2) if inner == "adamw"
              else j_radam(1e-2, JBall(1.0)))
        jo, js = j_accum(jo, jnp.asarray(p0), k)
        jp = jnp.asarray(p0)
        for g in gs:
            up, js = jo.update(jnp.asarray(g), js, jp)
            jp = optax.apply_updates(jp, up)
        jp = np.asarray(jp)
    if inner == "adamw":
        w = torch.tensor(p0)
        opt, state = t_accum(AdamW({"w": w}, 1e-2, 1e-2), None, k)
        assert state is None
        for g in gs:
            opt.step([torch.tensor(g)])
        np.testing.assert_allclose(w.numpy(), jp, **F32)
        assert opt.inner.count == 2 == int(js.gradient_step)
        return
    opt, state = t_accum(t_radam(1e-2, TBall(1.0)), torch.tensor(p0), k)
    assert isinstance(state, MultiStepsState)
    p = torch.tensor(p0)
    for g in gs:
        up, state = opt.update(torch.tensor(g), state, p)
        p = apply_updates(p, up)
    np.testing.assert_allclose(p.numpy(), jp, **F32)
    assert int(state.inner_opt_state.count) == 2
    assert int(state.gradient_step) == int(js.gradient_step) == 2
    np.testing.assert_array_equal(state.acc_grads.numpy(),
                                  np.asarray(js.acc_grads))


def test_accum_k1_is_the_inner_optimizer():
    inner = t_radam(0.1, None)
    opt, st = t_accum(inner, torch.ones(2), 1)
    assert opt is inner and int(st.count) == 0
    adamw = AdamW({"w": torch.ones(2)}, 0.1, 0.0)
    assert t_accum(adamw, None, 1) == (adamw, None)


# --- logging and health ------------------------------------------------------


def test_metrics_logger_records(tmp_path):
    p = str(tmp_path / "m.jsonl")
    with MetricsLogger(p) as log:
        log.log(1, loss=0.5, ok=True)
        log.log(2, loss=torch.tensor(0.25), roc_auc=0.9)
        log.event("weird", blob=object(), config={"steps": 7})
    with open(p, "a") as f:
        f.write('{"step": 3, "lo')       # a run killed mid-write
    recs = read_jsonl(p)
    assert [r.get("step") for r in recs] == [1, 2, None]
    assert recs[0]["ok"] is True and recs[1]["loss"] == 0.25
    assert all({"ts", "host"} <= set(r) for r in recs)
    assert recs[2]["event"] == "weird" and "object" in recs[2]["blob"]
    assert recs[2]["config"] == {"steps": 7}


def _rim_table(dtype=np.float32):
    x = np.full((6, 3), 0.05, dtype)
    x[2] = [0.99999, 0.0, 0.0]
    return x


@pytest.mark.parametrize("rim", [False, True], ids=["healthy", "rim"])
def test_health_monitor_matches_jax(tmp_path, rim):
    """The ball's stats, the threshold verdicts and the ``health/*``
    record against JAX's on the same table (float32; pushed to the
    rim through ``proj`` it flags)."""
    x = _rim_table() if rim else np.full((6, 3), 0.05, np.float32)
    with jax.enable_x64(False):
        jx = JBall(1.0).proj(jnp.asarray(x))
        jpath = str(tmp_path / "j.jsonl")
        from hyperspace_tpu.train.logging import MetricsLogger as JLog

        with JLog(jpath) as log:
            jvals = JH.HealthMonitor(JH.make_health_fn(JBall(1.0))).check(
                jx, step=8, log=log)
    tx = TBall(1.0).proj(torch.as_tensor(x))
    tpath = str(tmp_path / "t.jsonl")
    mon = TH.HealthMonitor(TH.make_health_fn(TBall(1.0)))
    with MetricsLogger(tpath) as log:
        tvals = mon.check(tx, step=8, log=log)
    assert sorted(tvals) == sorted(jvals)
    for k in jvals:
        assert tvals[k] == pytest.approx(jvals[k], rel=1e-5, abs=1e-7), k
    assert mon.problems(tvals) == JH.HealthMonitor(None).problems(jvals)
    assert bool(mon.problems(tvals)) == rim
    (jrec,), (trec,) = read_jsonl(jpath), read_jsonl(tpath)
    assert sorted(trec) == sorted(jrec)
    assert trec["health/ok"] is jrec["health/ok"] is (not rim)
    if rim:
        with pytest.raises(FloatingPointError, match="boundary_margin_min"):
            TH.HealthMonitor(TH.make_health_fn(TBall(1.0)),
                             abort=True).check(tx, step=9)


def test_health_stats_tag_tree_and_grads_match_jax():
    rng = np.random.default_rng(2)
    params = {"emb": (rng.standard_normal((5, 3)) * 0.2),
              "w": rng.standard_normal((3, 2))}
    params["w"][0, 0] = np.nan
    grads = {"emb": rng.standard_normal((5, 3)), "w": np.ones((3, 2))}
    with jax.enable_x64(True):
        want = JH.health_stats(
            {k: jnp.asarray(v) for k, v in params.items()},
            {"emb": JBall(1.0), "w": None},
            grads={k: jnp.asarray(v) for k, v in grads.items()},
            grads_name="mu_norm")
    got = TH.health_stats({k: torch.as_tensor(v) for k, v in params.items()},
                          {"emb": TBall(1.0), "w": None},
                          grads={k: torch.as_tensor(v)
                                 for k, v in grads.items()},
                          grads_name="mu_norm")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-6, equal_nan=True, err_msg=k)


# --- checkpoints -------------------------------------------------------------


def _craft(root):
    """Committed 3, an empty 5, a staging-marked 7, a staging dir."""
    for name, entries in (("3", ["state.pt"]), ("5", []),
                          ("7", ["tmp.orbax-checkpoint-tmp-0"]),
                          ("9.orbax-checkpoint-tmp-1", ["x"])):
        d = root / name
        d.mkdir(parents=True)
        for e in entries:
            (d / e).mkdir() if "tmp" in e else (d / e).write_text("")


def test_commit_rule_matches_jax(tmp_path):
    _craft(tmp_path)
    for name in ("3", "5", "7", "9.orbax-checkpoint-tmp-1", "11"):
        path = str(tmp_path / name)
        assert TC._step_dir_committed(path) == JC._step_dir_committed(path)
    assert TC._latest_committed_step(str(tmp_path)) == \
        JC._latest_committed_step(str(tmp_path)) == 3
    assert TC.peek_latest_step(str(tmp_path)) == \
        JC.peek_latest_step(str(tmp_path)) == 3
    assert TL.resume_chunk(str(tmp_path), True, 2) == \
        JL.resume_chunk(str(tmp_path), True, 2) == 2
    # the port's own staging debris, and the orphans cleaned at init
    (tmp_path / "13").mkdir()
    (tmp_path / "13" / "state.pt.checkpoint-tmp-4").write_text("")
    assert not TC._step_dir_committed(str(tmp_path / "13"))
    TC.CheckpointManager(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["3"]


def test_save_restore_in_place_and_retention(tmp_path):
    """Interval gate and retention as orbax's (first save, multiples,
    max_to_keep), a restore copied into the live tensors and generator,
    and a mismatched structure refused."""
    gen = torch.Generator().manual_seed(3)
    table = torch.zeros(4, 2)
    state = {"table": table, "gen": gen, "step": 0}
    with TC.CheckpointManager(str(tmp_path / "t"), max_to_keep=2,
                              save_interval_steps=5) as ck:
        saved = [s for s in range(12)
                 if ck.save(s, {**state, "step": s,
                                "table": table + s})]
        assert ck.latest_step() == 10
    with JC.CheckpointManager(str(tmp_path / "j"), async_save=False,
                              max_to_keep=2, save_interval_steps=5) as jk:
        jsaved = [s for s in range(12)
                  if jk.save(s, {"x": jnp.asarray(s)})]
        jk.wait()
    assert saved == jsaved == [0, 5, 10]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        d for d in os.listdir(tmp_path / "j") if d.isdigit()) == ["10", "5"]
    want_draw = torch.rand(3, generator=gen)
    live = {"table": torch.ones(4, 2), "gen": torch.Generator(),
            "step": -1}
    ptr = live["table"].data_ptr()
    out, step = TC.CheckpointManager(str(tmp_path / "t")).restore(live)
    assert step == 10 and out["step"] == 10
    assert out["table"].data_ptr() == ptr and torch.all(out["table"] == 10)
    assert torch.equal(torch.rand(3, generator=out["gen"]), want_draw)
    with pytest.raises(ValueError, match="shape"):
        TC.CheckpointManager(str(tmp_path / "t")).restore(
            {**live, "table": torch.ones(3, 2)})
    with pytest.raises(ValueError, match="keys"):
        TC.CheckpointManager(str(tmp_path / "t")).restore({"table": table})


def test_save_retries_are_bounded(tmp_path, monkeypatch):
    real = TC.CheckpointManager._write
    fails = {"n": 2}

    def flaky(self, step, tree):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("injected")
        real(self, step, tree)

    monkeypatch.setattr(TC.CheckpointManager, "_write", flaky)
    ck = TC.CheckpointManager(str(tmp_path), retry_backoff_s=0.0)
    assert ck.save(1, {"x": torch.ones(1)}) and fails["n"] == 0
    fails["n"] = 3                   # beyond save_retries=2
    with pytest.raises(OSError, match="injected"):
        ck.save(2, {"x": torch.ones(1)}, force=True)
    assert TC.peek_latest_step(str(tmp_path)) == 1


def test_restore_params_only(tmp_path):
    from hyperspace_torch.models import product_embed as pme

    cfg = pme.ProductEmbedConfig(num_nodes=6)
    state, _ = pme.init_state(cfg, 0, device="cpu")
    ck = TC.CheckpointManager(str(tmp_path))
    ck.save(4, state)
    (tmp_path / "9").mkdir()          # an interrupted save
    tree, step = TC.restore_params_only(str(tmp_path))
    assert step == 4
    assert torch.equal(tree["params"]["table"], state.params.table)
    assert torch.equal(tree["params"]["c_raw"], state.params.c_raw)
    assert sorted(tree["curv_opt_state"]) == ["count", "mu", "nu"]
    assert tree["generator"].dtype == torch.uint8
    with pytest.raises(FileNotFoundError, match="uncommitted"):
        TC.restore_params_only(str(tmp_path), step=9)
    with pytest.raises(FileNotFoundError):
        TC.restore_params_only(str(tmp_path / "none"))


def test_restore_reprojects():
    """JAX's ``test_checkpoint_restore_reprojects``: a ball leaf past the
    boundary is clamped inside, a Euclidean leaf passes; and
    ``reproject_rows`` leaves on-manifold rows bitwise alone, projecting
    the rows that drifted off the sphere."""
    from hyperspace_torch.manifolds import Sphere

    params = {"emb": torch.tensor([[0.999999, 0.0], [0.1, 0.2]]),
              "dense": torch.ones(2, 2)}
    project = TC.reproject_params({"emb": TBall(1.0), "dense": None})
    out = project(params)
    assert float(torch.linalg.norm(out["emb"][0])) < 1.0
    assert torch.equal(out["emb"][1], params["emb"][1])
    assert torch.equal(out["dense"], params["dense"])
    sphere = Sphere(1.3)
    x = sphere.proj(torch.randn(6, 4, generator=torch.Generator()
                                .manual_seed(0)))
    x[2] *= 1.01                                    # off the sphere
    y = TC.reproject_rows(sphere, x)
    keep = torch.arange(6) != 2
    assert torch.equal(y[keep], x[keep])
    assert float(sphere.check_point(y[2:3])) < 1e-6
    assert not torch.equal(sphere.proj(x)[keep], x[keep])   # why rows


# --- run_loop against JAX's --------------------------------------------------


def _toy(jax_side: bool, k: int):
    """A stepper whose state is (x, step) and whose loss is step / 8."""
    if jax_side:
        def step(st):
            n = st["step"] + 1
            return ({"x": st["x"] * 0.5 + 1.0, "step": n},
                    n.astype(jnp.float32) / 8.0)

        state = {"x": jnp.zeros(3, jnp.float32),
                 "step": jnp.zeros((), jnp.int32)}
        return state, JL.make_chunked_stepper(step, k)

    def step(st):
        n = st["step"] + 1
        return {"x": st["x"] * 0.5 + 1.0, "step": n}, n.to(
            torch.float32) / 8.0

    state = {"x": torch.zeros(3, dtype=torch.float64),
             "step": torch.zeros((), dtype=torch.int64)}
    return state, TL.make_chunked_stepper(step, k)


def _recs(path):
    return [{k: v for k, v in r.items() if k not in ("ts", "host")}
            for r in read_jsonl(path)]


def _both(tmp, name, k, **kw):
    """The same run through both loops: (records, committed steps, final
    step, loss) each."""
    out = []
    for side, Run in (("j", JRun), ("t", tcli.RunConfig)):
        d = tmp / f"{name}-{side}"
        run = Run(log=str(d) + ".jsonl", ckpt_dir=str(d), **kw)
        with jax.enable_x64(False):
            state, stepper = _toy(side == "j", k)
            state, loss = (JL if side == "j" else TL).run_loop(
                run, state, stepper, steps_per_call=k)
        steps = sorted(int(s) for s in os.listdir(d) if s.isdigit())
        out.append((_recs(str(d) + ".jsonl"), steps, int(state["step"]),
                    float(loss)))
    return out


@pytest.mark.parametrize("steps,eval_every,ckpt_every,k", [
    (10, 3, 4, 1), (10, 3, 4, 4), (16, 5, 3, 4), (7, 0, 0, 2)])
def test_run_loop_records_and_saves_match_jax(tmp_path, steps, eval_every,
                                              ckpt_every, k):
    """Boundary-crossing records with the chunk statistics and the
    closing record, interval saves forced on a crossed boundary and the
    forced final save; then the run stopped at half and resumed."""
    kw = dict(steps=steps, eval_every=eval_every, ckpt_every=ckpt_every)
    (jr, js, jn, jl), (tr, ts, tn, tl) = _both(tmp_path, "a", k, **kw)
    assert tr == jr and ts == js and tn == jn and tl == jl
    half = dict(kw, steps=steps // 2)
    _both(tmp_path, "b", k, **half)
    (jr, js, jn, _), (tr, ts, tn, _) = _both(tmp_path, "b", k, resume=True,
                                             **kw)
    assert tr == jr and ts == js and tn == jn
    for side in "jt":
        assert TC.peek_latest_step(str(tmp_path / f"b-{side}")) == jn
    assert TL.resume_chunk(str(tmp_path / "b-t"), True, 3) == \
        JL.resume_chunk(str(tmp_path / "b-j"), True, 3)


# --- the CLI -----------------------------------------------------------------


NOT_PORTED_VALUES = {
    "telemetry": "1", "trace_out": "t.json", "metrics_out": "m.prom",
    "metrics_every": "5", "profile_steps": "2", "chaos": "ckpt.save:ioerror",
    "chaos_seed": "1", "rollback": "1", "rollback_lr_backoff": "0.25",
    "tp": "4", "hot_rows": "8", "host_chunk_steps": "4",
    "host_gather_ahead": "1", "compile_cache_dir": "cache",
    "coordinator": "10.0.0.1:1", "num_processes": "2", "process_id": "1",
    "multihost": "true"}


@pytest.mark.parametrize("key", sorted(NOT_PORTED_VALUES))
def test_cli_keys_not_ported_exit_with_their_name(key):
    assert set(NOT_PORTED_VALUES) - {"multihost"} == set(tcli.NOT_PORTED)
    with pytest.raises(SystemExit, match=f"{key}=.*not ported"):
        tcli.main(["poincare", "device=cpu", "steps=1",
                   f"{key}={NOT_PORTED_VALUES[key]}"])


def test_cli_run_keys_are_jax_keys():
    """Every JAX run key is a port run key with JAX's default (the port
    adds ``device``)."""
    jdef, tdef = JRun(), tcli.RunConfig()
    for f in dataclasses.fields(JRun):
        assert getattr(tdef, f.name) == getattr(jdef, f.name), f.name
    assert {f.name for f in dataclasses.fields(tcli.RunConfig)} - {
        f.name for f in dataclasses.fields(JRun)} == {"device"}


def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tcli.main(argv) == 0
    return json.loads(buf.getvalue().splitlines()[-1])


@pytest.mark.parametrize("argv,count", [
    (["hybonet", "steps=4", "dim=16", "num_layers=1", "num_heads=2",
      "batch_size=8"], ("opt", "inner", "count")),
    (["hvae", "steps=4", "hidden=32", "conv_features=8,16", "latent_dim=2",
      "batch_size=8", "scan_chunk=2"],
     ("opt_state", "inner_opt_state", "count"))], ids=["hybonet", "hvae"])
def test_cli_accum_runs(tmp_path, argv, count):
    """JAX's ``test_cli_hybonet_accum_runs``, and the HVAE's: losses
    finite, the inner optimizer stepped once a pair of microsteps."""
    res = _cli(argv + ["accum=2", "device=cpu", f"ckpt_dir={tmp_path}"])
    assert res["workload"] == argv[0] and np.isfinite(res["loss"])
    tree, step = TC.restore_params_only(str(tmp_path))
    node = tree[count[0]]
    for key in count[1:]:
        node = node[key]
    assert step == 4 and int(node) == 2


RESUME = {
    "poincare": ["poincare", "dim=4", "batch_size=32", "scan_chunk=4"],
    "hvae": ["hvae", "hidden=32", "conv_features=8,16", "latent_dim=2",
             "batch_size=8", "scan_chunk=2"],
    "product": ["product", "batch_size=32", "scan_chunk=4"],
    "hybonet": ["hybonet", "dim=16", "num_heads=2", "num_layers=1",
                "batch_size=16"],
    "hybonet-accum": ["hybonet", "dim=16", "num_heads=2", "num_layers=1",
                      "batch_size=16", "accum=2"],
    "hgcn-lp": ["hgcn", "hidden_dims=[16, 8]"],
    "hgcn-nc": ["hgcn", "hidden_dims=[16, 8]", "task=nc"],
}


def _equal_trees(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("name", sorted(RESUME))
def test_cli_resume_equals_the_straight_run(tmp_path, name, deterministic):
    """N = 8 steps straight, against 4 with ``ckpt_dir`` and a resume to
    8: the final checkpoints (every value a step changes), the printed
    results and the records after step 4, bitwise."""
    base = RESUME[name] + ["device=cpu", "ckpt_every=2", "eval_every=1"]

    def run(tag, steps, *extra):
        out = _cli(base + [f"steps={steps}", f"ckpt_dir={tmp_path / tag}",
                           f"log={tmp_path / tag}.jsonl", *extra])
        out.pop("seconds", None)
        return out

    straight = run("a", 8)
    run("b", 4)
    resumed = run("b", 8, "resume=true")
    assert resumed == straight
    ta, sa = TC.restore_params_only(str(tmp_path / "a"))
    tb, sb = TC.restore_params_only(str(tmp_path / "b"))
    assert sa == sb == 8
    _equal_trees(tb, ta)
    assert sorted(os.listdir(tmp_path / "a")) == sorted(
        os.listdir(tmp_path / "b"))
    ra, rb = _recs(f"{tmp_path / 'a'}.jsonl"), _recs(f"{tmp_path / 'b'}.jsonl")
    assert rb == ra

"""The port's Poincaré-embedding trainer (``models/poincare_embed.py``,
``train/loop.py``, ``cli/train.py poincare``) against the JAX package, on
the CPU, on a depth-3 tree at dim 5.

Both packages start from one state (a JAX ``TrainState`` whose table is
spread over the ball, handed to the port by ``state_from_jax``) and take
the same batches: the JAX steps draw theirs from their key, and the test
draws the same ids from the same key for the port's explicit-batch
steps; mining pools likewise; planned paths share ``plan_from_indices``
of numpy batches.  Tables, losses and moments after three steps are held
within rtol 2e-5, atol 1e-6 (float32 in both; JAX's test session runs
x64, so its Adam bias corrections are float64, the port's float32).
Mined ids, plan arrays and ranks must be equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.data.wordnet import synthetic_tree
from hyperspace_tpu.models import poincare_embed as jpe
from hyperspace_torch.cli import train as tcli
from hyperspace_torch.models import poincare_embed as tpe

TOL = dict(rtol=2e-5, atol=1e-6)
DS = synthetic_tree(depth=3, branching=3)          # 40 nodes, 102 pairs
N = DS.num_nodes
STEPS = 3


def _cfgs(**kw):
    base = dict(num_nodes=N, dim=5, batch_size=48, neg_samples=6,
                burnin_steps=2, burnin_factor=0.1, lr=0.3)
    base.update(kw)
    return jpe.PoincareEmbedConfig(**base), tpe.PoincareEmbedConfig(**base)


def _spread_table(seed=0, dim=5, radius=0.6):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((N, dim))
    r = rng.uniform(0.05, radius, (N, 1))
    return (v / np.linalg.norm(v, axis=1, keepdims=True) * r).astype(
        np.float32)


def _start(jc, tc, seed=0):
    jstate, jopt = jpe.init_state(jc, 0)
    jstate = jstate._replace(table=jnp.asarray(_spread_table(seed, jc.dim)))
    tstate = tpe.state_from_jax(tc, jstate, device="cpu")
    return jstate, jopt, tstate, tpe.make_optimizer(tc)


def _jax_draws(jc, jstate, mined=False):
    """The ids JAX's dense/sparse step draws from ``jstate.key``."""
    _, k_batch, k_neg = jax.random.split(jstate.key, 3)
    rows = jax.random.randint(k_batch, (jc.batch_size,), 0, DS.num_pairs)
    batch = np.asarray(jnp.asarray(DS.pairs)[rows])
    if mined:
        extra = jax.random.randint(k_neg, (tpe.mine_pool_size(jc),), 0, N)
    else:
        extra = jax.random.randint(k_neg, (jc.batch_size, jc.neg_samples),
                                   0, N)
    t = lambda a: torch.as_tensor(np.array(a), dtype=torch.int64)  # noqa
    return t(batch[:, 0]), t(batch[:, 1]), t(extra), k_neg


def _close(t, j, what):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), err_msg=what,
                               **TOL)


@pytest.mark.parametrize("optimizer", ["rsgd", "radam"])
@pytest.mark.parametrize("neg_mode", ["uniform", "mined"])
def test_dense_steps_match_jax(optimizer, neg_mode):
    jc, tc = _cfgs(optimizer=optimizer, neg_mode=neg_mode)
    jstate, jopt, tstate, topt = _start(jc, tc)
    pairs = jnp.asarray(DS.pairs)
    for _ in range(STEPS):
        u, v, extra, _ = _jax_draws(jc, jstate, neg_mode == "mined")
        jstate, jl = jpe.train_step(jc, jopt, jstate, pairs)
        if neg_mode == "mined":
            tstate, tl = tpe.step_on_batch(tc, topt, tstate, u, v,
                                           pool_idx=extra)
        else:
            tstate, tl = tpe.step_on_batch(tc, topt, tstate, u, v, extra)
        _close(float(tl), float(jl), "loss")
        _close(tstate.table, jstate.table, "table")
    assert int(tstate.step) == int(jstate.step) == STEPS
    assert int(tstate.opt_state.count) == STEPS
    if optimizer == "radam":
        _close(tstate.opt_state.mu, jstate.opt_state.mu, "mu")
        _close(tstate.opt_state.nu, jstate.opt_state.nu, "nu")


def test_mined_negatives_equal_jax():
    jc, tc = _cfgs(neg_mode="mined", neg_samples=5, mine_pool=64)
    jstate, _, tstate, _ = _start(jc, tc, seed=4)
    u, _, pool, k_neg = _jax_draws(jc, jstate, mined=True)
    want = np.asarray(jpe._mine_negatives(jc, jstate.table,
                                          jnp.asarray(u.numpy()), k_neg))
    got = tpe._mine_negatives(tc, tstate.table, u, pool)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("optimizer", ["rsgd", "radam"])
def test_sparse_steps_match_jax(optimizer):
    jc, tc = _cfgs(optimizer=optimizer, sparse=True)
    jstate, jopt, tstate, topt = _start(jc, tc, seed=1)
    pairs = jnp.asarray(DS.pairs)
    for _ in range(STEPS):
        u, v, neg, _ = _jax_draws(jc, jstate)
        jstate, jl = jpe.train_step_sparse(jc, jopt, jstate, pairs)
        tstate, tl = tpe.sparse_step_on_batch(tc, topt, tstate, u, v, neg)
        _close(float(tl), float(jl), "loss")
        _close(tstate.table, jstate.table, "table")
    if optimizer == "radam":
        _close(tstate.opt_state.mu, jstate.opt_state.mu, "mu")
        _close(tstate.opt_state.nu, jstate.opt_state.nu, "nu")


def _batches(jc, steps, seed=5):
    rng = np.random.default_rng(seed)
    b = DS.pairs[rng.integers(0, DS.num_pairs, (steps, jc.batch_size))]
    neg = rng.integers(0, N, (steps, jc.batch_size, jc.neg_samples))
    return b[..., 0], b[..., 1], neg


def test_plan_arrays_equal_jax():
    jc, tc = _cfgs()
    u, v, neg = _batches(jc, 4)
    for a, b in zip(tpe.plan_arrays_np(tc, u, v, neg),
                    jpe.plan_arrays_np(jc, u, v, neg)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tp = tpe.plan_sparse_steps(tc, DS.pairs, 4, seed=3, device="cpu")
    jp = jpe.plan_sparse_steps(jc, DS.pairs, 4, seed=3)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tp.seg_sorted.dtype == torch.int32


@pytest.mark.parametrize("optimizer", ["rsgd", "radam"])
def test_planned_and_packed_steps_match_jax(optimizer):
    jc, tc = _cfgs(optimizer=optimizer)
    plan_np = _batches(jc, STEPS)
    jplan = jpe.plan_from_indices(jc, *plan_np)
    tplan = tpe.plan_from_indices(tc, *plan_np, device="cpu")
    jstate, jopt, tstate, topt = _start(jc, tc, seed=2)
    # JAX steps donate their state: pack a copy
    jpk = jpe.pack_state(jc, jax.tree_util.tree_map(jnp.copy, jstate))
    tpk = tpe.state_from_jax(tc, jpk, device="cpu")
    for _ in range(STEPS):
        jstate, jl = jpe.train_step_sparse_planned(jc, jopt, jstate, jplan)
        tstate, tl = tpe.train_step_sparse_planned(tc, topt, tstate, tplan)
        _close(float(tl), float(jl), "planned loss")
        jpk, jl = jpe.train_step_planned_packed(jc, jopt, jpk, jplan)
        tpk, tl = tpe.train_step_planned_packed(tc, topt, tpk, tplan)
        _close(float(tl), float(jl), "packed loss")
    _close(tstate.table, jstate.table, "planned table")
    _close(tpk.packed, jpk.packed, "packed rows")
    un = tpe.unpack_state(tc, tpk)
    _close(un.table, jstate.table, "packed vs planned")
    if optimizer == "radam":
        _close(tstate.opt_state.mu, jstate.opt_state.mu, "mu")
        _close(un.opt_state.nu, jstate.opt_state.nu, "nu")


def test_planned_epoch_matches_jax_and_stepwise():
    jc, tc = _cfgs(optimizer="radam")
    plan_np = _batches(jc, 4, seed=9)
    jplan = jpe.plan_from_indices(jc, *plan_np)
    tplan = tpe.plan_from_indices(tc, *plan_np, device="cpu")
    jstate, jopt, tstate, topt = _start(jc, tc, seed=3)
    jpk, jls = jpe.train_epoch_planned_packed(jc, jopt,
                                              jpe.pack_state(jc, jstate),
                                              jplan)
    tpk = tpe.pack_state(tc, tstate)
    ref = tpe.PackedState(tpk.packed.clone(), tpk.aux.clone(),
                          tpk.generator, tpk.step.clone())
    tpk, tls = tpe.train_epoch_planned_packed(tc, topt, tpk, tplan)
    _close(tls, jls, "losses")
    _close(tpk.packed, jpk.packed, "packed rows")
    steps = []
    for _ in range(4):
        ref, loss = tpe.train_step_planned_packed(tc, topt, ref, tplan)
        steps.append(loss)
    assert torch.equal(ref.packed, tpk.packed)
    assert torch.equal(torch.stack(steps), tls)
    assert int(tpk.step) == 4


@pytest.mark.parametrize("neg_mode", ["uniform", "mined"])
def test_dense_epoch_equals_its_steps(neg_mode):
    _, tc = _cfgs(optimizer="radam", neg_mode=neg_mode)
    a, opt = tpe.init_state(tc, 3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    gen.set_state(a.generator.get_state())
    b = a._replace(table=a.table.clone(), generator=gen)
    pairs = torch.as_tensor(DS.pairs, dtype=torch.int64)
    a, losses = tpe.train_epoch_scan(tc, opt, a, pairs, 5)
    steps = []
    for _ in range(5):
        b, loss = tpe.train_step(tc, opt, b, pairs)
        steps.append(loss)
    assert torch.equal(a.table, b.table)
    assert torch.equal(losses, torch.stack(steps))


def test_zero_distance_and_duplicate_rows():
    """Negatives equal to u (distance 0, masked) give a finite gradient
    equal to JAX's; duplicated rows sum their cotangents before the
    update, the same on the dense, sparse and planned paths."""
    jc, tc = _cfgs(batch_size=6, neg_samples=3, optimizer="rsgd",
                   burnin_steps=0)
    u = np.array([3, 3, 7, 7, 12, 3])
    v = np.array([1, 1, 2, 2, 4, 1])
    neg = np.array([[3, 5, 3], [1, 3, 9], [7, 7, 30], [20, 2, 7],
                    [12, 12, 12], [3, 3, 5]])
    table = _spread_table(6)
    with jax.enable_x64(True):
        jg = np.asarray(jax.grad(jpe.loss_fn)(
            jnp.asarray(table), jnp.asarray(u), jnp.asarray(v),
            jnp.asarray(neg), 1.0))
    tt = torch.as_tensor(table).requires_grad_()
    loss = tpe.loss_fn(tt, *(torch.as_tensor(a) for a in (u, v, neg)), 1.0)
    (tg,) = torch.autograd.grad(loss, tt)
    assert np.all(np.isfinite(tg.numpy()))
    np.testing.assert_allclose(tg.numpy(), jg, **TOL)
    jstate, jopt, tstate, topt = _start(jc, tc, seed=6)
    ids = [torch.as_tensor(a) for a in (u, v, neg)]
    dense, _ = tpe.step_on_batch(tc, topt, tstate, *ids)
    plan = tpe.plan_from_indices(tc, u[None], v[None], neg[None],
                                 device="cpu")
    jplan = jpe.plan_from_indices(jc, u[None], v[None], neg[None])
    jstate, _ = jpe.train_step_sparse_planned(jc, jopt, jstate, jplan)
    sparse, _ = tpe.sparse_step_on_batch(
        tc, topt, tpe.state_from_jax(tc, _start(jc, tc, seed=6)[0],
                                     device="cpu"), *ids)
    planned, _ = tpe.train_step_sparse_planned(
        tc, topt, tpe.state_from_jax(tc, _start(jc, tc, seed=6)[0],
                                     device="cpu"), plan)
    for st in (dense, sparse, planned):
        assert torch.all(torch.isfinite(st.table))
        _close(st.table, jstate.table, "duplicate rows")


def test_evaluate_equals_jax_on_a_trained_table():
    _, tc = _cfgs(neg_samples=15, batch_size=128, lr=0.5, burnin_steps=20)
    st, opt = tpe.init_state(tc, 0, device="cpu")
    pairs = torch.as_tensor(DS.pairs, dtype=torch.int64)
    before = tpe.evaluate(st.table, DS.pairs, 1.0)
    st, losses = tpe.train_epoch_scan(tc, opt, st, pairs, 300)
    got = tpe.evaluate(st.table, DS.pairs, 1.0, batch=37)
    want = jpe.evaluate(jnp.asarray(st.table.numpy()), DS.pairs, 1.0,
                        batch=37)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    assert got["map"] > before["map"] and got["map"] > 0.5
    assert bool(torch.all(torch.isfinite(losses)))


def test_config_checks_and_precision():
    _, tc = _cfgs(neg_mode="mined", sparse=True)
    with pytest.raises(ValueError, match="dense"):
        tpe.make_train_step(tc)
    with pytest.raises(ValueError, match="neg_mode"):
        tpe.make_train_step(_cfgs(neg_mode="hardest")[1])
    with pytest.raises(ValueError, match="mine_pool"):
        tpe.make_train_step(_cfgs(neg_mode="mined", neg_samples=8,
                                  mine_pool=4)[1])
    with pytest.raises(ValueError, match="caps neg_samples"):
        tpe.make_train_step(_cfgs(neg_mode="mined", neg_samples=300)[1])
    with pytest.raises(ValueError, match="optimizer"):
        tpe.make_optimizer(_cfgs(optimizer="sgd")[1])
    with pytest.raises(ValueError):
        tpe.init_state(_cfgs(precision="fp8")[1], device="cpu")
    # "bf16" computes exactly as "f32" on this workload, by design
    tables = []
    for prec in ("f32", "bf16"):
        _, c = _cfgs(precision=prec)
        st, opt = tpe.init_state(c, 1, device="cpu")
        st, _ = tpe.train_step(c, opt, st, torch.as_tensor(
            DS.pairs, dtype=torch.int64))
        tables.append(st.table)
    assert tables[0].dtype == torch.float32
    assert torch.equal(tables[0], tables[1])


def test_cli_reaches_the_verify_map(tmp_path, capsys):
    path = tmp_path / "closure.tsv"
    path.write_text("".join(f"n{u}\tn{v}\n" for u, v in DS.pairs))
    log = tmp_path / "log.jsonl"
    args = ["poincare", f"data_root={path}", "steps=950", "scan_chunk=100",
            "dim=5", "lr=0.5", "neg_samples=15", "batch_size=128",
            f"log={log}", "device=cpu", "eval_every=1"]
    assert tcli.main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["workload"] == "poincare" and out["steps"] == 1000
    assert out["map"] >= 0.85
    recs = [json.loads(s) for s in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == list(range(100, 1001, 100))
    with pytest.raises(SystemExit, match="scan_chunk"):
        tcli.main(["poincare", "sparse=true", "scan_chunk=4",
                   "device=cpu"])
    with pytest.raises(SystemExit, match="host_chunk_steps"):
        tcli.main(["poincare", "host_table=1", "scan_chunk=4",
                   "device=cpu"])

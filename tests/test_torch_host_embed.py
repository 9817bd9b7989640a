"""The port's host-resident trainer (``train/host_embed.py``,
``poincare_embed.train_epoch_planned_hosted``, ``cli/train.py poincare
host_table=1``) against the JAX package's, on the CPU.

The tree is ``synthetic_tree(depth=4, branching=3)`` (121 nodes) at dim
8, batch 32, 5 negatives.  Both packages start from one table spread over
the ball (JAX's ``TrainState``, handed to the port by ``state_from_jax``)
and draw the same plans (``chunk_plan_np`` is bitwise JAX's).  Losses,
the master's rows (with RAdam's moments) and the counts after 14 steps
in chunks of 4 (a ragged tail of 2) are held within rtol 2e-5, atol 1e-6,
the tier of the planned-packed parity tests; float32 in both (JAX under
a scoped ``enable_x64(False)``: with x64 on, its Adam bias corrections
are float64, and 14 steps carry that past the tier on a few moments).  A chunk
of 4 steps touches the whole table here, so eviction pressure runs in
chunks of 2 over a cache of the largest chunk's working set (less than
the table): the evictions and every ``host_table/*`` counter are JAX's.
On the port alone the host path is bitwise its in-HBM reference
(``run_planned_inhbm``), with and without evictions, and
``gather_ahead`` is bitwise the synchronous gather at ``hot_rows >= N``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.cli import train as jcli
from hyperspace_tpu.data.wordnet import synthetic_tree
from hyperspace_tpu.models import poincare_embed as jpe
from hyperspace_tpu.parallel import host_table as jht
from hyperspace_tpu.telemetry import registry as jtelem
from hyperspace_tpu.train import host_embed as jhe
from hyperspace_torch.cli import train as tcli
from hyperspace_torch.models import poincare_embed as tpe
from hyperspace_torch.telemetry import registry as ttelem
from hyperspace_torch.train import host_embed as the

TOL = dict(rtol=2e-5, atol=1e-6)
DS = synthetic_tree(depth=4, branching=3)          # 121 nodes
N = DS.num_nodes
STEPS, CHUNK, SEED = 14, 4, 3


def _cfgs(**kw):
    base = dict(num_nodes=N, dim=8, batch_size=32, neg_samples=5,
                burnin_steps=3, burnin_factor=0.1, lr=0.3)
    base.update(kw)
    return jpe.PoincareEmbedConfig(**base), tpe.PoincareEmbedConfig(**base)


def _start(jc, tc, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((N, jc.dim))
    table = (v / np.linalg.norm(v, axis=1, keepdims=True)
             * rng.uniform(0.05, 0.6, (N, 1))).astype(np.float32)
    jstate, jopt = jpe.init_state(jc, 0)
    jstate = jstate._replace(table=jnp.asarray(table))
    return jstate, jopt, tpe.state_from_jax(tc, jstate, device="cpu"), \
        tpe.make_optimizer(tc)


def _evicting_rows(cfg, chunk):
    """The largest working set of a chunk of ``chunk`` steps over the
    run: the smallest cache that holds every chunk."""
    sizes = the._chunk_sizes(STEPS, chunk)
    ws = [int(np.sum(np.unique(the.chunk_plan_np(
        cfg, DS.pairs, s, SEED, i)[3]) < N)) for i, s in enumerate(sizes)]
    return max(ws)


def test_plans_and_sizes_equal_jax():
    jc, tc = _cfgs()
    for ci, s in ((0, 4), (1, 4), (7, 2), (3, 1)):
        for a, b in zip(the.chunk_plan_np(tc, DS.pairs, s, SEED, ci),
                        jhe.chunk_plan_np(jc, DS.pairs, s, SEED, ci)):
            np.testing.assert_array_equal(a, np.asarray(b))
    for steps, cs in ((14, 4), (12, 4), (3, 8), (0, 8)):
        assert the._chunk_sizes(steps, cs) == jhe._chunk_sizes(steps, cs)
    for cs in (1, 4, 8):
        assert the.auto_hot_rows(tc, cs) == jhe.auto_hot_rows(jc, cs)
    assert (the.DEFAULT_CHUNK_STEPS, the.EVAL_MAX_ROWS) == (
        jhe.DEFAULT_CHUNK_STEPS, jhe.EVAL_MAX_ROWS)


def _counters(reg):
    snap = reg.default_registry().snapshot()
    return {k: v for k, v in snap.items() if k.startswith("host_table/")
            and k != "host_table/io_rows_peak"}


@pytest.mark.parametrize("optimizer", ["rsgd", "radam"])
@pytest.mark.parametrize("evict", [False, True])
def test_hosted_trainer_matches_jax(optimizer, evict):
    jc, tc = _cfgs(optimizer=optimizer)
    chunk = 2 if evict else CHUNK
    kw = dict(chunk_steps=chunk, seed=SEED,
              hot_rows=_evicting_rows(tc, chunk) if evict else 0)
    if evict:
        assert kw["hot_rows"] < N
    for reg in (jtelem, ttelem):
        reg.default_registry().reset()
    with jax.enable_x64(False):    # float32 in both, Adam's terms too
        jstate, jopt, tstate, topt = _start(jc, tc, seed=1)
        jt = jhe.HostPlannedTrainer.from_state(jc, jopt, jstate, **kw)
        jl = jt.run(DS.pairs, STEPS)
    tt = the.HostPlannedTrainer.from_state(tc, topt, tstate, device="cpu",
                                           **kw)
    assert tt.cache.capacity == jt.cache.capacity
    tl = tt.run(DS.pairs, STEPS)
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(tt.master.to_array(), jt.master.to_array(),
                               **TOL)
    assert int(tt.step) == int(jt.step) == STEPS
    count = tt.aux if optimizer == "radam" else tt.aux.count
    jcount = jt.aux if optimizer == "radam" else jt.aux.count
    assert int(count) == int(jcount)
    tc_, jc_ = _counters(ttelem), _counters(jtelem)
    assert tc_ == jc_
    assert (tc_.get("host_table/cache_evictions", 0) > 0) == evict
    for name in ("data_wait", "host_gather", "device_step", "write_back"):
        assert ttelem.default_registry().snapshot()[
            f"hist/train/phase/{name}_ms"]["count"] == len(
                the._chunk_sizes(STEPS, chunk))
    st = tt.to_state()
    with jax.enable_x64(False):
        js = jt.to_state()
    np.testing.assert_allclose(st.table.numpy(), np.asarray(js.table), **TOL)


@pytest.mark.parametrize("optimizer", ["rsgd", "radam"])
@pytest.mark.parametrize("evict", [False, True])
def test_hosted_is_bitwise_the_inhbm_reference(optimizer, evict):
    _, tc = _cfgs(optimizer=optimizer)
    _, _, tstate, topt = _start(*_cfgs(optimizer=optimizer), seed=2)
    chunk = 2 if evict else CHUNK
    hot = _evicting_rows(tc, chunk) if evict else 0
    tt = the.HostPlannedTrainer.from_state(
        tc, topt, tstate, chunk_steps=chunk, seed=SEED, hot_rows=hot,
        device="cpu")
    losses = tt.run(DS.pairs, STEPS)
    ref, ref_losses = the.run_planned_inhbm(tc, topt, tstate, DS.pairs,
                                            STEPS, chunk_steps=chunk,
                                            seed=SEED)
    got = tt.to_state()
    assert np.array_equal(losses, ref_losses)
    assert torch.equal(got.table, ref.table)
    assert int(got.step) == int(ref.step) == STEPS
    if optimizer == "radam":
        assert torch.equal(got.opt_state.mu, ref.opt_state.mu)
        assert torch.equal(got.opt_state.nu, ref.opt_state.nu)
        assert int(got.opt_state.count) == int(ref.opt_state.count)


def test_gather_ahead_is_exact_when_the_table_fits():
    _, tc = _cfgs(optimizer="radam")
    outs = []
    for ahead in (False, True):
        _, _, tstate, topt = _start(*_cfgs(optimizer="radam"), seed=4)
        tt = the.HostPlannedTrainer.from_state(
            tc, topt, tstate, chunk_steps=CHUNK, seed=SEED, hot_rows=N,
            gather_ahead=ahead, device="cpu")
        outs.append((tt.run(DS.pairs, STEPS), tt.master.to_array()))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1], outs[1][1])


def test_sentinel_padding_is_dropped():
    """A step whose plan pads with the sentinel (duplicate ids) writes
    nothing but its real rows: the hosted chunk over a cache is bitwise
    the in-HBM chunk on the same plan."""
    _, tc = _cfgs(batch_size=6, neg_samples=3, optimizer="rsgd",
                  burnin_steps=0)
    u = np.array([[3, 3, 7, 7, 12, 3], [5, 6, 7, 8, 9, 10]])
    v = np.array([[1, 1, 2, 2, 4, 1], [1, 2, 2, 2, 3, 3]])
    neg = np.tile(np.array([[3, 5, 3], [1, 3, 9], [7, 7, 30], [20, 2, 7],
                            [12, 12, 12], [3, 3, 5]]), (2, 1, 1))
    plan = tpe.plan_arrays_np(tc, u, v, neg)
    assert np.any(plan[3] == N)                  # sentinel-padded rows
    _, _, st, opt = _start(*_cfgs(batch_size=6, neg_samples=3,
                                  optimizer="rsgd", burnin_steps=0), seed=6)
    packed = tpe.pack_state(tc, st)
    ids = np.unique(plan[3])
    ids = ids[ids < N]
    cap = len(ids) + 3
    cache = torch.full((cap, tc.dim), 7.0)        # slots in reverse order
    slots = np.arange(cap - 1, cap - 1 - len(ids), -1)
    cache[torch.as_tensor(slots)] = packed.packed[torch.as_tensor(ids)]
    pos = np.minimum(np.searchsorted(ids, plan[3]), len(ids) - 1)
    local = np.where(plan[3] >= N, cap, slots[pos])
    to_t = [torch.as_tensor(np.asarray(a), dtype=torch.int32 if i == 6
                            else torch.int64)
            for i, a in enumerate(plan[:3] + (local,) + plan[4:])]
    hosted, hl = tpe.train_epoch_planned_hosted(
        dataclasses.replace(tc, num_nodes=cap), opt,
        tpe.PackedState(cache, packed.aux, packed.generator, packed.step),
        tpe.SparsePlan(*to_t))
    ref, rl = tpe.train_epoch_planned_packed(
        tc, opt, packed, tpe.plan_from_indices(tc, u, v, neg, device="cpu"))
    assert torch.equal(hl, rl)
    assert torch.equal(hosted.packed[torch.as_tensor(slots)],
                       ref.packed[torch.as_tensor(ids)])
    rest = np.setdiff1d(np.arange(cap), slots)
    assert torch.all(hosted.packed[torch.as_tensor(rest)] == 7.0)


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("bad", ["rows", "chunk", "mined"])
def test_validation_errors_match_jax(bad):
    jc, tc = _cfgs(neg_mode="mined" if bad == "mined" else "uniform")
    jstate, jopt, tstate, topt = _start(jc, tc)
    kw = dict(chunk_steps=0 if bad == "chunk" else 4)
    if bad == "rows":
        jm = jht.HostEmbedTable.from_array(np.zeros((N + 1, 8), np.float32))
        from hyperspace_torch.parallel import host_table as tht
        tm = tht.HostEmbedTable.from_array(np.zeros((N + 1, 8), np.float32))
        jfn = lambda: jhe.HostPlannedTrainer(  # noqa: E731
            jc, jopt, jm, jopt.init(jnp.zeros((1, 8))), jstate.key, **kw)
        tfn = lambda: the.HostPlannedTrainer(  # noqa: E731
            tc, topt, tm, topt.init(torch.zeros((1, 8))), device="cpu",
            **kw)
    else:
        jfn = lambda: jhe.HostPlannedTrainer.from_state(  # noqa: E731
            jc, jopt, jstate, **kw)
        tfn = lambda: the.HostPlannedTrainer.from_state(  # noqa: E731
            tc, topt, tstate, **kw)
    assert _message(tfn) == _message(jfn)


# --- the CLI ---------------------------------------------------------------


def _closure(tmp_path):
    path = tmp_path / "closure.tsv"
    with open(path, "w") as f:
        f.writelines(f"n{u}\tn{v}\n" for u, v in DS.pairs)
    return str(path)


def test_cli_branch_matches_jax(tmp_path):
    """``run_poincare`` with ``host_table=1`` through both packages on one
    closure file: the same keys and steps (the two packages draw their
    initial tables from different generators, so the metrics differ);
    the port's saved master, read by JAX's ``load_sharded``, is bitwise
    the master of the same run through ``HostPlannedTrainer``."""
    tsv = _closure(tmp_path)
    kw = dict(steps=10, seed=2, data_root=tsv, host_table=True, hot_rows=0,
              host_chunk_steps=4, host_gather_ahead=True)
    wl = {"dim": "8", "batch_size": "32", "neg_samples": "5",
          "optimizer": "radam", "lr": "0.1"}
    jres = jcli.run_poincare(jcli.RunConfig(**kw), dict(wl))
    tres = tcli.run_poincare(tcli.RunConfig(
        ckpt_dir=str(tmp_path / "ck"), device="cpu", **kw), dict(wl))
    assert list(tres) == list(jres)
    assert tres["host_table"] is True and tres["steps"] == jres["steps"]
    assert 0.0 < tres["map"] <= 1.0 and 0.0 < jres["map"] <= 1.0
    saved = jht.HostEmbedTable.load_sharded(str(tmp_path / "ck" /
                                                "host_table"))
    cfg = tpe.PoincareEmbedConfig(num_nodes=N, dim=8, batch_size=32,
                                  neg_samples=5, optimizer="radam", lr=0.1)
    st, opt = tpe.init_state(cfg, 2, device="cpu")
    ref = the.HostPlannedTrainer.from_state(
        cfg, opt, st, chunk_steps=4, seed=2, gather_ahead=True)
    from hyperspace_torch.data.wordnet import load_closure_tsv
    ref.run(load_closure_tsv(tsv).pairs, 10)
    assert np.array_equal(saved.to_array(), ref.master.to_array())
    with open(tmp_path / "ck" / "host_table" / "host_table.json") as f:
        assert json.load(f)["codec"] == "npy"
    assert os.listdir(tmp_path / "ck") == ["host_table"]


@pytest.mark.parametrize("extra", [["scan_chunk=2"], ["sparse=true"]])
def test_cli_refusals_match_jax(extra, tmp_path):
    tsv = _closure(tmp_path)
    argv = ["host_table=1", f"data_root={tsv}", "steps=2"] + extra
    msgs = []
    for cli, more in ((jcli, []), (tcli, ["device=cpu"])):
        run, wl = cli.split_overrides(argv + more, cli.RunConfig())
        with pytest.raises(SystemExit) as e:
            cli.run_poincare(run, wl)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_cli_main_takes_the_host_keys(tmp_path, capsys):
    """None of ``host_table``, ``hot_rows``, ``host_chunk_steps``,
    ``host_gather_ahead`` or a ``data.next_batch`` spec exits "not
    ported"; the spec fires on the host path (the injected error ends
    the run), and changes nothing on a dense run."""
    tsv = _closure(tmp_path)
    base = ["poincare", f"data_root={tsv}", "dim=8", "batch_size=32",
            "neg_samples=5", "steps=8", "device=cpu"]
    host = base + ["host_table=1", "hot_rows=121", "host_chunk_steps=2",
                   "host_gather_ahead=1"]
    assert tcli.main(host) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["host_table"] is True and res["steps"] == 8
    from hyperspace_torch.resilience.faults import InjectedIOError
    with pytest.raises(InjectedIOError, match="data.next_batch"):
        tcli.main(host + ["chaos=data.next_batch:ioerror:after=2"])
    outs = []
    for extra in ([], ["chaos=data.next_batch:ioerror:after=0:times=0"]):
        assert tcli.main(base + extra) == 0
        outs.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    chaos = outs[1].pop("chaos")
    assert outs[0] == outs[1] and chaos["fired"] == 0

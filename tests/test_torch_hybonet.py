"""HyboNet text classification in the port against the JAX package, on the
CPU: the text data, the optimizer, the whole model from one flax
parameter tree, one ``train_step`` and a 20-step loss trajectory, the
CLI and the bench.

Tolerances: data array-equal; logits f32 rtol 1e-4; one step's loss
rtol 1e-5 and every updated parameter rtol 1e-4 with atol 1e-6 (a
thousandth of the step's size lr: AdamW's first update is lr·g/(|g| +
1e-8), so an entry whose gradient is rounding-level small moves by a
rounding-sized share of lr) against JAX with its kernels in interpret
mode; 20-step losses within 1e-3; AdamW against optax rtol 1e-6.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from hyperspace_tpu.data import text as JT
from hyperspace_tpu.models import hybonet as JH
from hyperspace_tpu.utils import metrics as JMET
from hyperspace_torch.benchmarks import workloads_bench as WB
from hyperspace_torch.cli import train as cli_train
from hyperspace_torch.data import text as TT
from hyperspace_torch.models import hybonet as TH
from hyperspace_torch.optim.adamw import AdamW
from hyperspace_torch.utils import metrics as TMET

CFG = dict(vocab_size=64, num_classes=3, max_len=12, dim=16, num_heads=2,
           num_layers=2, batch_size=8)


# --- data --------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(num_samples=64, vocab_size=128, max_len=16),
    dict(num_samples=33, vocab_size=40, num_classes=3, max_len=9, min_len=1,
         class_sharpness=1.5, seed=7)])
def test_synthetic_text_and_split_match_jax(kw):
    a, b = JT.synthetic_text(**kw), TT.synthetic_text(**kw)
    for f in ("tokens", "mask", "labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert (a.vocab_size, a.num_classes) == (b.vocab_size, b.num_classes)
    for sa, sb in zip(a.split(0.75, seed=3), b.split(0.75, seed=3)):
        for f in ("tokens", "mask", "labels"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))


def test_tsv_and_load_text_match_jax(tmp_path):
    p = tmp_path / "toy.tsv"
    p.write_text("pos\tgood great fine\nneg\tbad awful bad\npos\tgood\n"
                 "mid\tfine FINE ok\nbroken line\n")
    for kw in (dict(max_len=4), dict(max_len=2, max_vocab=4)):
        a, b = JT.load_tsv(str(p), **kw), TT.load_tsv(str(p), **kw)
        for f in ("tokens", "mask", "labels"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.vocab_size, a.num_classes) == (b.vocab_size,
                                                  b.num_classes)
    (ja, js), (ta, ts) = (JT.load_text("toy", str(tmp_path)),
                          TT.load_text("toy", str(tmp_path)))
    assert js == ts == "disk"
    np.testing.assert_array_equal(ja.tokens, ta.tokens)
    assert TT.load_text("none", str(tmp_path), num_samples=8)[1] == \
        "synthetic"


def test_accuracy_matches_jax():
    rng = np.random.default_rng(0)
    logits, labels = rng.standard_normal((50, 4)), rng.integers(0, 4, 50)
    mask = rng.random(50) > 0.5
    assert TMET.accuracy(logits, labels) == JMET.accuracy(logits, labels)
    assert TMET.accuracy(logits, labels, mask) == JMET.accuracy(
        logits, labels, mask)


def test_adamw_without_clip_matches_optax():
    rng = np.random.default_rng(1)
    p0 = {"a": rng.standard_normal((3, 4)), "b": rng.standard_normal(5)}
    grads = [{k: rng.standard_normal(v.shape) * 10.0 ** -i for k, v in
              p0.items()} for i in range(5)]
    with jax.enable_x64(True):
        opt = optax.adamw(3e-3, weight_decay=1e-2)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        st = opt.init(jp)
        for g in grads:
            up, st = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                st, jp)
            jp = optax.apply_updates(jp, up)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    topt = AdamW(tp, 3e-3, 1e-2)
    for g in grads:
        topt.step([torch.tensor(g[k]) for k in topt.names])
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6)


# --- the whole model -------------------------------------------------------


def _batch(seed=0, n=8, cfg=CFG):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg["vocab_size"], (n, cfg["max_len"])).astype(
        np.int32)
    lens = rng.integers(3, cfg["max_len"] + 1, n)
    lens[0] = cfg["max_len"]
    mask = np.arange(cfg["max_len"])[None, :] < lens[:, None]
    toks[~mask] = 0
    return toks, mask, rng.integers(0, cfg["num_classes"], n).astype(
        np.int32)


def _models(impl="flash", **over):
    kw = dict(CFG, attention_impl=impl, **over)
    jmodel, jopt, jstate = JH.init_model(JH.HyboNetConfig(**kw), seed=0)
    params = jax.tree.map(np.asarray, jstate.params)
    tmodel, topt, tstate = TH.init_model(TH.HyboNetConfig(**kw), seed=0,
                                         device="cpu")
    tmodel.load_state_dict(TH.params_from_jax(params))
    return (jmodel, jopt, jstate), (tmodel, topt, tstate), params


def test_params_from_jax_names_and_dtypes():
    _, (tmodel, _, _), params = _models()
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert {a.dtype for _, a in leaves} == {np.dtype(np.float32)}
    sd = TH.params_from_jax(params)
    assert set(sd) == set(tmodel.state_dict())
    assert "block1.mha.out.kernel" in sd and "head.p_tangent" in sd
    for k, v in tmodel.state_dict().items():
        assert v.dtype == torch.float32 and v.shape == sd[k].shape, k


@pytest.mark.parametrize("impl", ["flash", "scan"])
def test_logits_match_jax(impl):
    (jm, _, js), (tm, _, _), _ = _models(impl)
    toks, mask, labels = _batch()
    want = np.asarray(JH.eval_logits(jm, js.params, jnp.asarray(toks),
                                     jnp.asarray(mask)))
    got = TH.eval_logits(tm, torch.as_tensor(toks),
                         torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    ds = TT.TextDataset(toks, mask, labels, CFG["vocab_size"],
                        CFG["num_classes"])
    assert TH.evaluate(tm, ds, batch=3) == JH.evaluate(jm, js.params, ds,
                                                       batch=3)


def _step_both(**over):
    (jm, jo, js), (tm, to, ts), p0 = _models(**over)
    toks, mask, labels = _batch(1)
    js2, jloss = JH.train_step(jm, jo, js, jnp.asarray(toks),
                               jnp.asarray(mask), jnp.asarray(labels))
    ts2, tloss = TH.train_step(tm, to, ts, torch.as_tensor(toks),
                               torch.as_tensor(mask),
                               torch.as_tensor(labels))
    want = TH.params_from_jax(jax.tree.map(np.asarray, js2.params))
    return float(jloss), float(tloss), want, tm.state_dict(), \
        TH.params_from_jax(p0)


def test_train_step_matches_jax_kernels(monkeypatch):
    """JAX with its Pallas kernels in interpret mode: its flash backward
    gives dβ ≡ 0, as the port's does, so every parameter can be held."""
    monkeypatch.setenv("HYPERSPACE_KERNELS", "interpret")
    jloss, tloss, want, got, before = _step_both(num_layers=1)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        if k.endswith("beta"):
            assert torch.equal(got[k], before[k])       # dβ ≡ 0


def test_train_step_matches_jax_twin_but_beta():
    """JAX in xla mode autodiffs its dense twin, whose dβ is rounding
    noise around 0; AdamW's first step turns that noise into an update of
    about ±lr, so β is the one parameter that cannot agree.  β moves no
    output (a softmax ignores a shift), so everything else does."""
    jloss, tloss, want, got, before = _step_both()
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for k, w in want.items():
        if k.endswith("beta"):
            assert torch.equal(got[k], before[k])
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_loss_trajectory_matches_jax():
    """20 steps on the same fixed batches; JAX's twin moves β by noise,
    which changes no output, so the losses still agree."""
    (jm, jo, js), (tm, to, ts), _ = _models()
    jl, tl = [], []
    for i in range(20):
        toks, mask, labels = _batch(10 + i)
        js, loss = JH.train_step(jm, jo, js, jnp.asarray(toks),
                                 jnp.asarray(mask), jnp.asarray(labels))
        jl.append(float(loss))
        ts, loss = TH.train_step(tm, to, ts, torch.as_tensor(toks),
                                 torch.as_tensor(mask),
                                 torch.as_tensor(labels))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)
    assert ts.step == 20


def test_bf16_policy_runs_the_matmuls_in_bf16():
    cfg = TH.HyboNetConfig(**dict(CFG, precision="bf16"))
    model, opt, state = TH.init_model(cfg, device="cpu")
    assert model.block0.mha.compute_dtype == torch.bfloat16
    assert model.block0.ffn_in.compute_dtype == torch.bfloat16
    toks, mask, labels = (torch.as_tensor(a) for a in _batch(2))
    state, loss = TH.train_step(model, opt, state, toks, mask, labels)
    assert torch.isfinite(loss) and model.tok_embed.dtype == torch.float32


def test_sampled_step_and_dropout_use_the_state_generators():
    cfg = TH.HyboNetConfig(**dict(CFG, dropout=0.1))
    toks, mask, labels = (torch.as_tensor(a) for a in _batch(3, n=20))
    runs = []
    for _ in range(2):
        model, opt, state = TH.init_model(cfg, seed=4, device="cpu")
        losses = [float(TH.train_step_sampled(model, opt, state, toks, mask,
                                              labels)[1]) for _ in range(3)]
        runs.append(losses)
    assert runs[0] == runs[1] and np.all(np.isfinite(runs[0]))


# --- entry points ------------------------------------------------------------


def test_cli_trains_and_prints_one_json_line(capsys, tmp_path):
    log = tmp_path / "losses.jsonl"
    cli_train.main(["hybonet", "--yaml", "configs/hybonet_textclf.yaml",
                    "steps=3", "dim=16", "num_heads=2", "num_layers=1",
                    "device=cpu", "dtype=float32", f"log={log}",
                    "eval_every=1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert list(res) == ["workload", "source", "loss", "accuracy"]
    assert res["workload"] == "hybonet" and res["source"] == "synthetic"
    assert np.isfinite(res["loss"]) and 0.0 <= res["accuracy"] <= 1.0
    recs = [json.loads(s) for s in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert recs[-1]["loss"] == res["loss"]


def test_cli_usage_errors():
    base = ["hybonet", "steps=1", "device=cpu", "dim=8", "num_heads=2",
            "num_layers=1"]
    for extra in (["no_such_key=1"], ["rollback=1"], ["precision=f16"],
                  ["oops"]):
        with pytest.raises(SystemExit):
            cli_train.main(base + extra)


def test_flat_yaml_reader_matches_yaml():
    path = "configs/hybonet_textclf.yaml"
    with open(path) as f:
        want = {k: str(v) for k, v in yaml.safe_load(f).items()}
    got = dict(p.split("=", 1) for p in cli_train.read_flat_yaml(path))
    assert got == want


def test_cli_overrides_coerce_types():
    run, wl = cli_train.split_overrides(
        ["steps=7", "device=cpu", "dim=24", "lr=0.5", "log=x.jsonl"],
        cli_train.RunConfig())
    assert run.steps == 7 and run.device == "cpu" and run.log == "x.jsonl"
    cfg = cli_train.apply_overrides(TH.HyboNetConfig(), wl)
    assert cfg.dim == 24 and cfg.lr == 0.5


def test_bench_leg_on_cpu_reports_its_fields():
    cfg = dataclasses.replace(WB.LEGS["hybonet"], vocab_size=64, max_len=16,
                              dim=8, num_heads=2, num_layers=1, batch_size=4)
    leg = WB.setup_leg("hybonet", device="cpu", cfg=cfg)
    res = WB.run_leg(leg, steps=2, repeats=1)
    for key in ("step_ms", "tokens_per_s", "batch", "dim", "layers",
                "attention_impl", "precision", "device"):
        assert key in res
    assert res["batch"] == [4, 16] and res["device"] == "cpu"
    assert len(res["losses"]) == 3 and np.all(np.isfinite(res["losses"]))
    assert WB.LEGS["hybonet_long"].max_len == 4096

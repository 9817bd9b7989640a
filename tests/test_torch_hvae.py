"""The port's hyperbolic VAE (``models/hvae.py``, ``data/mnist.py``,
``cli/train.py hvae``, the cast helpers of ``precision.py``) against the
JAX package, on the CPU.

Both packages run from JAX's ``init_model`` parameters
(``params_from_jax``) and the same draws: the test reproduces JAX's key
schedule (``train_step_sampled`` splits off the batch ids, then ε) and
hands the draws to the port as ``idx=``/``eps=``.  The encoder and
decoder are held at image size 28 with conv (32, 64), where flax's
asymmetric ``SAME`` padding is (0, 1) at 28→14→7 and (2, 1) for the
transposed convs at 7→14→28, and at size 16 with conv (8,) and
(8, 16), at batch 2.  Tolerances (float32): encoder and decoder outputs
rtol 1e-5 (atol 1e-6); ``elbo_terms``, three sampled steps (loss, recon,
kl and parameters) and the IWAE bound rtol 2e-5 (atol 2e-5 on the
parameters); one Adam update against ``optax.adam`` atol 1e-6;
``synthetic_mnist`` and the IDX reader bitwise; the ``bf16`` policy's
five-step losses within rel 2e-2 of JAX's (``docs/precision.md``).
"""

import gzip
import io
import json
import os
import struct
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperspace_tpu.data import mnist as JM
from hyperspace_tpu.models import hvae as jv
from hyperspace_torch import precision as tprec
from hyperspace_torch.cli import train as tcli
from hyperspace_torch.data import mnist as TM
from hyperspace_torch.models import hvae as tv
from hyperspace_torch.optim.common import apply_updates
from hyperspace_torch.train import loop

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=2e-5, atol=2e-5)
SMALL = dict(image_size=16, latent_dim=3, hidden=32, conv_features=(8, 16),
             batch_size=8, lr=2e-3)


# --- data -------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(num_samples=40),
                                dict(num_samples=17, num_classes=4, size=16,
                                     seed=3)])
def test_synthetic_mnist_bitwise(kw):
    want, got = JM.synthetic_mnist(**kw), TM.synthetic_mnist(**kw)
    assert got.images.dtype == np.float32 and got.labels.dtype == np.int32
    assert np.array_equal(got.images, want.images)
    assert np.array_equal(got.labels, want.labels)
    for a, b in zip(got.split(0.75, seed=2), want.split(0.75, seed=2)):
        assert np.array_equal(a.images, b.images)
        assert np.array_equal(a.labels, b.labels)


def _write_idx(path, arr, gz):
    body = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape) + arr.tobytes()
    with (gzip.open if gz else open)(path + (".gz" if gz else ""), "wb") as f:
        f.write(body)


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gzip"])
def test_load_idx_dir_matches_jax(tmp_path, gz):
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (3, 5, 6)).astype(np.uint8)
    labs = np.asarray([3, 7, 0], np.uint8)
    _write_idx(str(tmp_path / "train-images-idx3-ubyte"), imgs, gz)
    _write_idx(str(tmp_path / "train-labels-idx1-ubyte"), labs, gz)
    got, want = TM.load_idx_dir(str(tmp_path)), JM.load_idx_dir(
        str(tmp_path))
    assert got.images.dtype == np.float32 and got.images.shape == (3, 5, 6)
    assert np.array_equal(got.images, want.images)
    assert np.array_equal(got.labels, want.labels)
    ds, source = TM.load_mnist(str(tmp_path))
    assert source == "disk" and np.array_equal(ds.labels, labs)


def test_load_mnist_falls_back_to_synthetic(tmp_path):
    for root in (None, str(tmp_path), str(tmp_path / "absent")):
        ds, source = TM.load_mnist(root, num_samples=5)
        assert source == "synthetic" and ds.images.shape == (5, 28, 28)
    with pytest.raises(FileNotFoundError):
        TM.load_idx_dir(str(tmp_path))


# --- the model ---------------------------------------------------------------


def _cfgs(**kw):
    return jv.HVAEConfig(**kw), tv.HVAEConfig(**kw)


def _init(jc):
    _, _, st = jv.init_model(jc, 0)
    return jax.tree_util.tree_map(np.array, st.params)


@pytest.mark.parametrize("kind", ["poincare", "lorentz"])
@pytest.mark.parametrize("size,conv", [(28, (32, 64)), (16, (8,)),
                                       (16, (8, 16))])
def test_encoder_and_decoder_match_jax(size, conv, kind):
    jc, tc = _cfgs(image_size=size, conv_features=conv, latent_dim=3,
                   hidden=32, kind=kind)
    p = _init(jc)
    x = JM.synthetic_mnist(num_samples=2, size=size, seed=1).images
    with jax.enable_x64(True):
        jq = jax.jit(lambda p_, x_: jv.Encoder(jc).apply({"params": p_}, x_))(
            p["encoder"], jnp.asarray(x))
        z = np.asarray(jq.rsample(jax.random.PRNGKey(2)))
        jlog = jax.jit(lambda p_, z_: jv.Decoder(jc).apply({"params": p_},
                                                           z_))(
            p["decoder"], jnp.asarray(z))
    tp = tv.params_from_jax(p)
    tq = tv.Encoder(tc)(tp["encoder"], torch.as_tensor(x))
    np.testing.assert_allclose(tq.loc.numpy(), np.asarray(jq.loc), **OUT_TOL)
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                               **OUT_TOL)
    tlog = tv.Decoder(tc)(tp["decoder"], torch.as_tensor(z))
    assert tlog.shape == (2, size, size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **OUT_TOL)


def test_init_params_have_jax_names_shapes_and_scale():
    """At the CLI config's width (the latent's coordinates have the same
    width on both geometries, so one kind covers both)."""
    jc, tc = _cfgs(latent_dim=8)
    want = tv.params_from_jax(_init(jc))
    got = tv.init_params(tc, torch.Generator().manual_seed(0))
    flat = lambda t: {f"{a}.{b}.{c}": v for a, la in t.items()  # noqa
                      for b, lb in la.items() for c, v in lb.items()}
    fw, fg = flat(want), flat(got)
    assert sorted(fw) == sorted(fg)
    for k in fw:
        assert fg[k].shape == fw[k].shape, k
        if k.endswith("kernel") and fw[k].numel() > 2000:
            r = float(fg[k].std() / fw[k].std())
            assert 0.9 < r < 1.1, (k, r)


def _jax_draws(jc, key, n_images):
    """The ids and ε JAX's ``train_step_sampled`` draws from ``key``."""
    key, k_next = jax.random.split(key)
    idx = jax.random.randint(k_next, (jc.batch_size,), 0, n_images)
    _, k_sample = jax.random.split(key)
    eps = jax.random.normal(k_sample, (jc.batch_size, jc.latent_dim),
                            jnp.float32)
    return torch.as_tensor(np.array(idx), dtype=torch.int64), \
        torch.as_tensor(np.array(eps))


def _runs(kind, precision="f32", steps=3):
    jc, tc = _cfgs(kind=kind, precision=precision, **SMALL)
    x_all = JM.synthetic_mnist(num_samples=32, size=16, seed=0).images
    jm, jopt, jst = jv.init_model(jc, 0)
    p0 = jax.tree_util.tree_map(np.array, jst.params)
    jx = jnp.asarray(x_all)
    tm, topt, tst = tv.init_model(tc, 0, "cpu", params=tv.params_from_jax(p0))
    tx = torch.as_tensor(x_all)
    j, t = [], []
    for _ in range(steps):
        idx, eps = _jax_draws(jc, jst.key, len(x_all))
        jst, *jout = jv.train_step_sampled(jm, jopt, jst, jx)
        tst, *tout = tv.train_step_sampled(tm, topt, tst, tx, idx=idx,
                                           eps=eps)
        j.append([float(v) for v in jout])
        t.append([float(v) for v in tout])
    return (np.asarray(j), jax.tree_util.tree_map(np.array, jst.params),
            np.asarray(t), tst)


@pytest.fixture(scope="module", params=["poincare", "lorentz"])
def step_runs(request):
    return request.param, _runs(request.param)


def test_sampled_steps_match_jax(step_runs):
    _kind, (j, jp, t, tst) = step_runs
    assert np.all(np.isfinite(t))
    np.testing.assert_allclose(t, j, **STEP_TOL)     # loss, recon, kl
    want = tv.params_from_jax(jp)
    for part in want:
        for layer in want[part]:
            for name, w in want[part][layer].items():
                got = tst.params[part][layer][name]
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), w.numpy(),
                                           err_msg=f"{part}/{layer}/{name}",
                                           **STEP_TOL)
    assert int(tst.step) == 3


@pytest.mark.parametrize("kind", ["poincare", "lorentz"])
def test_elbo_terms_and_iwae_match_jax(kind):
    jc, tc = _cfgs(kind=kind, **SMALL)
    p = _init(jc)
    x = JM.synthetic_mnist(num_samples=6, size=16, seed=4).images
    jmodel, tmodel = jv.HVAE(jc), tv.HVAE(tc)
    key = jax.random.PRNGKey(9)
    with jax.enable_x64(True):
        jr, jk = jax.jit(lambda p_, x_: jv.elbo_terms(
            jmodel.apply({"params": p_}, x_, key), jmodel.prior(jnp.float32),
            x_))(p, jnp.asarray(x))
        eps = np.array(jax.random.normal(key, (6, 3), jnp.float32))
        jiw = float(jv.iwae_bound(jmodel, p, jnp.asarray(x),
                                  jax.random.PRNGKey(3), k=4))
        keys = jax.random.split(jax.random.PRNGKey(3), 4)
        eps4 = np.stack([np.array(jax.random.normal(k_, (6, 3),
                                                    jnp.float32))
                         for k_ in keys])
    tp = tv.params_from_jax(p)
    tx = torch.as_tensor(x)
    tout = tmodel(tp, tx, eps=torch.as_tensor(eps))
    tr, tk = tv.elbo_terms(tout, tmodel.prior(), tx)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **STEP_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **STEP_TOL)
    tiw = float(tv.iwae_bound(tmodel, tp, tx, k=4,
                              eps=torch.as_tensor(eps4)))
    np.testing.assert_allclose(tiw, jiw, **STEP_TOL)
    # Jensen: the bound is at least the mean ELBO of the same K draws
    elbo = [torch.mean(torch.sub(*tv.elbo_terms(
        tmodel(tp, tx, eps=torch.as_tensor(e)), tmodel.prior(), tx)))
        for e in eps4]
    assert tiw >= float(torch.stack(elbo).mean())


def test_adam_matches_optax():
    rng = np.random.default_rng(1)
    p = {"a": {"kernel": rng.standard_normal((4, 3)).astype(np.float32),
               "bias": rng.standard_normal(3).astype(np.float32)}}
    opt = optax.adam(1e-3)
    jp, js = jax.tree_util.tree_map(jnp.asarray, p), None
    js = opt.init(jp)
    tp = tv.params_from_jax(p)
    topt = tv.make_optimizer(tv.HVAEConfig(lr=1e-3), tp)
    ts = topt.init(tp)
    for i in range(3):
        g = {"a": {k: (rng.standard_normal(v.shape) * 10.0 ** (i - 1))
                   .astype(np.float32) for k, v in p["a"].items()}}
        u, js = opt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = topt.update(tv.params_from_jax(g), ts, tp)
        tp = apply_updates(tp, tu)
        for k in p["a"]:
            np.testing.assert_allclose(tp["a"][k].numpy(),
                                       np.asarray(jp["a"][k]), rtol=0,
                                       atol=1e-6)


def test_bf16_policy_within_the_precision_budget():
    j, _jp, t, tst = _runs("poincare", "bf16", steps=5)
    assert np.all(np.isfinite(t))
    np.testing.assert_allclose(t[:, 0], j[:, 0], rtol=2e-2)
    for leaf in (tst.params["encoder"]["Conv_0"]["kernel"],
                 tst.opt_state.mu["decoder"]["Dense_1"]["kernel"]):
        assert leaf.dtype == torch.float32   # master params and moments


def test_policy_cast_helpers():
    x = torch.ones(3)
    ids = torch.arange(3)
    f32 = tprec.get_policy("f32")
    for fn in (f32.cast_compute, f32.cast_boundary, f32.cast_accum,
               f32.cast_param):
        assert fn(x) is x
    bf = tprec.get_policy("bf16")
    assert bf.cast_compute(x).dtype == torch.bfloat16
    assert bf.cast_compute(ids) is ids
    h = bf.cast_compute(x)
    for fn in (bf.cast_boundary, bf.cast_accum, bf.cast_param):
        assert fn(h).dtype == torch.float32
    assert bf.cast_accum(x) is x


def test_chunk_step_stacks_the_metrics_as_eager_steps():
    """``scan_chunk`` through ``train/loop.py`` (a loop on the CPU) gives
    the eager steps' metrics, stacked [K, 3]."""
    _, tc = _cfgs(**SMALL)
    x = torch.as_tensor(TM.synthetic_mnist(num_samples=16, size=16).images)
    m, opt, st = tv.init_model(tc, 0, "cpu")
    m2, opt2, st2 = tv.init_model(tc, 0, "cpu")
    eager = []
    for _ in range(3):
        st, *out = tv.train_step_sampled(m, opt, st, x)
        eager.append(torch.stack(out))
    chunk = loop.make_chunked_stepper(tv.chunk_step(m2, opt2), 3)
    st2, rows = chunk(st2, x)
    assert rows.shape == (3, 3)
    assert torch.equal(rows, torch.stack(eager))
    assert torch.equal(st2.params["decoder"]["Dense_0"]["kernel"],
                       st.params["decoder"]["Dense_0"]["kernel"])


def test_cli_hvae_prints_its_keys(tmp_path):
    buf = io.StringIO()
    log = str(tmp_path / "log.jsonl")
    with redirect_stdout(buf):
        assert tcli.main(["hvae", "device=cpu", "steps=3", "hidden=32",
                          "conv_features=8,16", "latent_dim=2",
                          "batch_size=8", f"log={log}",
                          "eval_every=1"]) == 0
    out = json.loads(buf.getvalue().splitlines()[-1])
    assert sorted(out) == ["iwae", "kl", "loss", "recon", "source",
                           "workload"]
    assert out["workload"] == "hvae" and out["source"] == "synthetic"
    assert all(np.isfinite(out[k]) for k in ("loss", "recon", "kl", "iwae"))
    assert len(open(log).read().splitlines()) == 3


def test_cli_hvae_reads_the_config_file():
    pairs = tcli.read_flat_yaml(os.path.join("configs", "hvae_mnist.yaml"))
    run, wl = tcli.split_overrides(pairs, tcli.RunConfig())
    assert run.steps == 800 and wl == {"latent_dim": "8",
                                       "batch_size": "128"}
    assert "hvae" in tcli.WORKLOADS

"""The port's sphere, product manifold and product-manifold embeddings
(``manifolds/sphere.py``, ``manifolds/product.py``,
``models/product_embed.py``, ``cli/train.py product``) against the JAX
package, on the CPU.

Every method gets the same numpy inputs on both sides, with the
curvature as a number and as a tensor: float64 under JAX's scoped
``enable_x64`` at rtol 1e-10, float32 at rtol 1e-5.  The embedder's
loss, gradients and step bodies run on given ids (the two packages draw
other batches from one seed) from one state handed over by
``state_from_jax``; float32 steps are compared with JAX run without x64,
so both take Adam's bias corrections in float32.  Near the initial
table the curvatures' gradients are ~1e-8 and cancel in float32, where
Adam's normalised step turns rounding into a visible difference, so the
float32 steps start from a table spread over the manifold.  Ranks must
be equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperspace_tpu.data.wordnet import synthetic_tree
from hyperspace_tpu.manifolds import Product as JProduct
from hyperspace_tpu.manifolds import Sphere as JSphere
from hyperspace_tpu.manifolds.base import reduce_health_stats as jreduce
from hyperspace_tpu.models import product_embed as J
from hyperspace_torch.cli import train as tcli
from hyperspace_torch.manifolds import Product as TProduct
from hyperspace_torch.manifolds import Sphere as TSphere
from hyperspace_torch.manifolds.base import reduce_health_stats as treduce
from hyperspace_torch.models import product_embed as T

TIERS = {np.float64: dict(rtol=1e-10, atol=1e-12),
         np.float32: dict(rtol=1e-5, atol=1e-6)}
FACTORS = (("poincare", 4), ("sphere", 3), ("euclidean", 2))
DS = synthetic_tree(depth=3, branching=2)          # 15 nodes, 34 pairs
N = DS.num_nodes


def _close(got, want, dtype, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               err_msg=what, **TIERS[dtype])


def sphere_pts(rng, c, n, d):
    v = rng.standard_normal((n, d))
    return v / np.linalg.norm(v, axis=-1, keepdims=True) / np.sqrt(c)


def ball_pts(rng, c, n, d):
    v = rng.standard_normal((n, d))
    r = rng.uniform(0.05, 0.7, (n, 1)) / np.sqrt(c)
    return v / np.linalg.norm(v, axis=-1, keepdims=True) * r


def product_pts(rng, cs, n):
    return np.concatenate([ball_pts(rng, cs[0], n, 4),
                           sphere_pts(rng, cs[1], n, 3),
                           rng.standard_normal((n, 2)) * 0.5], axis=-1)


def sphere_tangent(rng, x, c):
    u = rng.standard_normal(x.shape) * 0.4
    return u - c * np.sum(x * u, -1, keepdims=True) * x


def product_tangent(rng, x, cs):
    u = rng.standard_normal(x.shape) * 0.3
    s = slice(4, 7)
    u[:, s] = sphere_tangent(rng, x[:, s], cs[1])
    return u


def _managers(kind, cs, dtype, tensor_c):
    jdt, tdt = jnp.dtype(dtype), torch.float64 if dtype is np.float64 \
        else torch.float32
    jc = [jnp.asarray(c, jdt) if tensor_c else c for c in cs]
    tc = [torch.tensor(c, dtype=tdt) if tensor_c else c for c in cs]
    if kind == "sphere":
        return JSphere(jc[1]), TSphere(tc[1])
    from hyperspace_tpu.manifolds import Euclidean as JE
    from hyperspace_tpu.manifolds import PoincareBall as JB
    from hyperspace_torch.manifolds import Euclidean as TE
    from hyperspace_torch.manifolds import PoincareBall as TB

    dims = [d for _, d in FACTORS]
    return (JProduct([JB(jc[0]), JSphere(jc[1]), JE()], dims),
            TProduct([TB(tc[0]), TSphere(tc[1]), TE()], dims))


def _inputs(kind, cs, seed):
    rng = np.random.default_rng(seed)
    if kind == "sphere":
        x, y = (sphere_pts(rng, cs[1], 6, 3) for _ in range(2))
        u, v = sphere_tangent(rng, x, cs[1]), sphere_tangent(rng, x, cs[1])
    else:
        x, y = (product_pts(rng, cs, 6) for _ in range(2))
        u, v = product_tangent(rng, x, cs), product_tangent(rng, x, cs)
    amb = rng.standard_normal(x.shape) * 0.8
    return x, y, u, v, amb


METHODS = {
    "proj": lambda m, x, y, u, v, a: m.proj(a),
    "proju": lambda m, x, y, u, v, a: m.proju(x, a),
    "check_point": lambda m, x, y, u, v, a: m.check_point(a),
    "dist": lambda m, x, y, u, v, a: m.dist(x, y),
    "sqdist": lambda m, x, y, u, v, a: m.sqdist(x, y),
    "expmap": lambda m, x, y, u, v, a: m.expmap(x, u),
    "logmap": lambda m, x, y, u, v, a: m.logmap(x, y),
    "ptransp": lambda m, x, y, u, v, a: m.ptransp(x, y, u),
    "egrad2rgrad": lambda m, x, y, u, v, a: m.egrad2rgrad(x, a),
    "expmap0": lambda m, x, y, u, v, a: m.expmap0(
        m.proju(m.origin(x.shape, x.dtype), a)),
    "logmap0": lambda m, x, y, u, v, a: m.logmap0(y),
    "logdetexp": lambda m, x, y, u, v, a: m.logdetexp(x, y),
    "retr": lambda m, x, y, u, v, a: m.retr(x, u),
    "norm_t": lambda m, x, y, u, v, a: m.norm_t(x, u),
}


def _call(m, name, arrays, torch_side):
    if name == "inner":
        x, _, u, v, _ = arrays
        return m.inner(x, u, v, keepdim=True) if torch_side \
            else m.inner(x, u, v, keepdims=True)
    if name == "origin":
        x = arrays[0]
        return m.origin(tuple(x.shape), x.dtype)
    return METHODS[name](m, *arrays)


@pytest.mark.parametrize("tensor_c", [False, True], ids=["c-number",
                                                          "c-tensor"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["sphere", "product"])
@pytest.mark.parametrize("name", sorted(METHODS) + ["inner", "origin"])
def test_manifold_methods_match_jax(kind, name, dtype, tensor_c):
    cs = (0.8, 1.3)
    arrays = [a.astype(dtype) for a in _inputs(kind, cs, seed=len(name))]
    with jax.enable_x64(dtype is np.float64):
        jm, tm = _managers(kind, cs, dtype, tensor_c)
        want = np.asarray(_call(jm, name, [jnp.asarray(a) for a in arrays],
                                False))
    got = _call(tm, name, [torch.as_tensor(a) for a in arrays], True)
    assert got.dtype == torch.as_tensor(arrays[0]).dtype
    _close(got.numpy(), want, dtype, f"{kind}.{name}")


@pytest.mark.parametrize("kind", ["sphere", "product"])
def test_chart_and_health_match_jax(kind):
    cs = (0.8, 1.3)
    x, y, u, _, amb = _inputs(kind, cs, seed=7)
    with jax.enable_x64(True):
        jm, tm = _managers(kind, cs, np.float64, True)
        cd = jm.coord_dim(x.shape[-1])
        assert tm.coord_dim(x.shape[-1]) == cd
        coords = np.random.default_rng(3).standard_normal((6, cd)) * 0.4
        jt = jm.tangent_from_origin_coords(jnp.asarray(coords))
        tt = tm.tangent_from_origin_coords(torch.as_tensor(coords))
        _close(tt.numpy(), jt, np.float64, "tangent_from_origin_coords")
        _close(tm.origin_coords_from_tangent(tt).numpy(),
               jm.origin_coords_from_tangent(jt), np.float64, "back")
        _close(tm.logdetexp_from_coords(torch.as_tensor(coords)).numpy(),
               jm.logdetexp_from_coords(jnp.asarray(coords)), np.float64,
               "logdetexp_from_coords")
        want = jm.health_stats(jnp.asarray(x))
        got = tm.health_stats(torch.as_tensor(x))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].numpy(), want[k], np.float64, k)


def test_reduce_health_stats_matches_jax():
    groups = [{"norm_max": 0.3, "boundary_margin_min": 0.7,
               "violation_mean": 1e-4, "x": 2.0},
              {"norm_max": 0.9, "boundary_margin_min": 0.1,
               "violation_mean": 3e-4}]
    with jax.enable_x64(True):
        want = jreduce([{k: jnp.asarray(v) for k, v in g.items()}
                        for g in groups])
    got = treduce([{k: torch.tensor(v, dtype=torch.float64)
                    for k, v in g.items()} for g in groups])
    assert sorted(got) == sorted(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-15)


def _cfgs(dtype=np.float32, **kw):
    base = dict(num_nodes=N, factors=FACTORS, batch_size=16, neg_samples=5,
                burnin_steps=2)
    base.update(kw)
    return (J.ProductEmbedConfig(**base, dtype=jnp.dtype(dtype)),
            T.ProductEmbedConfig(**base, dtype=torch.float64
                                 if dtype is np.float64 else torch.float32))


def test_build_manifold_curvature_grad():
    jc, tc = _cfgs(np.float64)
    x = product_pts(np.random.default_rng(5), (1.0, 1.0), 4)
    c0 = np.array([0.3, -0.2])

    def jf(c_raw):
        m = J.build_manifold(jc, c_raw)
        xs = jnp.asarray(x)
        return jnp.sum(m.dist(xs[:2], xs[2:]))

    with jax.enable_x64(True):
        want = np.asarray(jax.grad(jf)(jnp.asarray(c0)))
    c = torch.tensor(c0, requires_grad=True)
    xs = torch.as_tensor(x)
    loss = torch.sum(T.build_manifold(tc, c).dist(xs[:2], xs[2:]))
    (got,) = torch.autograd.grad(loss, c)
    assert np.all(np.isfinite(got.numpy())) and np.abs(got.numpy()).sum() > 0
    _close(got.numpy(), want, np.float64, "d dist / d c_raw")


def test_random_normal_on_the_product():
    _, tc = _cfgs()
    m = T.build_manifold(tc, torch.tensor([0.3, -0.2]))
    x = m.random_normal(torch.Generator().manual_seed(0), (7, 9))
    assert x.shape == (7, 9)
    assert float(torch.max(m.check_point(x))) < 1e-5
    assert float(torch.max(m.split(x)[0].norm(dim=-1))) < 1 / float(
        m.factors[0].c) ** 0.5


def test_init_on_manifold():
    _, tc = _cfgs(num_nodes=32)
    state, _ = T.init_state(tc, seed=0, device="cpu")
    m = T.build_manifold(tc, state.params.c_raw)
    assert float(torch.max(m.check_point(state.params.table))) < 1e-5
    assert state.params.table.shape == (32, 9)
    assert T.curvatures(tc, state.params) == pytest.approx([1.0, 1.0])


def _ids(seed, b=16, k=5, collide=True):
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, N, b), rng.integers(0, N, b)
    neg = rng.integers(0, N, (b, k))
    if collide:                     # negatives equal to u and to v
        neg[0, 0], neg[1, 1], neg[2, :2] = u[0], v[1], u[2]
        v[3] = u[3]
    return u, v, neg


def _spread(jstate, seed, dtype):
    """The JAX state with its table spread over the manifold."""
    x = product_pts(np.random.default_rng(seed), (1.0, 1.0), N)
    table = jnp.asarray(x.astype(dtype))
    return jstate._replace(params=jstate.params._replace(table=table))


def _jax_step(jc, jopt, state, u, v, neg):
    """JAX's step body (``product_embed.py:_step_body``) on given ids."""
    loss, grads = jax.value_and_grad(J.loss_fn)(
        state.params, jc, jnp.asarray(u), jnp.asarray(v), jnp.asarray(neg))
    lr = jnp.where(state.step < jc.burnin_steps,
                   jc.lr_table * jc.burnin_factor, jc.lr_table)
    m = J.build_manifold(jc, state.params.c_raw)
    table = m.expmap(state.params.table,
                     -lr * m.egrad2rgrad(state.params.table, grads.table))
    cu, cs = jopt.update(grads.c_raw, state.curv_opt_state,
                         state.params.c_raw)
    c = optax.apply_updates(state.params.c_raw, cu)
    table = J.build_manifold(jc, c).proj(table)
    return J.TrainState(J.Params(table, c), cs, state.key,
                        state.step + 1), loss


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_loss_and_gradients_with_collisions(dtype):
    jc, tc = _cfgs(dtype)
    u, v, neg = _ids(1)
    with jax.enable_x64(dtype is np.float64):
        js, _ = J.init_state(jc, 0)
        js = _spread(js, 2, dtype)
        jl, jg = jax.jit(jax.value_and_grad(J.loss_fn), static_argnums=1)(
            js.params, jc, jnp.asarray(u), jnp.asarray(v), jnp.asarray(neg))
        jg = jax.tree_util.tree_map(np.asarray, jg)
    p = T.params_from_jax(js.params, "cpu")
    table = p.table.clone().requires_grad_()
    c_raw = p.c_raw.clone().requires_grad_()
    loss = T.loss_fn(T.Params(table, c_raw), tc,
                     *(torch.as_tensor(a) for a in (u, v, neg)))
    gt, gc = torch.autograd.grad(loss, (table, c_raw))
    assert torch.all(torch.isfinite(gt)) and torch.all(torch.isfinite(gc))
    _close(float(loss.detach()), float(jl), dtype, "loss")
    np.testing.assert_allclose(gt.numpy(), jg.table, rtol=TIERS[dtype][
        "rtol"], atol=1e-5 if dtype is np.float32 else 1e-12)
    _close(gc.numpy(), jg.c_raw, dtype, "d loss / d c_raw")


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_step_bodies_match_jax(dtype, steps):
    """Table, c_raw, the curvatures' Adam count and moments, and each
    loss after 1 and 3 steps from one state on the same ids (the burn-in
    ends after step 2)."""
    jc, tc = _cfgs(dtype)
    with jax.enable_x64(dtype is np.float64):
        js, jopt = J.init_state(jc, 0)
        js = _spread(js, 4, dtype)
        ts = T.state_from_jax(tc, js, device="cpu")
        topt = T.make_curv_optimizer(tc)
        for i in range(steps):
            u, v, neg = _ids(10 + i)
            js, jl = _jax_step(jc, jopt, js, u, v, neg)
            ts, tl = T.step_on_batch(tc, topt, ts, *(torch.as_tensor(a)
                                                     for a in (u, v, neg)))
            _close(float(tl), float(jl), dtype, f"loss {i}")
        adam = js.curv_opt_state[0]
    _close(ts.params.table.numpy(), js.params.table, dtype, "table")
    _close(ts.params.c_raw.numpy(), js.params.c_raw, dtype, "c_raw")
    _close(ts.curv_opt_state.mu.numpy(), adam.mu, dtype, "mu")
    _close(ts.curv_opt_state.nu.numpy(), adam.nu, dtype, "nu")
    assert int(ts.curv_opt_state.count) == int(adam.count) == steps
    assert int(ts.step) == int(js.step) == steps


def test_burnin_switch_at_burnin_steps():
    """The table's rate is lr·burnin_factor while step < burnin_steps and
    lr from step == burnin_steps on: a zero curvature rate isolates the
    table's step, whose length scales with the rate."""
    _, tc = _cfgs(np.float64, lr_curv=0.0, burnin_steps=3,
                  burnin_factor=0.1)
    state, opt = T.init_state(tc, 0, device="cpu")
    ids = [torch.as_tensor(a) for a in _ids(3, collide=False)]
    moves = []
    for step in (2, 3):
        st = state._replace(step=torch.tensor(step))
        new, _ = T.step_on_batch(tc, opt, st, *ids)
        m = T.build_manifold(tc, st.params.c_raw)
        moves.append(float(torch.max(m.dist(st.params.table,
                                            new.params.table))))
    assert moves[1] == pytest.approx(10 * moves[0], rel=1e-3)


def test_rank_chunk_and_evaluate_equal_jax():
    jc, tc = _cfgs(np.float64)
    with jax.enable_x64(True):
        js, _ = J.init_state(jc, 0)
        js = _spread(js, 6, np.float64)
        u, v = jnp.asarray(DS.pairs[:, 0]), jnp.asarray(DS.pairs[:, 1])
        want = np.asarray(J._rank_chunk(jc, js.params, u, v))
        want_eval = J.evaluate(jc, js.params, DS.pairs, batch=7)
    p = T.params_from_jax(js.params, "cpu")
    got = T._rank_chunk(tc, p, torch.as_tensor(DS.pairs[:, 0]),
                        torch.as_tensor(DS.pairs[:, 1]))
    np.testing.assert_array_equal(got.numpy(), want)
    got_eval = T.evaluate(tc, p, DS.pairs, batch=7)
    assert got_eval.keys() == want_eval.keys()
    for k in want_eval:
        assert got_eval[k] == pytest.approx(want_eval[k], rel=1e-12)


def test_trains_and_curvature_moves():
    """JAX's ``test_product_embed_trains_and_curvature_moves`` on the
    port: 800 steps on the depth-3 tree; on the manifold, the loss
    falls, a curvature moves, MAP > 0.8."""
    _, tc = _cfgs(batch_size=64, neg_samples=8, burnin_steps=20,
                  lr_table=0.5, lr_curv=5e-3)
    state, opt = T.init_state(tc, seed=0, device="cpu")
    pairs = torch.as_tensor(DS.pairs, dtype=torch.int64)
    c0 = T.curvatures(tc, state.params)
    losses = []
    for _ in range(800):
        state, loss = T.train_step(tc, opt, state, pairs)
        losses.append(loss)
    m = T.build_manifold(tc, state.params.c_raw)
    assert float(torch.max(m.check_point(state.params.table))) < 1e-3
    assert float(losses[-1]) < float(losses[0])
    c1 = T.curvatures(tc, state.params)
    assert any(abs(a - b) > 1e-4 for a, b in zip(c0, c1)), (c0, c1)
    res = T.evaluate(tc, state.params, DS.pairs)
    assert res["map"] > 0.8, res


def test_cli_product_from_the_yaml(tmp_path, capsys):
    """``configs/product_multihost.yaml`` (``multihost: false``) through
    the CLI at a cut step count, from a closure TSV on disk and from the
    synthetic tree; ``factors`` as JSON."""
    tsv = tmp_path / "closure.tsv"
    tsv.write_text("".join(f"n{u}\tn{v}\n" for u, v in DS.pairs))
    yaml = os.path.join("configs", "product_multihost.yaml")
    log = tmp_path / "log.jsonl"
    assert tcli.main(["product", "--yaml", yaml, "device=cpu", "steps=40",
                      f"data_root={tsv}", "batch_size=32", "eval_every=10",
                      f"log={log}"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out) == ["curvatures", "map", "mean_rank", "workload"]
    assert out["workload"] == "product" and len(out["curvatures"]) == 2
    assert 0.0 < out["map"] <= 1.0 and out["mean_rank"] >= 1.0
    recs = [json.loads(s) for s in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [10, 20, 30, 40]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert tcli.main(["product", "device=cpu", "steps=4", "batch_size=8",
                      'factors=[["poincare", 3], ["euclidean", 2]]']) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["curvatures"]) == 1
    with pytest.raises(SystemExit, match="accum>1 is wired for"):
        tcli.main(["product", "device=cpu", "steps=2", "accum=2"])

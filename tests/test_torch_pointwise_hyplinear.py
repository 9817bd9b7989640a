"""The port's row-wise Poincaré ops (``kernels/pointwise.py``), its fused
gyro-linear layer (``kernels/hyplinear.py``) and the layers on top
(``nn.HypLinear``, ``nn.HypAct``) against the JAX package, on the CPU
(the kernels' plain versions).

The JAX side runs its Pallas kernels in interpret mode
(``HYPERSPACE_KERNELS=interpret``) where a test says so, else its twins;
float64 runs under JAX's scoped ``enable_x64``.

Tolerances:
- row-wise ops against JAX's kernels (f32, interpret): rtol 2e-4, atol
  2e-5, JAX's own tier for these kernels (log-form against library
  transcendentals); ``hyp_linear``: rtol = atol = 2e-4, JAX's own;
- against the twins in float64: rtol 1e-10, and the gradients through
  the Function against JAX's ``custom_vjp`` (∂r and ∂c included): rtol
  1e-10;
- bf16 inputs: 2e-2, JAX's own bf16 tier (8 significant bits);
- layers and the slice's stack (f32, from the same flax parameters):
  rtol 1e-5, atol 1e-6; gradients atol 1e-5 (two f32 backward passes).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperspace_tpu.kernels import hyplinear as JHL
from hyperspace_tpu.kernels import pointwise as JPW
from hyperspace_tpu.manifolds import PoincareBall as JB
from hyperspace_tpu.nn import layers as JNL
from hyperspace_torch import kernels as TK
from hyperspace_torch.kernels import hyplinear as THL
from hyperspace_torch.manifolds import PoincareBall as TB
from hyperspace_torch.nn import HypAct, HypLinear
from hyperspace_torch.nn.layers import params_from_flax
from hyperspace_torch.optim.adamw import AdamW

CURVATURES = [1.0, 0.5, 2.3]
SHAPES = [(4, 2), (40, 10), (130, 7), (9, 128), (17, 200)]
OPS = ["mobius_add", "mobius_scalar_mul", "expmap", "logmap", "expmap0",
       "logmap0", "ptransp"]


@pytest.fixture
def interp(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_KERNELS", "interpret")


def ball_points(rng, shape, c, scale=0.8):
    """JAX's kernel tests' points: strictly inside the ball."""
    v = rng.standard_normal(shape)
    v = v / (1.0 + np.linalg.norm(v, axis=-1, keepdims=True))
    return v * scale / np.sqrt(c)


def op_args(rng, op, shape, c):
    """The op's tensor arguments (numpy) and its scalar r (or None)."""
    x = ball_points(rng, shape, c)
    y = ball_points(rng, shape, c, scale=0.5)
    v = rng.standard_normal(shape) * 0.3
    return {"mobius_add": ([x, y], None),
            "mobius_scalar_mul": ([x], 0.7),
            "expmap": ([x, v], None), "logmap": ([x, y], None),
            "expmap0": ([v], None), "logmap0": ([y], None),
            "ptransp": ([x, y, v], None)}[op]


def call(mod, op, tensors, c, r):
    fn = getattr(mod, op)
    return fn(r, *tensors, c) if op == "mobius_scalar_mul" else fn(*tensors,
                                                                   c)


@pytest.mark.parametrize("c", CURVATURES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", OPS)
def test_rowwise_matches_jax_kernel(interp, op, shape, c):
    rng = np.random.default_rng(sum(shape) + int(10 * c))
    tensors, r = op_args(rng, op, shape, c)
    tensors = [t.astype(np.float32) for t in tensors]
    want = np.asarray(call(JPW, op, [jnp.asarray(t) for t in tensors], c, r))
    got = call(TK, op, [torch.as_tensor(t) for t in tensors], c, r)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("r", [-1.5, 0.0, 0.5, 3.0])
def test_mobius_scalar_mul_matches_jax_kernel(interp, r):
    rng = np.random.default_rng(2)
    x = ball_points(rng, (33, 6), 0.7).astype(np.float32)
    want = np.asarray(JPW.mobius_scalar_mul(r, jnp.asarray(x), 0.7))
    got = TK.mobius_scalar_mul(r, torch.as_tensor(x), 0.7)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("op", OPS)
def test_rowwise_f64_values_and_gradients_match_jax(op):
    """Values against JAX's twin and gradients through the Function
    against JAX's custom_vjp, to every tensor, to a tensor c and to a
    tensor r."""
    rng = np.random.default_rng(11)
    c = 0.8
    tensors, r = op_args(rng, op, (6, 5), c)
    with jax.enable_x64(True):
        jt = [jnp.asarray(t) for t in tensors]
        twin = np.asarray(getattr(JPW, f"_t_{op}")(
            *([jt[0], r] if op == "mobius_scalar_mul" else jt), c))
        w = np.random.default_rng(3).standard_normal(twin.shape)

        def loss(cc, rr, *zs):
            return jnp.sum(jnp.tanh(call(JPW, op, list(zs), cc, rr)) * w)

        argnums = (0,) + ((1,) if r is not None else ()) + tuple(
            range(2, 2 + len(jt)))
        jg = jax.grad(loss, argnums=argnums)(
            jnp.asarray(c), None if r is None else jnp.asarray(r), *jt)
    tt = [torch.as_tensor(t).requires_grad_() for t in tensors]
    tc = torch.tensor(c, dtype=torch.float64, requires_grad=True)
    tr = torch.tensor(r, dtype=torch.float64, requires_grad=True) \
        if r is not None else None
    got = call(TK, op, tt, tc, tr)
    np.testing.assert_allclose(got.detach().numpy(), twin, rtol=1e-10,
                               atol=1e-12)
    wrt = [tc] + ([tr] if tr is not None else []) + tt
    tg = torch.autograd.grad(torch.sum(torch.tanh(got) * torch.as_tensor(w)),
                             wrt)
    assert len(tg) == len(jg)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)


def test_rowwise_broadcasting_and_leading_dims(interp):
    rng = np.random.default_rng(4)
    x = ball_points(rng, (3, 8, 6), 1.0).astype(np.float32)
    b = ball_points(rng, (6,), 1.0, scale=0.2).astype(np.float32)
    want = np.asarray(JPW.mobius_add(jnp.asarray(x), jnp.asarray(b), 1.0))
    got = TK.mobius_add(torch.as_tensor(x), torch.as_tensor(b), 1.0)
    assert got.shape == (3, 8, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    v = (rng.standard_normal((8, 6)) * 0.3).astype(np.float32)
    want = np.asarray(JPW.ptransp(jnp.asarray(x), jnp.asarray(b),
                                  jnp.asarray(v), 1.0))
    got = TK.ptransp(torch.as_tensor(x), torch.as_tensor(b),
                     torch.as_tensor(v), 1.0)
    assert got.shape == (3, 8, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_rowwise_broadcast_gradients_reduce_like_jax():
    rng = np.random.default_rng(5)
    x = ball_points(rng, (4, 3, 5), 1.0)
    b = ball_points(rng, (5,), 1.0, scale=0.3)
    with jax.enable_x64(True):
        jg = jax.grad(lambda z, bb: jnp.sum(JPW.mobius_add(z, bb, 1.0) ** 3),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
    tx = torch.as_tensor(x).requires_grad_()
    tb = torch.as_tensor(b).requires_grad_()
    tg = torch.autograd.grad(torch.sum(TK.mobius_add(tx, tb, 1.0) ** 3),
                             (tx, tb))
    for a, w in zip(tg, jg):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-10)


@pytest.mark.parametrize("first", [np.float32, "bfloat16"])
def test_rowwise_output_dtype_follows_first_input(interp, first):
    rng = np.random.default_rng(6)
    x = ball_points(rng, (16, 8), 1.0).astype(np.float32)
    y = ball_points(rng, (16, 8), 1.0).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if first == "bfloat16" else jnp.float32)
    jy = jnp.asarray(y, jnp.float32 if first == "bfloat16" else jnp.bfloat16)
    want = JPW.mobius_add(jx, jy, 1.0)
    tx = torch.as_tensor(x).to(torch.bfloat16 if first == "bfloat16"
                               else torch.float32)
    ty = torch.as_tensor(y).to(torch.float32 if first == "bfloat16"
                               else torch.bfloat16)
    got = TK.mobius_add(tx, ty, 1.0)
    want_dt = torch.bfloat16 if first == "bfloat16" else torch.float32
    assert got.dtype == want_dt
    assert str(want.dtype) == str(want_dt).replace("torch.", "")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_bf16_rowwise_computes_like_jax(interp):
    rng = np.random.default_rng(7)
    x = ball_points(rng, (16, 8), 1.0).astype(np.float32)
    v = (rng.standard_normal((16, 8)) * 0.3).astype(np.float32)
    for op, args in (("expmap", (x, v)), ("logmap0", (x,))):
        want = call(JPW, op, [jnp.asarray(a, jnp.bfloat16) for a in args],
                    1.0, None)
        got = call(TK, op, [torch.as_tensor(a).to(torch.bfloat16)
                            for a in args], 1.0, None)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=2e-2,
                                   atol=2e-2)


def test_rowwise_launch_counts_untouched_on_the_cpu():
    before = {op: getattr(TK, op).launches for op in OPS}
    TK.expmap0(torch.zeros(3, 4), 1.0)
    assert {op: getattr(TK, op).launches for op in OPS} == before


# --- hyp_linear -------------------------------------------------------------


def linear_case(rng, n, d_in, d_out, c):
    x = ball_points(rng, (n, d_in), c)
    m = rng.standard_normal((d_in, d_out)) * 0.3
    b = ball_points(rng, (d_out,), c, scale=0.3)
    return x, m, b


@pytest.mark.parametrize("c", [1.0, 0.5])
@pytest.mark.parametrize("n,d_in,d_out", [(9, 10, 6), (64, 128, 128),
                                          (300, 33, 65), (256, 48, 32)])
def test_hyp_linear_matches_jax_kernel(interp, n, d_in, d_out, c):
    rng = np.random.default_rng(n + d_in)
    x, m, b = (a.astype(np.float32) for a in linear_case(rng, n, d_in, d_out,
                                                          c))
    want = np.asarray(JHL.hyp_linear(jnp.asarray(x), jnp.asarray(m),
                                     jnp.asarray(b), c))
    got = TK.hyp_linear(torch.as_tensor(x), torch.as_tensor(m),
                        torch.as_tensor(b), c)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_hyp_linear_zero_bias_zero_matvec_and_leading_dims(interp):
    rng = np.random.default_rng(8)
    x, m, b = (a.astype(np.float32) for a in linear_case(rng, 8, 10, 10, 1.0))
    zero = np.zeros(10, np.float32)
    want = np.asarray(JHL.hyp_linear(jnp.asarray(x), jnp.asarray(m),
                                     jnp.asarray(zero), 1.0))
    got = TK.hyp_linear(torch.as_tensor(x), torch.as_tensor(m),
                        torch.as_tensor(zero), 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    got = TK.hyp_linear(torch.as_tensor(x), torch.zeros((10, 4)),
                        torch.as_tensor(b[:4]), 1.0)    # M x = 0 → b
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(b[:4], (8, 4)),
                               rtol=1e-5, atol=1e-6)
    x3 = ball_points(rng, (3, 5, 10), 1.0).astype(np.float32)
    want = np.asarray(JHL.hyp_linear(jnp.asarray(x3), jnp.asarray(m),
                                     jnp.asarray(b), 1.0))
    got = TK.hyp_linear(torch.as_tensor(x3), torch.as_tensor(m),
                        torch.as_tensor(b), 1.0)
    assert got.shape == (3, 5, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    big = TK.hyp_linear(torch.as_tensor(x), 10.0 * torch.as_tensor(m),
                        torch.as_tensor(b), 1.0)
    assert float(torch.linalg.norm(big, dim=-1).max()) < 1.0


def test_hyp_linear_f64_values_and_gradients_match_jax():
    rng = np.random.default_rng(9)
    x, m, b = linear_case(rng, 9, 10, 6, 0.7)
    with jax.enable_x64(True):
        args = [jnp.asarray(a) for a in (x, m, b)]
        twin = np.asarray(JHL._t_hyp_linear(*args, 0.7))
        jg = jax.grad(lambda *z: jnp.sum(jnp.tanh(JHL.hyp_linear(*z))),
                      argnums=(0, 1, 2, 3))(*args, jnp.asarray(0.7))
    tt = [torch.as_tensor(a).requires_grad_() for a in (x, m, b)]
    tc = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    got = TK.hyp_linear(*tt, tc)
    np.testing.assert_allclose(got.detach().numpy(), twin, rtol=1e-10,
                               atol=1e-12)
    tg = torch.autograd.grad(torch.sum(torch.tanh(got)), tt + [tc])
    for a, w in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)
    np.testing.assert_allclose(
        THL.hyp_linear_plain(*[torch.as_tensor(a) for a in (x, m, b)],
                             0.7).numpy(), twin, rtol=1e-10, atol=1e-12)


def test_hyp_linear_checks_shapes():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="want x"):
        TK.hyp_linear(x, torch.zeros((4, 2)), torch.zeros(2), 1.0)
    with pytest.raises(ValueError, match="want x"):
        TK.hyp_linear(x, torch.zeros((3, 2)), torch.zeros(3), 1.0)


# --- layers -----------------------------------------------------------------


def flax_params(module, x, seed=0):
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("c", [1.0, 0.5])
def test_hyp_linear_layer_matches_jax(use_bias, c):
    rng = np.random.default_rng(10)
    x = ball_points(rng, (40, 12), c).astype(np.float32)
    jl = JNL.HypLinear(features=7, manifold=JB(c), use_bias=use_bias)
    params = flax_params(jl, x)
    if use_bias:      # flax starts the bias at zero: move it off
        params["bias"] = (rng.standard_normal(7) * 0.2).astype(np.float32)
    want = np.asarray(jl.apply({"params": params}, jnp.asarray(x)))
    tl = HypLinear(12, 7, TB(c), use_bias=use_bias)
    tl.load_state_dict(params_from_flax(params))
    got = tl(torch.as_tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_hyp_act_matches_jax():
    rng = np.random.default_rng(12)
    x = ball_points(rng, (30, 9), 1.0).astype(np.float32)
    for act_j, act_t in ((jax.nn.relu, torch.relu), (jnp.tanh, torch.tanh)):
        ja = JNL.HypAct(JB(1.0), JB(0.5), act_j)
        want = np.asarray(ja.apply({}, jnp.asarray(x)))
        got = HypAct(TB(1.0), TB(0.5), act_t)(torch.as_tensor(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


class _JStack(fnn.Module):
    """The slice's stack: HypLinear(128) → HypAct(ball c = 1 → ball
    c = 0.5, relu) → HypLinear(32)."""
    width: int
    out: int

    @fnn.compact
    def __call__(self, x):
        h = JNL.HypLinear(self.width, JB(1.0))(x)
        h = JNL.HypAct(JB(1.0), JB(0.5), jax.nn.relu)(h)
        return JNL.HypLinear(self.out, JB(0.5))(h)


def torch_stack(d_in, width, out):
    return torch.nn.Sequential(HypLinear(d_in, width, TB(1.0)),
                               HypAct(TB(1.0), TB(0.5), torch.relu),
                               HypLinear(width, out, TB(0.5)))


def stack_state(params):
    """The flax stack's parameters as the Sequential's state_dict."""
    flat = params_from_flax(params)
    names = {"HypLinear_0": "0", "HypLinear_1": "2"}
    return {names[k.split(".")[0]] + "." + k.split(".", 1)[1]: v
            for k, v in flat.items()}


def test_slice_stack_matches_jax():
    """Forward, a regression loss (squared ball distance to targets at
    c = 0.5), its gradients, and three AdamW steps against optax."""
    rng = np.random.default_rng(13)
    n, d_in, width, out = 300, 128, 128, 32
    x = ball_points(rng, (n, d_in), 1.0, scale=0.5).astype(np.float32)
    tgt = ball_points(rng, (n, out), 0.5, scale=0.5).astype(np.float32)
    js = _JStack(width, out)
    params = flax_params(js, x, seed=1)
    params["HypLinear_0"]["bias"] = (rng.standard_normal(width)
                                     * 0.1).astype(np.float32)

    def jloss(p):
        y = js.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(JB(0.5).sqdist(y, jnp.asarray(tgt)))

    opt = optax.adamw(1e-2, weight_decay=1e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    jl, jg = jax.value_and_grad(jloss)(jp)
    jlosses = []
    for _ in range(3):
        lval, g = jax.value_and_grad(jloss)(jp)
        jlosses.append(float(lval))
        upd, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)

    model = torch_stack(d_in, width, out)
    model.load_state_dict(stack_state(params))
    tx, tt = torch.as_tensor(x), torch.as_tensor(tgt)

    def tloss():
        return torch.mean(TB(0.5).sqdist(model(tx), tt))

    loss = tloss()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want_g = stack_state(jax.tree_util.tree_map(np.asarray, jg))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-5, atol=1e-5)
    model.load_state_dict(stack_state(params))
    adam = AdamW(dict(model.named_parameters()), lr=1e-2, weight_decay=1e-4)
    tlosses = []
    for _ in range(3):
        for p in model.parameters():
            p.grad = None
        loss = tloss()
        loss.backward()
        adam.step()
        tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]

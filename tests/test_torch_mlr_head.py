"""``hyp_mlr`` at HGCN node classification's head, and its launch plan.

The plan (``kernels/mlr.py`` ``mlr_plan``) is replayed in numpy as
``csrc/mlr.cu`` walks it: blocks along the class chunks and along groups
of 16-row tiles, 8 warps a block, ``splits`` warps sharing a tile's
16-wide k slices.  For every (n, k, d) on a grid, each (row, class) logit
must be written exactly once and each slice of each tile summed exactly
once, and the block's shared memory must fit the H100's 227 KB of
dynamic shared memory.

The head itself against the JAX package on the CPU: ``LorentzMLR`` on
the 33-wide hyperboloid (ball d = 32) with ogbn-arxiv's 40 classes, as
``hyperspace_tpu/models/hgcn.py`` puts it on the encoder; values in f32
against JAX's kernel in interpret mode at rtol 2e-5 (the tier of
``tests/test_torch_attention_mlr.py``), gradients in f64 under JAX's
scoped ``enable_x64`` at rtol 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.kernels import mlr as JM
from hyperspace_tpu.manifolds import Lorentz as JL
from hyperspace_tpu.nn import mlr as JNM
from hyperspace_torch.kernels import mlr as TM
from hyperspace_torch.manifolds import Lorentz as TL
from hyperspace_torch.manifolds.maps import lorentz_to_ball
from hyperspace_torch.nn import mlr as TNM

NC_CLASSES, NC_BALL = 40, 32     # ogbn-arxiv's labels; hidden (128, 32)


def replay(plan, n, k, d):
    """(times each logit is written [n, k], times each (tile, slice) is
    summed in each chunk [chunks, tiles, slices]) by the kernel's blocks:
    (group, chunk) a block of 8 warps, ``splits`` warps a tile."""
    warps = TM.WARPS
    tiles, slices = -(-n // 16), max(1, -(-d // 16))
    per_block = warps // plan.splits
    cover = np.zeros((n, k), np.int64)
    depth = np.zeros((plan.chunks, tiles, slices), np.int64)
    for by in range(plan.chunks):
        c0 = by * plan.kc
        live = min(plan.kc, k - c0)
        for bx in range(-(-tiles // per_block)):
            for warp in range(warps):
                slot, part = divmod(warp, plan.splits)
                tile = bx * per_block + slot
                if tile >= tiles:
                    continue
                depth[by, tile, part::plan.splits] += 1
                if part == 0:
                    cover[tile * 16:tile * 16 + 16, c0:c0 + live] += 1
    return cover, depth


@pytest.mark.parametrize("d", [1, 16, 33, 200])
@pytest.mark.parametrize("k", [1, 8, 40, 65, 300])
@pytest.mark.parametrize("n", [1, 17, 129, 1003])
def test_mlr_plan_covers_every_logit_once(n, k, d):
    plan = TM.tile_plan(n, k, d)
    assert plan.tile
    assert plan.kc % 8 == 0 and 8 <= plan.kc <= TM.MAX_CHUNK
    assert plan.chunks == -(-k // plan.kc)
    assert plan.splits in (1, 2, 4, 8)
    assert plan.splits <= max(1, -(-d // 16))
    assert TM.mlr_pitch(d) % 32 == 16 and TM.mlr_pitch(d) >= d
    assert plan.smem == TM.mlr_smem(plan.kc, plan.splits, d)
    assert plan.smem <= TM.SMEM_CAP
    cover, depth = replay(plan, n, k, d)
    assert np.all(cover == 1), np.unique(cover)
    assert np.all(depth == 1)


@pytest.mark.parametrize("d", [64, 512, 1024, 1500, 1700])
@pytest.mark.parametrize("k", [1, 40, 1000])
@pytest.mark.parametrize("n", [2, 256, 169343])
def test_mlr_plan_fits_shared_memory(n, k, d):
    plan = TM.tile_plan(n, k, d)
    assert plan.smem <= TM.SMEM_CAP
    assert plan.kc * plan.chunks >= k > plan.kc * (plan.chunks - 1)


def test_mlr_plan_at_the_paths_shapes():
    # HGCN node classification: the tile kernel, one chunk of all 40
    # classes, a warp a tile
    nc = TM.mlr_plan(169343, NC_CLASSES, NC_BALL)
    assert nc.tile and (nc.kc, nc.chunks, nc.splits) == (40, 1, 1)
    # HyboNet's heads: the pair kernel, a warp a logit
    for shape in ((256, 8, 128), (2, 8, 64), (64, 4, 128)):
        assert TM.mlr_plan(*shape) == TM.PAIR
    # the tile kernel at few row tiles splits the depth across 8 warps
    assert TM.mlr_plan(1003, 40, 200).splits == 8
    wide = TM.mlr_plan(1003, 300, 33)
    assert (wide.kc, wide.chunks, wide.splits) == (64, 5, 2)
    # where the two plans cross on the card: the faster one at 4,096 and
    # 8,192 logits of 8 classes, 4,120 to 40,120 of 40 and 4,096 of 32
    for shape, tile in (((512, 8, 128), False), ((1024, 8, 128), True),
                        ((103, 40, 32), False), ((205, 40, 32), False),
                        ((1003, 40, 32), True), ((128, 32, 32), False)):
        assert TM.mlr_plan(*shape).tile == tile
    # rows too wide for the tiles take the pair kernel
    assert TM.tile_plan(5000, 40, 2000) is None
    assert TM.mlr_plan(5000, 40, 2000) == TM.PAIR


@pytest.fixture
def interp(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_KERNELS", "interpret")


def hyperboloid(rng, n, d, c=1.0, scale=0.6):
    sp = rng.standard_normal((n, d)) * scale
    t = np.sqrt(1.0 / c + np.sum(sp * sp, axis=-1, keepdims=True))
    return np.concatenate([t, sp], axis=-1)


def nc_case(rng, n):
    """Ball points from 33-wide hyperboloid points (the encoder's output
    mapped as LorentzMLR maps it), 40 hyperplanes and normals."""
    xb = lorentz_to_ball(torch.as_tensor(hyperboloid(rng, n, NC_BALL)),
                         1.0).numpy()
    v = rng.standard_normal((NC_CLASSES, NC_BALL))
    p = v / np.linalg.norm(v, axis=1, keepdims=True) * rng.uniform(
        0.0, 0.5, (NC_CLASSES, 1))
    a = rng.standard_normal((NC_CLASSES, NC_BALL)) * 0.3
    return xb, p, a


@pytest.mark.parametrize("n", [37, 64])
def test_hyp_mlr_matches_jax_kernel_at_the_nc_head(interp, n):
    rng = np.random.default_rng(n)
    x, p, a = (z.astype(np.float32) for z in nc_case(rng, n))
    want = np.asarray(JM.hyp_mlr(jnp.asarray(x), jnp.asarray(p),
                                 jnp.asarray(a), 1.0))
    got = TM.hyp_mlr(*(torch.as_tensor(z) for z in (x, p, a)), 1.0)
    assert got.shape == (n, NC_CLASSES)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


def test_hyp_mlr_gradients_match_jax_at_the_nc_head():
    rng = np.random.default_rng(5)
    x, p, a = nc_case(rng, 24)
    g_out = rng.standard_normal((24, NC_CLASSES))
    with jax.enable_x64(True):
        want = jax.grad(lambda *z: jnp.sum(JM.hyp_mlr(*z, 1.0) * g_out),
                        argnums=(0, 1, 2))(*[jnp.asarray(z) for z in
                                             (x, p, a)])
    ins = [torch.as_tensor(z).requires_grad_() for z in (x, p, a)]
    (TM.hyp_mlr(*ins, 1.0) * torch.as_tensor(g_out)).sum().backward()
    for t, w in zip(ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)


def lorentz_heads(rng):
    x = hyperboloid(rng, 50, NC_BALL).astype(np.float32)
    jmod = JNM.LorentzMLR(NC_CLASSES, JL(1.0))
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    params = jax.tree.map(np.asarray, params)
    # hyperplane points at ‖p‖ about 0.5 (λ_p about 2.7)
    params["p_tangent"] = (0.1 * rng.standard_normal(
        params["p_tangent"].shape)).astype(np.float32)
    tmod = TNM.LorentzMLR(NC_BALL, NC_CLASSES, TL(1.0))
    with torch.no_grad():
        for name, t in tmod.named_parameters():
            t.copy_(torch.as_tensor(np.array(params[name])))
    return x, jmod, params, tmod


def test_lorentz_mlr_matches_jax_at_the_nc_head(interp):
    x, jmod, params, tmod = lorentz_heads(np.random.default_rng(9))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    got = tmod(torch.as_tensor(x)).detach().numpy()
    assert got.shape == (50, NC_CLASSES)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_lorentz_mlr_gradients_match_jax_at_the_nc_head():
    x, jmod, params, tmod = lorentz_heads(np.random.default_rng(10))
    g_out = np.random.default_rng(11).standard_normal((50, NC_CLASSES))
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), params)

        def loss(pp, xx):
            return jnp.sum(jmod.apply({"params": pp}, xx) * g_out)

        gp, gx = jax.grad(loss, argnums=(0, 1))(p64, jnp.asarray(
            x, jnp.float64))
    tmod = tmod.double()
    xt = torch.as_tensor(x, dtype=torch.float64).requires_grad_()
    (tmod(xt) * torch.as_tensor(g_out)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-10,
                               atol=1e-12)
    for name, t in tmod.named_parameters():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gp[name]),
                                   rtol=1e-10, atol=1e-12)

"""Product-manifold embeddings with learned curvature — counterpart of
``hyperspace_tpu/models/product_embed.py`` (``BASELINE.json`` configs[4];
Gu et al. 2019).

A table of points on a product of a Poincaré ball, a sphere and a flat
factor (``cfg.factors``), trained on closure pairs with the ranking loss
of Nickel & Kiela, d² the sum of the factors' d².  The curvatures are
parameters: the manifold is rebuilt from ``softplus(c_raw)`` for the
loss, for the Riemannian SGD step on the table and for the re-projection
onto the new manifold after the curvatures' Adam step, all on the
device (0-dim tensors, no host read), so a CUDA graph captures the step
(``train/loop.py``).  The burn-in learning rate is chosen on the device
from the state's step count.

No hand kernel is on this path, as in JAX (where it is plain XLA): the
factors' maps are the manifolds' own methods.  The curvatures take
``optax.adam(lr_curv)``: :func:`optim.radam.riemannian_adam` with one
Euclidean leaf, plain Adam with its count on the device.  Batch rows and
negatives are drawn from the state's ``torch.Generator`` (other draws
than JAX's key for the same seed); :func:`step_on_batch` takes them
given.  ``make_sharded_step`` (the multi-host mesh) is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from hyperspace_torch import precision as precision_mod
from hyperspace_torch.kernels._support import resolve_device
from hyperspace_torch.manifolds import Euclidean, PoincareBall, Product, Sphere
from hyperspace_torch.models.poincare_embed import rank_metrics
from hyperspace_torch.optim.common import apply_updates
from hyperspace_torch.optim.radam import RAdamState, riemannian_adam

FACTOR_KINDS = {"poincare": PoincareBall, "sphere": Sphere,
                "euclidean": Euclidean}


@dataclasses.dataclass(frozen=True)
class ProductEmbedConfig:
    num_nodes: int = 0
    # (kind, ambient dim) a factor; the curvature is learned where curved
    factors: tuple = (("poincare", 5), ("sphere", 5), ("euclidean", 2))
    init_c: float = 1.0
    lr_table: float = 0.3
    lr_curv: float = 1e-2
    neg_samples: int = 10
    batch_size: int = 256
    burnin_steps: int = 50
    burnin_factor: float = 0.05
    init_scale: float = 1e-2
    dtype: Any = torch.float32
    # validated only: the table is a master parameter and the step is all
    # boundary math, so "bf16" computes exactly as "f32" by design
    precision: str = "f32"

    @property
    def total_dim(self) -> int:
        return sum(d for _, d in self.factors)

    @property
    def num_curved(self) -> int:
        return sum(1 for k, _ in self.factors if k != "euclidean")


def build_manifold(cfg: ProductEmbedConfig, c_raw: torch.Tensor) -> Product:
    """The product with curvatures ``softplus(c_raw)``: 0-dim tensors on
    ``c_raw``'s device, differentiable in ``c_raw``."""
    factors, i = [], 0
    for kind, _ in cfg.factors:
        if kind == "euclidean":
            factors.append(Euclidean())
        else:
            factors.append(FACTOR_KINDS[kind](
                torch.nn.functional.softplus(c_raw[i])))
            i += 1
    return Product(factors, [d for _, d in cfg.factors])


class Params(NamedTuple):
    table: torch.Tensor  # [N, total_dim] points on the product
    c_raw: torch.Tensor  # [num_curved] inverse-softplus curvatures


class TrainState(NamedTuple):
    params: Params
    curv_opt_state: Any              # RAdamState of the one Euclidean leaf
    generator: torch.Generator       # batch rows and negatives
    step: torch.Tensor               # 0-dim int64


def make_curv_optimizer(cfg: ProductEmbedConfig):
    """``optax.adam(lr_curv)`` on ``c_raw``."""
    return riemannian_adam(cfg.lr_curv, tags=None)


def init_state(cfg: ProductEmbedConfig, seed: int = 0, device="cuda"):
    """(state, curvature optimizer): ``c_raw`` at softplus⁻¹(init_c), the
    table the exp map at the origin of ``init_scale``-normal tangents;
    the table and every later draw come from one generator seeded from
    ``seed``."""
    precision_mod.get_policy(cfg.precision)  # validate the name early
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c_raw = torch.full((cfg.num_curved,), math.log(math.expm1(cfg.init_c)),
                       dtype=cfg.dtype, device=dev)
    m = build_manifold(cfg, c_raw)
    v = cfg.init_scale * torch.randn((cfg.num_nodes, cfg.total_dim),
                                     generator=gen, dtype=cfg.dtype,
                                     device=dev)
    table = m.expmap0(m.proju(m.origin(v.shape, cfg.dtype, dev), v))
    opt = make_curv_optimizer(cfg)
    state = TrainState(Params(table, c_raw), opt.init(c_raw), gen,
                       torch.zeros((), dtype=torch.int64, device=dev))
    return state, opt


def params_from_jax(jparams, device="cuda") -> Params:
    """:class:`Params` from JAX's (``table``, ``c_raw``), read with
    ``np.asarray``."""
    dev = resolve_device(device)
    return Params(*(torch.as_tensor(np.array(a), device=dev)
                    for a in (jparams.table, jparams.c_raw)))


def state_from_jax(cfg: ProductEmbedConfig, jstate, seed: int = 0,
                   device="cuda") -> TrainState:
    """The port's state from a JAX ``TrainState``: parameters, the
    curvatures' Adam count and moments, the step.  The JAX key is not
    carried; the generator is seeded from ``seed``."""
    dev = resolve_device(device)
    adam = jstate.curv_opt_state[0]
    t = lambda a: torch.as_tensor(np.array(a), device=dev)  # noqa: E731
    return TrainState(
        params_from_jax(jstate.params, dev),
        RAdamState(t(adam.count).to(torch.int64), t(adam.mu), t(adam.nu)),
        torch.Generator(device=dev).manual_seed(seed),
        t(jstate.step).to(torch.int64))


def loss_fn(params: Params, cfg: ProductEmbedConfig, u_idx: torch.Tensor,
            v_idx: torch.Tensor, neg_idx: torch.Tensor) -> torch.Tensor:
    """-log softmax(-d(u, ·))[v] over v and the negatives; negatives equal
    to u or v are masked with -inf (their distances are computed, and
    d(u, u) = 0 keeps a finite gradient through ``safe_sqrt``)."""
    m = build_manifold(cfg, params.c_raw)
    u = params.table[u_idx]
    cand = torch.cat([v_idx[:, None], neg_idx], dim=1)
    d = m.dist(u[:, None, :], params.table[cand])
    collide = (neg_idx == v_idx[:, None]) | (neg_idx == u_idx[:, None])
    mask = torch.cat([torch.zeros_like(collide[:, :1]), collide], dim=1)
    logits = torch.where(mask, float("-inf"), -d)
    return torch.mean(torch.logsumexp(logits, dim=1) - logits[:, 0])


@torch.no_grad()
def step_on_batch(cfg: ProductEmbedConfig, curv_opt, state: TrainState,
                  u_idx: torch.Tensor, v_idx: torch.Tensor,
                  neg_idx: torch.Tensor):
    """One step on given ids: the loss and its gradients in the table and
    ``c_raw``; Riemannian SGD on the table under the current manifold
    (the burn-in rate while ``step < burnin_steps``); Adam on ``c_raw``;
    the table re-projected onto the manifold of the new curvatures.
    Returns (state, loss)."""
    p = state.params
    with torch.enable_grad():
        table = p.table.detach().requires_grad_(True)
        c_raw = p.c_raw.detach().requires_grad_(True)
        loss = loss_fn(Params(table, c_raw), cfg, u_idx, v_idx, neg_idx)
        g_table, g_c = torch.autograd.grad(loss, (table, c_raw))
    lr = torch.where(
        state.step < cfg.burnin_steps,
        torch.full((), cfg.lr_table * cfg.burnin_factor, dtype=torch.float64,
                   device=p.table.device),
        torch.full((), cfg.lr_table, dtype=torch.float64,
                   device=p.table.device))
    m = build_manifold(cfg, p.c_raw)
    rg = m.egrad2rgrad(p.table, g_table)
    new_table = m.expmap(p.table, -lr * rg)
    c_upd, curv_state = curv_opt.update(g_c, state.curv_opt_state, p.c_raw)
    new_c = apply_updates(p.c_raw, c_upd)
    # the curvature step moves the manifold itself (the sphere's radius,
    # the ball's boundary): back onto the new one
    new_table = build_manifold(cfg, new_c).proj(new_table)
    return TrainState(Params(new_table, new_c), curv_state, state.generator,
                      state.step + 1), loss.detach()


def draw_batch(cfg: ProductEmbedConfig, generator: torch.Generator,
               pairs: torch.Tensor):
    """``batch_size`` closure pairs and ``neg_samples`` uniform negatives
    a row, drawn on ``pairs``' device: (u, v, neg)."""
    rows = torch.randint(0, pairs.shape[0], (cfg.batch_size,),
                         generator=generator, device=pairs.device)
    batch = pairs[rows]
    neg = torch.randint(0, cfg.num_nodes, (cfg.batch_size, cfg.neg_samples),
                        generator=generator, device=pairs.device)
    return batch[:, 0], batch[:, 1], neg


def train_step(cfg: ProductEmbedConfig, curv_opt, state: TrainState,
               pairs: torch.Tensor):
    """One step on a batch drawn from ``pairs`` [P, 2] (int64, on the
    table's device) by the state's generator."""
    u, v, neg = draw_batch(cfg, state.generator, pairs)
    return step_on_batch(cfg, curv_opt, state, u, v, neg)


def curvatures(cfg: ProductEmbedConfig, params: Params) -> list:
    """The learned curvatures as Python floats (one host read)."""
    return torch.nn.functional.softplus(params.c_raw).tolist()


# --- evaluation --------------------------------------------------------------


@torch.no_grad()
def _rank_chunk(cfg: ProductEmbedConfig, params: Params, u_idx: torch.Tensor,
                v_idx: torch.Tensor) -> torch.Tensor:
    """For each pair (u, v): 1 + the number of nodes strictly closer to u
    than v under the product distance, u and v not counted.  Broadcasts
    [B, N, dim] a factor."""
    m = build_manifold(cfg, params.c_raw)
    table = params.table
    d_all = m.dist(table[u_idx][:, None, :], table[None, :, :])
    d_pos = torch.gather(d_all, 1, v_idx[:, None])
    closer = (d_all < d_pos).to(torch.int32)
    rows = torch.arange(u_idx.shape[0], device=u_idx.device)
    closer[rows, u_idx] = 0
    closer[rows, v_idx] = 0
    return torch.sum(closer, dim=1) + 1


def evaluate(cfg: ProductEmbedConfig, params: Params, pairs,
             batch: int = 1024) -> dict:
    """Mean rank and MAP over the closure pairs (the Poincaré embeddings'
    protocol), ranks in chunks of ``batch`` pairs, read back once."""
    pairs = np.asarray(pairs)
    p = torch.as_tensor(pairs, dtype=torch.int64, device=params.table.device)
    ranks = torch.cat([_rank_chunk(cfg, params, p[s:s + batch, 0],
                                   p[s:s + batch, 1])
                       for s in range(0, len(pairs), batch)])
    return rank_metrics(pairs, ranks.cpu().numpy())

"""HGCN link prediction on the Lorentz model (counterpart of
``hyperspace_tpu/models/hgcn.py``).

    features --exp0--> manifold --[HGCConv × L]--> embeddings z
    LP head: Fermi–Dirac(d²(z_u, z_v)) → binary cross-entropy → ROC-AUC

The training step is :func:`train_step_lp_pairs`: every train positive
scored with both decoder gradient scatters sorted
(``nn.edge_dist.pair_sqdist_planned``) plus one corrupt-v negative per
positive with a static sorted u column (``pair_sqdist_semi_planned``),
then one AdamW update with global-norm clipping, exactly
``optax.chain(clip_by_global_norm, adamw)``.

PyTorch idiom: the model is an ``nn.Module`` that owns its parameters
and the step updates them in place; randomness (init, negatives,
dropout) comes from explicit ``torch.Generator``s.  Not ported yet:
``train_step_lp``/``train_step_lp_planned``, node classification, the
sharded steps, rematerialisation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from hyperspace_torch import precision as precision_lib
from hyperspace_torch.data import graphs as graph_data
from hyperspace_torch.kernels.segment import build_csr_plan
from hyperspace_torch.kernels._support import resolve_device
from hyperspace_torch.nn.decoders import FermiDiracDecoder
from hyperspace_torch.nn.edge_dist import (pair_sqdist_planned,
                                           pair_sqdist_semi_planned)
from hyperspace_torch.nn.gcn import HGCConv, from_tangent0_coords, \
    make_manifold
from hyperspace_torch.utils import metrics as metrics_lib


@dataclasses.dataclass(frozen=True)
class HGCNConfig:
    feat_dim: int = 32
    hidden_dims: Sequence[int] = (64, 16)
    kind: str = "lorentz"
    c: float = 1.0
    learn_c: bool = False
    use_att: bool = False
    dropout: float = 0.0
    lr: float = 1e-2
    weight_decay: float = 5e-4
    clip_norm: float = 0.0          # > 0: clip the global gradient norm
    neg_per_pos: int = 1
    dtype: torch.dtype = torch.float32
    agg_dtype: Optional[torch.dtype] = None      # edge-message dtype
    decoder_dtype: Optional[torch.dtype] = None  # training decoder pass
    precision: str = "f32"

    def resolved_agg_dtype(self):
        """agg_dtype as executed: the explicit field, else the policy's
        compute dtype when mixed, else None (= dtype)."""
        return precision_lib.resolved_lane_dtype(self.agg_dtype,
                                                 self.precision)

    def resolved_decoder_dtype(self):
        """decoder_dtype as executed (same rule)."""
        return precision_lib.resolved_lane_dtype(self.decoder_dtype,
                                                 self.precision)


def _identity(v: torch.Tensor) -> torch.Tensor:
    return v


class HGCNEncoder(nn.Module):
    """Feature lift (exp0) + stacked HGCConv layers, ``conv0``, ``conv1``…"""

    def __init__(self, cfg: HGCNConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d_in = cfg.feat_dim
        for i, d in enumerate(cfg.hidden_dims):
            is_last = i == len(cfg.hidden_dims) - 1
            self.add_module(f"conv{i}", HGCConv(
                d_in, d, kind=cfg.kind, c_in=cfg.c, c_out=cfg.c,
                learn_c=cfg.learn_c, use_att=cfg.use_att,
                activation=_identity if is_last else torch.relu,
                dropout_rate=cfg.dropout,
                agg_dtype=cfg.resolved_agg_dtype(), dtype=cfg.dtype,
                generator=generator))
            d_in = d

    def forward(self, g: graph_data.DeviceGraph, *, deterministic=True,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        m = make_manifold(cfg.kind, cfg.c)
        h = from_tangent0_coords(m, g.x.to(cfg.dtype))
        for i in range(len(cfg.hidden_dims)):
            h, m = getattr(self, f"conv{i}")(h, g, deterministic=deterministic,
                                             generator=generator)
        return h, m


class PlannedPairs(NamedTuple):
    """Static supervision pairs with both-side scatter plans."""

    u: torch.Tensor         # [P] sorted
    v: torch.Tensor         # [P] aligned with u
    u_plan: tuple
    v_perm: torch.Tensor    # [P] argsort of v
    v_sorted: torch.Tensor  # [P]
    v_plan: tuple


class HGCNLinkPred(nn.Module):
    """Encoder + Fermi–Dirac decoder.  ``forward(g, pairs)`` gives eval
    logits in full precision; :meth:`pair_logits` the training step's."""

    def __init__(self, cfg: HGCNConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = HGCNEncoder(cfg, generator)
        self.decoder = FermiDiracDecoder()

    def forward(self, g: graph_data.DeviceGraph, pairs: torch.Tensor, *,
                deterministic=True, generator=None) -> torch.Tensor:
        z, m = self.encoder(g, deterministic=deterministic,
                            generator=generator)
        ddt = self.cfg.resolved_decoder_dtype()
        if ddt is not None and not deterministic:
            z = z.to(ddt)  # train only; eval full precision
        sq = m.sqdist(z[pairs[:, 0]], z[pairs[:, 1]])
        return self.decoder(sq.to(self.cfg.dtype))

    def pair_logits(self, g: graph_data.DeviceGraph, pos: PlannedPairs,
                    neg_u: torch.Tensor, neg_v: torch.Tensor, neg_plan, *,
                    deterministic=True, generator=None):
        """(pos_logits [P], neg_logits [Q]) with every static scatter
        sorted (module doc)."""
        z, m = self.encoder(g, deterministic=deterministic,
                            generator=generator)
        ddt = self.cfg.resolved_decoder_dtype()
        if ddt is not None:
            z = z.to(ddt)
        kind = self.cfg.kind
        sq_pos = pair_sqdist_planned(z, m.c, pos.u, pos.v, pos.u_plan,
                                     pos.v_perm, pos.v_sorted, pos.v_plan,
                                     kind)
        sq_neg = pair_sqdist_semi_planned(z, m.c, neg_u, neg_v, neg_plan,
                                          kind)
        return (self.decoder(sq_pos.to(self.cfg.dtype)),
                self.decoder(sq_neg.to(self.cfg.dtype)))


# --- training ------------------------------------------------------------------


class AdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(lr, wd))`` by
    hand, in optax's order of operations: b1 0.9, b2 0.999, eps 1e-8
    outside the square root, decoupled decay on every parameter,
    ``max_norm = inf`` a no-op clip.  Parameters are taken in sorted name
    order, the order of the flax tree's leaves."""

    def __init__(self, named_params, lr: float, weight_decay: float,
                 max_norm: float = math.inf, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.names = sorted(named_params)
        self.params = [named_params[k] for k in self.names]
        self.lr, self.wd, self.max_norm = lr, weight_decay, max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads=None) -> None:
        """One update from ``grads`` (default: each parameter's
        ``.grad``), in place."""
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        trigger = g_norm < self.max_norm
        grads = [torch.where(trigger, g, (g / g_norm) * self.max_norm)
                 for g in grads]
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.wd * p
            p.add_(-self.lr * u)


def make_optimizer(cfg: HGCNConfig, model: nn.Module) -> AdamW:
    max_norm = cfg.clip_norm if cfg.clip_norm > 0.0 else math.inf
    return AdamW(dict(model.named_parameters()), cfg.lr, cfg.weight_decay,
                 max_norm)


@dataclasses.dataclass
class TrainState:
    """What a step carries besides the parameters (which the model owns):
    the generators of the negatives and of dropout, and the step count."""

    generator: torch.Generator
    dropout_generator: torch.Generator
    step: int = 0


def init_lp(cfg: HGCNConfig, g: graph_data.Graph, seed: int = 0,
            device="cuda"):
    """(model, optimizer, state) on ``device``: parameters from a CPU
    generator seeded with ``seed`` (the same on every device), step
    generators on the device."""
    dev = resolve_device(device)
    if cfg.learn_c or cfg.use_att:
        raise NotImplementedError("learn_c and use_att are not ported yet")
    del g  # shapes come from cfg; kept for the JAX signature
    init_gen = torch.Generator().manual_seed(seed)
    model = HGCNLinkPred(cfg, init_gen).to(dev)
    opt = make_optimizer(cfg, model)
    state = TrainState(
        generator=torch.Generator(device=dev).manual_seed(seed + 1),
        dropout_generator=torch.Generator(device=dev).manual_seed(seed + 2))
    return model, opt, state


def params_from_jax(tree) -> dict:
    """A ``state_dict`` for :class:`HGCNLinkPred` from the flax parameter
    tree ``{encoder: {conv0: {kernel, bias}, …}, decoder: {r, t_raw}}``
    (numpy arrays; kernels keep JAX's (d_in, d_out) layout)."""
    out = {}
    for conv, leaves in tree["encoder"].items():
        for name, a in leaves.items():
            if name not in ("kernel", "bias"):
                raise NotImplementedError(f"parameter {conv}/{name} is not "
                                          "ported yet")
            out[f"encoder.{conv}.{name}"] = torch.as_tensor(np.array(a))
    for name in ("r", "t_raw"):
        out[f"decoder.{name}"] = torch.as_tensor(
            np.array(tree["decoder"][name]))
    return out


def make_planned_pairs(pairs: np.ndarray, num_nodes: int,
                       device) -> PlannedPairs:
    """Host prep of a static pair set: sort by u with its CSR plan, and
    keep the static argsort of the aligned v column with its own plan."""
    pairs = np.asarray(pairs)
    order = np.argsort(pairs[:, 0], kind="stable")
    u = np.ascontiguousarray(pairs[order, 0]).astype(np.int32)
    v = np.ascontiguousarray(pairs[order, 1]).astype(np.int32)
    v_perm = np.argsort(v, kind="stable").astype(np.int32)
    v_sorted = v[v_perm]

    def to_dev(a):
        return torch.as_tensor(a, device=device)

    return PlannedPairs(
        u=to_dev(u), v=to_dev(v),
        u_plan=tuple(to_dev(a) for a in build_csr_plan(u, num_nodes)),
        v_perm=to_dev(v_perm), v_sorted=to_dev(v_sorted),
        v_plan=tuple(to_dev(a) for a in build_csr_plan(v_sorted, num_nodes)))


def make_static_negatives(num_nodes: int, n_neg: int, seed: int = 0,
                          device="cuda"):
    """The negatives' static sorted u column and its CSR plan (only v is
    redrawn each step)."""
    rng = np.random.default_rng(seed)
    u = np.sort(rng.integers(0, num_nodes, n_neg)).astype(np.int32)
    plan = tuple(torch.as_tensor(a, device=device)
                 for a in build_csr_plan(u, num_nodes))
    return torch.as_tensor(u, device=device), plan


def lp_loss(pos_logit: torch.Tensor, neg_logit: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy over positives (label 1) and
    negatives (label 0), as optax computes it."""
    bce_pos = nn.functional.softplus(-pos_logit)
    bce_neg = nn.functional.softplus(neg_logit)
    return ((torch.sum(bce_pos) + torch.sum(bce_neg))
            / (pos_logit.shape[0] + neg_logit.shape[0]))


def train_step_lp_pairs(model: HGCNLinkPred, opt: AdamW, num_nodes: int,
                        state: TrainState, g: graph_data.DeviceGraph,
                        pos: PlannedPairs, neg_u: torch.Tensor, neg_plan,
                        neg_v: Optional[torch.Tensor] = None):
    """One LP step: the train positives plus corrupt-v negatives
    (``neg_v`` drawn uniformly from ``state.generator`` unless given),
    loss, backward, one optimizer update in place.  Returns
    ``(state, loss)`` with the loss as a 0-dim tensor on the device."""
    if neg_u.shape[0] != pos.u.shape[0] * model.cfg.neg_per_pos:
        raise ValueError(
            f"neg_u has {neg_u.shape[0]} rows; cfg.neg_per_pos="
            f"{model.cfg.neg_per_pos} needs {pos.u.shape[0]} * neg_per_pos")
    if neg_v is None:
        neg_v = torch.randint(0, num_nodes, neg_u.shape,
                              generator=state.generator,
                              device=neg_u.device, dtype=torch.int32)
    for p in model.parameters():
        p.grad = None
    pos_logit, neg_logit = model.pair_logits(
        g, pos, neg_u, neg_v, neg_plan, deterministic=False,
        generator=state.dropout_generator)
    loss = lp_loss(pos_logit, neg_logit)
    loss.backward()
    opt.step()
    state.step += 1
    return state, loss.detach()


@torch.no_grad()
def eval_scores_lp(model: HGCNLinkPred, g: graph_data.DeviceGraph,
                   pairs: torch.Tensor) -> torch.Tensor:
    return model(g, pairs)


def evaluate_lp(model: HGCNLinkPred, split: graph_data.LinkSplit,
                which: str = "test", ga=None, device=None) -> dict:
    """LP ROC-AUC on the ``which`` split; pass ``ga`` to reuse a
    DeviceGraph already on the model's device."""
    dev = next(model.parameters()).device if device is None else device
    ga = graph_data.to_device(split.graph, dev) if ga is None else ga
    pos = graph_data.index_tensor(getattr(split, f"{which}_pos"), dev)
    neg = graph_data.index_tensor(getattr(split, f"{which}_neg"), dev)
    s_pos = eval_scores_lp(model, ga, pos).float().cpu().numpy()
    s_neg = eval_scores_lp(model, ga, neg).float().cpu().numpy()
    return {"roc_auc": metrics_lib.roc_auc(s_pos, s_neg)}

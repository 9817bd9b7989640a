"""HGCN link prediction and node classification on the Lorentz model
(counterpart of ``hyperspace_tpu/models/hgcn.py``).

    features --exp0--> manifold --[HGCConv × L]--> embeddings z
    LP head: Fermi–Dirac(d²(z_u, z_v)) → binary cross-entropy → ROC-AUC
    NC head: hyperbolic MLR → masked cross-entropy → accuracy / macro-F1

Three link-prediction steps, each a loss, its backward and one AdamW
update with global-norm clipping, exactly ``optax.chain(
clip_by_global_norm, adamw)`` (``optim.adamw.AdamW``):

- :func:`train_step_lp`, the CLI's: the train positives and as many
  uniform negative pairs drawn on the device, scored by
  :meth:`HGCNLinkPred.forward` on plain gathers (the backward of
  ``z[pairs]`` is PyTorch's accumulating ``index_put_``);
- :func:`train_step_lp_pairs`, the bench's: every train positive with
  both decoder gradient scatters sorted (``nn.edge_dist.
  pair_sqdist_planned``) plus one corrupt-v negative per positive with a
  static sorted u column (``pair_sqdist_semi_planned``);
- :func:`train_step_lp_planned`: the positives are the training graph's
  own edges (``nn.edge_dist.graph_edge_sqdist``, one sorted scatter for
  both endpoints), self-loops and padding weighted out, with the same
  corrupt-v negatives.

Node classification is full-batch (:func:`train_step_nc`): every node's
logits through ``LorentzMLR`` (``kernels/mlr.py:hyp_mlr`` on the ball
image of z, one launch a forward), softmax cross-entropy over the train
mask, the same optimizer.  With ``learn_c`` every layer learns its
output curvature (``nn.gcn.HGCConv``), the next layer, the decoder and
the MLR head take it as a 0-d device tensor, and it gets gradients from
all three.

PyTorch idiom: the model is an ``nn.Module`` that owns its parameters
and the step updates them in place; randomness (init, negatives,
dropout) comes from explicit ``torch.Generator``s.  Not ported yet: the
Euclidean and Poincaré encoders (and the Euclidean NC head), the sharded
steps, rematerialisation.
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
from hyperspace_torch.nn.edge_dist import (graph_edge_sqdist,
                                           pair_sqdist_planned,
                                           pair_sqdist_semi_planned)
from hyperspace_torch.nn.gcn import HGCConv, from_tangent0_coords, \
    make_manifold
from hyperspace_torch.nn.mlr import LorentzMLR
from hyperspace_torch.optim.adamw import AdamW
from hyperspace_torch.optim.common import step_counter
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
    num_classes: int = 0            # the NC head's classes
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
            # each layer reads its points at the previous layer's output
            # curvature (learned under learn_c)
            h, m = getattr(self, f"conv{i}")(h, g, c_in=m.c,
                                             deterministic=deterministic,
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
    """Encoder + Fermi–Dirac decoder.  ``forward(g, pairs)`` gives the
    logits of plain pairs (the decoder lane's dtype in training, full
    precision in evaluation); :meth:`pair_logits` and :meth:`edge_logits`
    the planned steps'."""

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

    def edge_logits(self, g: graph_data.DeviceGraph, neg_u: torch.Tensor,
                    neg_v: torch.Tensor, neg_plan, *, deterministic=True,
                    generator=None):
        """(pos_logits [E], pos_weight [E], neg_logits [Q]): positives on
        the graph's own edge list (:func:`graph_edge_sqdist`), weighted 0
        on self-loops and padding, negatives on (static sorted u, fresh
        v) pairs; every static scatter sorted."""
        if g.rev_perm is None:
            raise ValueError(
                "edge_logits needs a symmetric edge layout: build the graph "
                "with graphs.prepare(..., symmetrize=True) (rev_perm is None)")
        z, m = self.encoder(g, deterministic=deterministic,
                            generator=generator)
        ddt = self.cfg.resolved_decoder_dtype()
        if ddt is not None:
            z = z.to(ddt)  # a training method
        kind = self.cfg.kind
        sq_pos = graph_edge_sqdist(z, m.c, g.senders, g.receivers,
                                   g.rev_perm, g.plan, kind).to(
                                       self.cfg.dtype)
        # self-loops are degenerate positives (d = 0): weight them out
        w_pos = (g.edge_mask & (g.senders != g.receivers)).to(sq_pos.dtype)
        sq_neg = pair_sqdist_semi_planned(z, m.c, neg_u, neg_v, neg_plan,
                                          kind)
        return (self.decoder(sq_pos), w_pos,
                self.decoder(sq_neg.to(self.cfg.dtype)))


class HGCNNodeClf(nn.Module):
    """Encoder + ``LorentzMLR`` head ``head``: per-node class logits
    [N, num_classes].  JAX's ``euclidean`` control (a plain dense head)
    waits for the Euclidean encoder and raises, as the encoder does."""

    def __init__(self, cfg: HGCNConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.kind != "lorentz":
            raise NotImplementedError(
                f"node classification on the {cfg.kind!r} manifold is not "
                "ported yet (lorentz is)")
        if cfg.num_classes <= 0:
            raise ValueError("node classification needs num_classes > 0")
        self.cfg = cfg
        self.encoder = HGCNEncoder(cfg, generator)
        self.head = LorentzMLR(cfg.hidden_dims[-1], cfg.num_classes,
                               make_manifold(cfg.kind, cfg.c),
                               dtype=cfg.dtype, generator=generator)

    def forward(self, g: graph_data.DeviceGraph, *, deterministic=True,
                generator: Optional[torch.Generator] = None):
        z, m = self.encoder(g, deterministic=deterministic,
                            generator=generator)
        return self.head(z, m.c)


# --- training ----------------------------------------------------------------


def make_optimizer(cfg: HGCNConfig, model: nn.Module) -> AdamW:
    max_norm = cfg.clip_norm if cfg.clip_norm > 0.0 else math.inf
    return AdamW(dict(model.named_parameters()), cfg.lr, cfg.weight_decay,
                 max_norm)


@dataclasses.dataclass
class TrainState:
    """What a step carries besides the parameters (which the model owns):
    the generators of the negatives and of dropout, and the step count, a
    0-dim int64 tensor on the generators' device (a CUDA graph of the
    step advances it; a number given is made one)."""

    generator: torch.Generator
    dropout_generator: torch.Generator
    step: Optional[torch.Tensor] = None

    def __post_init__(self):
        self.step = step_counter(self.step, self.generator.device)


def init_lp(cfg: HGCNConfig, g: graph_data.Graph, seed: int = 0,
            device="cuda"):
    """(model, optimizer, state) on ``device``: parameters from a CPU
    generator seeded with ``seed`` (the same on every device), step
    generators on the device."""
    dev = resolve_device(device)
    del g  # shapes come from cfg; kept for the JAX signature
    init_gen = torch.Generator().manual_seed(seed)
    model = HGCNLinkPred(cfg, init_gen).to(dev)
    opt = make_optimizer(cfg, model)
    state = TrainState(
        generator=torch.Generator(device=dev).manual_seed(seed + 1),
        dropout_generator=torch.Generator(device=dev).manual_seed(seed + 2))
    return model, opt, state


def params_from_jax(tree) -> dict:
    """A ``state_dict`` for :class:`HGCNLinkPred` or :class:`HGCNNodeClf`
    from the flax parameter tree ``{encoder: {conv0: {kernel, bias[,
    att_src, att_dst][, c_raw]}, …}, decoder: {r, t_raw}}`` or
    ``{encoder: …, head: {p_tangent, a}}`` (numpy arrays; every leaf
    keeps JAX's layout: kernels (d_in, d_out), attention vectors
    (d_out, 1), the learned curvature's scalar ``c_raw``, the MLR's
    hyperplanes [K, d])."""
    out = {}
    for conv, leaves in tree["encoder"].items():
        for name, a in leaves.items():
            if name not in ("kernel", "bias", "att_src", "att_dst",
                            "c_raw"):
                raise NotImplementedError(f"parameter {conv}/{name} is not "
                                          "ported yet")
            out[f"encoder.{conv}.{name}"] = torch.as_tensor(np.array(a))
    heads = {"decoder": ("r", "t_raw"), "head": ("p_tangent", "a")}
    for part in tree:
        if part == "encoder":
            continue
        if part not in heads or set(tree[part]) != set(heads[part]):
            raise NotImplementedError(
                f"parameters {part}/{sorted(tree[part])} are not ported "
                "yet")
        for name in heads[part]:
            out[f"{part}.{name}"] = torch.as_tensor(
                np.array(tree[part][name]))
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


def _update(model: nn.Module, opt: AdamW, state: TrainState,
            loss: torch.Tensor):
    """Backward of ``loss`` into fresh gradients, one optimizer update in
    place; returns ``(state, loss)`` with the loss detached."""
    loss.backward()
    opt.step()
    state.step += 1
    return state, loss.detach()


def train_step_lp(model: HGCNLinkPred, opt: AdamW, num_nodes: int,
                  state: TrainState, g: graph_data.DeviceGraph,
                  train_pos: torch.Tensor,
                  neg: Optional[torch.Tensor] = None):
    """One LP step, the CLI's: ``train_pos`` [P, 2] and ``P ×
    neg_per_pos`` negative pairs (drawn on the device from
    ``state.generator`` unless ``neg`` is given) through
    :meth:`HGCNLinkPred.forward` in one batch, the mean binary
    cross-entropy, backward, one optimizer update in place.  Returns
    ``(state, loss)``, the loss a 0-dim device tensor."""
    n_pos = train_pos.shape[0]
    if neg is None:   # uniform pairs: an edge or a self-pair now and then
        neg = torch.randint(0, num_nodes, (n_pos * model.cfg.neg_per_pos, 2),
                            generator=state.generator,
                            device=train_pos.device, dtype=torch.int32)
    for p in model.parameters():
        p.grad = None
    logits = model(g, torch.cat([train_pos, neg.to(train_pos.dtype)]),
                   deterministic=False, generator=state.dropout_generator)
    return _update(model, opt, state, lp_loss(logits[:n_pos],
                                              logits[n_pos:]))


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
    return _update(model, opt, state, lp_loss(pos_logit, neg_logit))


def train_step_lp_planned(model: HGCNLinkPred, opt: AdamW, num_nodes: int,
                          state: TrainState, g: graph_data.DeviceGraph,
                          neg_u: torch.Tensor, neg_plan,
                          neg_v: Optional[torch.Tensor] = None):
    """One LP step with every decoder gradient scatter sorted: the
    positives are the graph's own edges (:meth:`HGCNLinkPred.
    edge_logits`, self-loops and padding weighted out), the negatives
    corrupt v of the static sorted ``neg_u`` (``neg_v`` drawn uniformly
    from ``state.generator`` unless given).  Returns ``(state, loss)``."""
    if neg_v is None:
        neg_v = torch.randint(0, num_nodes, neg_u.shape,
                              generator=state.generator,
                              device=neg_u.device, dtype=torch.int32)
    for p in model.parameters():
        p.grad = None
    pos_logit, w_pos, neg_logit = model.edge_logits(
        g, neg_u, neg_v, neg_plan, deterministic=False,
        generator=state.dropout_generator)
    bce_pos = nn.functional.softplus(-pos_logit)
    bce_neg = nn.functional.softplus(neg_logit)
    loss = ((torch.sum(bce_pos * w_pos) + torch.sum(bce_neg))
            / (torch.sum(w_pos) + neg_logit.shape[0]))
    return _update(model, opt, state, loss)


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


def train_lp(cfg: HGCNConfig, split: graph_data.LinkSplit, steps: int = 200,
             seed: int = 0, log_every: int = 0, device="cuda"):
    """Full LP training loop on :func:`train_step_lp`; returns (model,
    history): every ``log_every`` steps the loss and the validation
    ROC-AUC."""
    model, opt, state = init_lp(cfg, split.graph, seed, device)
    dev = next(model.parameters()).device
    ga = graph_data.to_device(split.graph, dev)
    train_pos = graph_data.index_tensor(split.train_pos, dev)
    history = []
    for i in range(steps):
        state, loss = train_step_lp(model, opt, split.graph.num_nodes, state,
                                    ga, train_pos)
        if log_every and (i + 1) % log_every == 0:
            ev = evaluate_lp(model, split, "val", ga=ga)
            history.append({"step": i + 1, "loss": float(loss), **ev})
    return model, history


# ---- node classification ----


def init_nc(cfg: HGCNConfig, g: graph_data.Graph, seed: int = 0,
            device="cuda"):
    """(model, optimizer, state) for node classification on ``device``,
    as :func:`init_lp` makes them (``state.dropout_generator`` the
    dropout's draws; ``state.generator`` unused)."""
    dev = resolve_device(device)
    del g  # shapes come from cfg; kept for the JAX signature
    model = HGCNNodeClf(cfg, torch.Generator().manual_seed(seed)).to(dev)
    opt = make_optimizer(cfg, model)
    state = TrainState(
        generator=torch.Generator(device=dev).manual_seed(seed + 1),
        dropout_generator=torch.Generator(device=dev).manual_seed(seed + 2))
    return model, opt, state


def nc_loss(logits: torch.Tensor, labels: torch.Tensor,
            train_mask: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy with integer labels, averaged over the
    masked nodes (at least one in the denominator)."""
    ce = nn.functional.cross_entropy(logits, labels.long(), reduction="none")
    w = train_mask.to(ce.dtype)
    return torch.sum(ce * w) / torch.clamp_min(torch.sum(w), 1.0)


def train_step_nc(model: HGCNNodeClf, opt: AdamW, state: TrainState,
                  g: graph_data.DeviceGraph, labels: torch.Tensor,
                  train_mask: torch.Tensor):
    """One full-batch NC step: logits of every node (dropout from
    ``state.dropout_generator``), the masked loss, backward, one
    optimizer update in place.  Returns ``(state, loss)``, the loss a
    0-dim device tensor."""
    for p in model.parameters():
        p.grad = None
    logits = model(g, deterministic=False,
                   generator=state.dropout_generator)
    return _update(model, opt, state, nc_loss(logits, labels, train_mask))


@torch.no_grad()
def eval_logits_nc(model: HGCNNodeClf,
                   g: graph_data.DeviceGraph) -> torch.Tensor:
    return model(g)


def evaluate_nc(model: HGCNNodeClf, g: graph_data.Graph,
                ga: Optional[graph_data.DeviceGraph] = None) -> dict:
    """Validation and test accuracy and test macro-F1; pass ``ga`` to
    reuse a DeviceGraph already on the model's device."""
    dev = next(model.parameters()).device
    ga = graph_data.to_device(g, dev) if ga is None else ga
    logits = eval_logits_nc(model, ga).float().cpu().numpy()
    return {
        "val_acc": metrics_lib.accuracy(logits, g.labels, g.val_mask),
        "test_acc": metrics_lib.accuracy(logits, g.labels, g.test_mask),
        "test_f1": metrics_lib.f1_macro(logits, g.labels,
                                        model.cfg.num_classes, g.test_mask),
    }


def nc_targets(g: graph_data.Graph, device):
    """The graph's labels (int64) and train mask as device tensors."""
    return (torch.as_tensor(np.asarray(g.labels), dtype=torch.int64,
                            device=device),
            torch.as_tensor(np.asarray(g.train_mask, bool), device=device))


def train_nc(cfg: HGCNConfig, g: graph_data.Graph, steps: int = 200,
             seed: int = 0, device="cuda"):
    """Full NC training loop; returns (model, results): the last loss and
    :func:`evaluate_nc`'s metrics."""
    model, opt, state = init_nc(cfg, g, seed, device)
    dev = next(model.parameters()).device
    ga = graph_data.to_device(g, dev)
    labels, tr = nc_targets(g, dev)
    loss = torch.tensor(math.nan)
    for _ in range(steps):
        state, loss = train_step_nc(model, opt, state, ga, labels, tr)
    return model, {"loss": float(loss), **evaluate_nc(model, g, ga=ga)}


def path_counters() -> list:
    """The launch counters of every kernel an LP or NC step reaches, in
    either arm (the segment and cluster kernels, ``hyp_mlr``)."""
    from hyperspace_torch.kernels import cluster, segment
    from hyperspace_torch.kernels.mlr import hyp_mlr

    return [segment.csr_segment_sum, segment.csr_segment_reduce_1d,
            segment.csr_att_bwd_edges, cluster.cluster_aggregate,
            cluster.cluster_att_fwd, cluster.cluster_att_bwd, hyp_mlr]

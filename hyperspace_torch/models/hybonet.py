"""HyboNet — the fully-hyperbolic Lorentz transformer for text
classification (counterpart of ``hyperspace_tpu/models/hybonet.py``;
Chen et al. ACL 2022).

    tokens ──(tangent embed + positional tangent)── exp₀ ──► points
    × L blocks:   x ← centroid(x, MHA(x))       (hyperbolic residual)
                  x ← centroid(x, FFN(x))       (2 × LorentzLinear)
    pool: masked Lorentz centroid over the sequence
    head: Lorentz MLR → class logits

The training step is :func:`train_step`: mean integer-label
cross-entropy, backward, one ``optax.adamw``-exact update (no clipping)
in place.  PyTorch idiom as in ``models/hgcn.py``: the model owns its
parameters, randomness comes from explicit ``torch.Generator``s.
:func:`train_step_sampled` draws its batch from ``state.generator``,
which gives other indices than ``jax.random.randint`` for the same seed;
parity with JAX goes through :func:`train_step` on given batches.
:func:`params_from_jax` maps a flax parameter tree onto the model.  Not
ported: the mesh-sharded step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from hyperspace_torch import precision as precision_lib
from hyperspace_torch.kernels._support import resolve_device
from hyperspace_torch.manifolds import Lorentz
from hyperspace_torch.nn.attention import HypMultiHeadAttention
from hyperspace_torch.nn.gcn import dropout, from_tangent0_coords
from hyperspace_torch.nn.layers import LorentzLinear, params_from_flax
from hyperspace_torch.nn.mlr import LorentzMLR
from hyperspace_torch.optim.adamw import AdamW
from hyperspace_torch.optim.common import step_counter
from hyperspace_torch.utils import metrics as metrics_lib


@dataclasses.dataclass(frozen=True)
class HyboNetConfig:
    vocab_size: int = 512
    num_classes: int = 4
    max_len: int = 32
    dim: int = 64            # manifold dim (ambient dim + 1)
    num_heads: int = 4
    num_layers: int = 2
    ffn_mult: int = 2
    c: float = 1.0
    lr: float = 1e-3
    weight_decay: float = 1e-4
    dropout: float = 0.0
    batch_size: int = 64
    # "flash" (default): kernels.attention.flash_attention, the CUDA
    # kernels on the card; "scan": the online-softmax KV loop
    attention_impl: str = "flash"
    dtype: torch.dtype = torch.float32
    # "bf16" runs the LorentzLinear and attention-projection matmuls in
    # bf16; parameters, time coordinates, centroids, the attention itself
    # and the MLR head stay f32
    precision: str = "f32"


class HyboNetBlock(nn.Module):
    def __init__(self, cfg: HyboNetConfig, manifold: Lorentz,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.manifold = manifold
        cdt = precision_lib.get_policy(cfg.precision).module_dtype()
        kw = dict(compute_dtype=cdt, dtype=cfg.dtype, generator=generator)
        d = cfg.dim + 1
        self.mha = HypMultiHeadAttention(d, cfg.dim, cfg.num_heads, manifold,
                                         impl=cfg.attention_impl, **kw)
        self.ffn_in = LorentzLinear(d, cfg.dim * cfg.ffn_mult, manifold,
                                    activation=torch.relu, **kw)
        self.ffn_out = LorentzLinear(cfg.dim * cfg.ffn_mult + 1, cfg.dim,
                                     manifold, **kw)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = self.manifold
        att_mask = mask[..., None, :] & mask[..., :, None]   # [B, L, L]
        a = self.mha(x, mask=att_mask)
        x = m.centroid(torch.stack([x, a], dim=-2))          # residual
        f = self.ffn_out(self.ffn_in(x))
        return m.centroid(torch.stack([x, f], dim=-2))


class HyboNetClassifier(nn.Module):
    """tokens [B, L] int, mask [B, L] bool → logits [B, num_classes]."""

    def __init__(self, cfg: HyboNetConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.manifold = Lorentz(cfg.c)
        self.tok_embed = nn.Parameter(0.02 * torch.randn(
            (cfg.vocab_size, cfg.dim), generator=generator, dtype=cfg.dtype))
        self.pos_embed = nn.Parameter(0.02 * torch.randn(
            (cfg.max_len, cfg.dim), generator=generator, dtype=cfg.dtype))
        for i in range(cfg.num_layers):
            self.add_module(f"block{i}", HyboNetBlock(cfg, self.manifold,
                                                      generator))
        self.head = LorentzMLR(cfg.dim, cfg.num_classes, self.manifold,
                               dtype=cfg.dtype, generator=generator)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg, m = self.cfg, self.manifold
        # F.embedding: its backward is the embedding backward (a sort and
        # segment sums), not indexing's accumulating index_put
        v = (nn.functional.embedding(tokens.long(), self.tok_embed)
             + self.pos_embed[None, :tokens.shape[-1]])
        if cfg.dropout > 0 and not deterministic:
            v = dropout(v, cfg.dropout, generator)
        x = from_tangent0_coords(m, v)              # [B, L, dim + 1]
        for i in range(cfg.num_layers):
            x = getattr(self, f"block{i}")(x, mask)
        pooled = m.centroid(x, mask.to(x.dtype))    # masked centroid pool
        return self.head(pooled)


# --- training ----------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """What a step carries besides the parameters (which the model owns):
    the batch sampler's and dropout's generators, and the step count, a
    0-dim int64 tensor on the generators' device (a CUDA graph of the
    step advances it; a number given is made one)."""

    generator: torch.Generator
    dropout_generator: torch.Generator
    step: Optional[torch.Tensor] = None

    def __post_init__(self):
        self.step = step_counter(self.step, self.generator.device)


def init_model(cfg: HyboNetConfig, seed: int = 0, device="cuda"):
    """(model, optimizer, state) on ``device``: parameters from a CPU
    generator seeded with ``seed`` (the same on every device), step
    generators on the device."""
    dev = resolve_device(device)
    model = HyboNetClassifier(cfg, torch.Generator().manual_seed(seed)).to(
        dev)
    opt = AdamW(dict(model.named_parameters()), cfg.lr, cfg.weight_decay)
    state = TrainState(
        generator=torch.Generator(device=dev).manual_seed(seed + 1),
        dropout_generator=torch.Generator(device=dev).manual_seed(seed + 2))
    return model, opt, state


def params_from_jax(tree) -> dict:
    """A ``state_dict`` for :class:`HyboNetClassifier` from the flax tree
    (``tok_embed``, ``pos_embed``, ``block{i}/mha/{q,k,v}_kernel``,
    ``beta``, ``tau_raw``, ``mha/out/{kernel,bias}``, ``ffn_in``,
    ``ffn_out``, ``head/{p_tangent,a}``): nested names joined by dots,
    kernels in JAX's (d_in, d_out) layout, every leaf float32."""
    return params_from_flax(tree, torch.float32)


def train_step(model: HyboNetClassifier, opt: AdamW, state: TrainState,
               tokens: torch.Tensor, mask: torch.Tensor,
               labels: torch.Tensor):
    """One step over a [B, L] batch: logits, mean cross-entropy against
    the integer labels, backward, one AdamW update in place.  Returns
    ``(state, loss)`` with the loss a 0-dim tensor on the device."""
    for p in model.parameters():
        p.grad = None
    logits = model(tokens, mask, deterministic=False,
                   generator=state.dropout_generator)
    loss = nn.functional.cross_entropy(logits, labels.long())
    loss.backward()
    opt.step()
    state.step += 1
    return state, loss.detach()


def train_step_sampled(model: HyboNetClassifier, opt: AdamW,
                       state: TrainState, toks: torch.Tensor,
                       mask: torch.Tensor, labels: torch.Tensor):
    """:func:`train_step` on ``batch_size`` rows drawn uniformly, with
    replacement, from ``state.generator`` (on the data's device).  These
    are other rows than ``jax.random.randint`` draws for the same seed."""
    idx = torch.randint(0, toks.shape[0], (model.cfg.batch_size,),
                        generator=state.generator, device=toks.device)
    return train_step(model, opt, state, toks[idx], mask[idx], labels[idx])


@torch.no_grad()
def eval_logits(model: HyboNetClassifier, tokens: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    return model(tokens, mask)


def train(cfg: HyboNetConfig, ds, steps: int = 200, seed: int = 0,
          device="cuda"):
    """``steps`` sampled minibatch steps over a TextDataset; returns
    (model, the loss of every step), the losses fetched once at the
    end."""
    model, opt, state = init_model(cfg, seed, device)
    data = [torch.as_tensor(a, device=state.generator.device)
            for a in (ds.tokens, ds.mask, ds.labels)]
    losses = [train_step_sampled(model, opt, state, *data)[1]
              for _ in range(steps)]
    return model, [float(x) for x in losses]


def evaluate(model: HyboNetClassifier, ds, batch: int = 256) -> dict:
    """Accuracy over a TextDataset, in batches of ``batch`` rows."""
    dev = next(model.parameters()).device
    outs = []
    for s in range(0, len(ds.labels), batch):
        t, m = (torch.as_tensor(a[s:s + batch], device=dev)
                for a in (ds.tokens, ds.mask))
        outs.append(eval_logits(model, t, m).float().cpu().numpy())
    return {"accuracy": metrics_lib.accuracy(np.concatenate(outs),
                                             ds.labels)}


def path_counters() -> list:
    """The launch counters of every kernel a training step reaches: the
    flash forward, dq, dk/dv and ``hyp_mlr``."""
    from hyperspace_torch.kernels import attention as A
    from hyperspace_torch.kernels.mlr import hyp_mlr

    return [A.flash_fwd, A.flash_dq, A.flash_dkv, hyp_mlr]

"""Hyperbolic VAE on MNIST with a wrapped-normal prior (counterpart of
``hyperspace_tpu/models/hvae.py``; Mathieu et al. 2019, Nagano et al.
2019):

    encoder (Euclidean conv) ─► (μ on the manifold by exp₀, σ)
    posterior  q(z|x) = WrappedNormal(μ, σ), reparameterised rsample
    prior      p(z)   = WrappedNormal(origin, 1)
    decoder    log₀(z) ─► dense ─► transposed convs ─► Bernoulli logits
    ELBO       E_q[log p(x|z)] − KL,  KL ≈ log q(z|x) − log p(z)

The latent lives on the ball (``kind="poincare"``) or the hyperboloid
(``"lorentz"``).  No hand kernel is on this path, as in JAX: the
manifold maps are the manifolds' plain methods (the step differentiates
through ``expmap``, ``ptransp0`` and ``logmap``), and the convolutions
and dense layers are cuDNN and cuBLAS calls, as they are XLA's in JAX.

PyTorch idiom, kept functional for CUDA graphs: the parameters are a
nested dict of tensors with flax's names and layouts (``{"encoder":
{"Conv_0": {"kernel" (kh, kw, in, out), "bias"}, …, "mu", "log_sigma"},
"decoder": {"Dense_0", "Dense_1", "ConvTranspose_0", …}}``; dense
kernels (in, out)), so :func:`params_from_jax` only converts arrays.
Layout: activations are NCHW; the encoder's flatten and the decoder's
reshape go through NHWC, as flax's do, so the dense kernels' row order
is JAX's.  flax's ``SAME``
padding is asymmetric at stride 2 — (0, 1) for the convs, (2, 1) on the
dilated input of the transposed convs — so the convs pad explicitly and
the transposed convs (flax does not flip their kernel) run
``conv_transpose2d`` on the flipped kernel and crop.

The optimiser is ``optax.adam``: :func:`optim.radam.riemannian_adam`
with every parameter tagged Euclidean, which is plain Adam with its step
count on the device (b1 0.9, b2 0.999, eps 1e-8, no decay).  Random
draws (batch ids, ε) come from the state's ``torch.Generator``; the steps
take ``idx=``/``eps=`` to replace them.  Under the ``f32`` policy the
convolutions run in float32 (cuDNN's TF32 off); with cuDNN's
``deterministic`` set by the caller a graphed chunk repeats the eager
steps bit for bit.  ``bf16`` runs the
conv and dense stacks in bfloat16 with parameters, the latent's
manifold maps, the densities and the loss reductions in float32.
``make_sharded_step`` is not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from hyperspace_torch import precision as precision_mod
from hyperspace_torch.kernels._support import resolve_device
from hyperspace_torch.manifolds import Lorentz, PoincareBall, smath
from hyperspace_torch.nn.wrapped_normal import WrappedNormal
from hyperspace_torch.optim.common import apply_updates
from hyperspace_torch.optim.radam import riemannian_adam
from hyperspace_torch.optim.tags import tags_from_names


@dataclasses.dataclass(frozen=True)
class HVAEConfig:
    image_size: int = 28
    latent_dim: int = 2  # manifold dimension of the latent
    hidden: int = 256
    conv_features: tuple = (32, 64)
    kind: str = "poincare"  # or "lorentz"
    c: float = 1.0
    lr: float = 1e-3
    batch_size: int = 128
    kl_weight: float = 1.0
    dtype: Any = torch.float32
    precision: str = "f32"


def latent_manifold(kind: str, c):
    """The latent geometry: ``PoincareBall(c)`` or ``Lorentz(c)``."""
    if kind == "poincare":
        return PoincareBall(c)
    if kind == "lorentz":
        return Lorentz(c)
    raise ValueError(f"unknown latent manifold kind {kind!r}")


# --- layers on JAX-layout parameters -----------------------------------------


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA ``SAME`` padding of a strided conv: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _transpose_pads(k: int, s: int) -> tuple[int, int]:
    """``lax.conv_transpose``'s ``SAME`` padding of the dilated input."""
    pad_len = k + s - 2
    lo = k - 1 if s > k - 1 else -(-pad_len // 2)
    return lo, pad_len - lo


def _cast(t: torch.Tensor, cdt) -> torch.Tensor:
    return t if cdt is None else t.to(cdt)


def dense(h: torch.Tensor, p: dict, cdt=None) -> torch.Tensor:
    """flax ``Dense``: ``h @ kernel + bias``, in ``cdt`` when given."""
    return _cast(h, cdt) @ _cast(p["kernel"], cdt) + _cast(p["bias"], cdt)


def conv(h: torch.Tensor, p: dict, stride: int = 2, cdt=None) -> torch.Tensor:
    """flax ``Conv`` at ``stride`` with ``SAME`` padding on NCHW ``h``;
    the kernel is flax's (kh, kw, in, out)."""
    k = p["kernel"]
    kh, kw = k.shape[0], k.shape[1]
    ph = _same_pads(h.shape[-2], kh, stride)
    pw = _same_pads(h.shape[-1], kw, stride)
    h = F.pad(_cast(h, cdt), (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(h, _cast(k.permute(3, 2, 0, 1), cdt),
                    _cast(p["bias"], cdt), stride=stride)


def conv_transpose(h: torch.Tensor, p: dict, stride: int = 2,
                   cdt=None) -> torch.Tensor:
    """flax ``ConvTranspose`` (``transpose_kernel=False``, ``SAME``) on
    NCHW ``h``: a stride-1 conv of the stride-dilated input padded by
    :func:`_transpose_pads`, computed as the full ``conv_transpose2d`` of
    the flipped kernel, cropped to ``n · stride`` (the full output is
    longer whenever stride ≤ kernel, as in this model)."""
    k = p["kernel"]                                  # (kh, kw, in, out)
    w = _cast(k.permute(2, 3, 0, 1).flip((2, 3)), cdt)
    y = F.conv_transpose2d(_cast(h, cdt), w, stride=stride)
    for axis, kk in ((2, k.shape[0]), (3, k.shape[1])):
        lo = kk - 1 - _transpose_pads(kk, stride)[0]
        y = y.narrow(axis, lo, h.shape[axis] * stride)
    return y + _cast(p["bias"], cdt)[:, None, None]


@contextlib.contextmanager
def f32_convolutions():
    """cuDNN convolutions in float32 (no TF32) for the span of the block
    (restored after), so the card computes what the CPU computes.  cuDNN's
    determinism is the caller's setting: a graphed chunk repeats the eager
    steps bit for bit under ``torch.backends.cudnn.deterministic``."""
    b = torch.backends.cudnn
    saved = b.allow_tf32
    b.allow_tf32 = False
    try:
        yield
    finally:
        b.allow_tf32 = saved


# --- the model ---------------------------------------------------------------


class Encoder:
    """x [B, H, W] ─► WrappedNormal posterior on the latent manifold."""

    def __init__(self, cfg: HVAEConfig):
        self.cfg = cfg

    def __call__(self, params: dict, x: torch.Tensor) -> WrappedNormal:
        cfg = self.cfg
        pol = precision_mod.get_policy(cfg.precision)
        cdt = pol.module_dtype()
        m = latent_manifold(cfg.kind, cfg.c)
        h = pol.cast_compute(x[:, None])                    # [B, 1, H, W]
        for i in range(len(cfg.conv_features)):
            h = torch.relu(conv(h, params[f"Conv_{i}"], cdt=cdt))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # flax's NHWC
        h = torch.relu(dense(h, params["Dense_0"], cdt))
        # the manifold side of the boundary: float32 before expmap0
        mu_t = pol.cast_boundary(dense(h, params["mu"], cdt))
        mu = m.expmap0(m.tangent_from_origin_coords(mu_t))
        log_sigma = pol.cast_boundary(dense(h, params["log_sigma"], cdt))
        sigma = torch.exp(smath.clip(log_sigma, -6.0, 2.0))
        return WrappedNormal(m, mu, sigma)


class Decoder:
    """z [..., D] on the latent manifold ─► Bernoulli logits [..., H, W]."""

    def __init__(self, cfg: HVAEConfig):
        self.cfg = cfg

    def __call__(self, params: dict, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        pol = precision_mod.get_policy(cfg.precision)
        cdt = pol.module_dtype()
        m = latent_manifold(cfg.kind, cfg.c)
        # leave the manifold once, in float32
        v = pol.cast_compute(m.origin_coords_from_tangent(m.logmap0(z)))
        s0 = cfg.image_size // (2 ** len(cfg.conv_features))
        f_top = cfg.conv_features[-1]
        lead = v.shape[:-1]
        h = torch.relu(dense(v, params["Dense_0"], cdt))
        h = torch.relu(dense(h, params["Dense_1"], cdt))
        h = h.reshape(-1, s0, s0, f_top).permute(0, 3, 1, 2)  # flax's NHWC
        n_up = len(cfg.conv_features)
        for j in range(n_up - 1):
            h = torch.relu(conv_transpose(h, params[f"ConvTranspose_{j}"],
                                          cdt=cdt))
        h = conv_transpose(h, params[f"ConvTranspose_{n_up - 1}"], cdt=cdt)
        h = h[:, 0, :cfg.image_size, :cfg.image_size]
        # logits leave in the accumulation dtype: the BCE/ELBO sums never
        # run in bf16
        return pol.cast_accum(h.reshape(lead + h.shape[1:]))


class HVAE:
    """``model(params, x, generator, eps=None) -> (q, z, logits)``."""

    def __init__(self, cfg: HVAEConfig):
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    def __call__(self, params: dict, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 eps: Optional[torch.Tensor] = None):
        q = self.encoder(params["encoder"], x)
        z = q.rsample(generator, eps=eps)
        return q, z, self.decoder(params["decoder"], z)

    def prior(self, dtype=torch.float32, device=None) -> WrappedNormal:
        cfg = self.cfg
        m = latent_manifold(cfg.kind, cfg.c)
        loc = m.origin((m.ambient_dim(cfg.latent_dim),), dtype, device)
        return WrappedNormal(m, loc, torch.ones((cfg.latent_dim,),
                                                dtype=dtype, device=device))


def elbo_terms(model_out, prior: WrappedNormal, x: torch.Tensor):
    """(recon [...], kl [...]): the Bernoulli log-likelihood of ``x``
    (optax's ``sigmoid_binary_cross_entropy``, summed over the pixels)
    and the one-sample KL estimate log q(z|x) − log p(z)."""
    q, z, logits = model_out
    recon = torch.sum(x * F.logsigmoid(logits)
                      + (1.0 - x) * F.logsigmoid(-logits), dim=(-2, -1))
    kl = q.log_prob(z) - prior.log_prob(z)
    return recon, kl


# --- parameters --------------------------------------------------------------


def _lecun_normal(shape, fan_in: int, generator: torch.Generator,
                  dtype) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at ±2σ, scaled to
    variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=dtype)
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


def init_params(cfg: HVAEConfig, generator: torch.Generator) -> dict:
    """Fresh parameters on the CPU, in flax's names, shapes and init."""
    dt = cfg.dtype

    def layer(shape, fan_in):
        return {"kernel": _lecun_normal(shape, fan_in, generator, dt),
                "bias": torch.zeros(shape[-1], dtype=dt)}

    enc, cin, s = {}, 1, cfg.image_size
    for i, f in enumerate(cfg.conv_features):
        enc[f"Conv_{i}"] = layer((3, 3, cin, f), 9 * cin)
        cin, s = f, -(-s // 2)
    enc["Dense_0"] = layer((s * s * cin, cfg.hidden), s * s * cin)
    enc["mu"] = layer((cfg.hidden, cfg.latent_dim), cfg.hidden)
    enc["log_sigma"] = layer((cfg.hidden, cfg.latent_dim), cfg.hidden)
    s0 = cfg.image_size // (2 ** len(cfg.conv_features))
    f_top = cfg.conv_features[-1]
    dec = {"Dense_0": layer((cfg.latent_dim, cfg.hidden), cfg.latent_dim),
           "Dense_1": layer((cfg.hidden, s0 * s0 * f_top), cfg.hidden)}
    cin = f_top
    outs = list(reversed(cfg.conv_features[:-1])) + [1]
    for j, f in enumerate(outs):
        dec[f"ConvTranspose_{j}"] = layer((3, 3, cin, f), 9 * cin)
        cin = f
    return {"encoder": enc, "decoder": dec}


def params_from_jax(tree) -> dict:
    """The port's parameters from the flax tree of ``init_model``'s
    state (numpy or JAX arrays): the same nesting, names and layouts,
    as float32 tensors on the CPU."""
    if hasattr(tree, "items"):
        return {k: params_from_jax(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, np.float32))


# --- training ----------------------------------------------------------------


class TrainState(NamedTuple):
    params: dict
    opt_state: Any                   # RAdamState with Euclidean tags
    generator: torch.Generator       # the steps' draws: batch ids, ε
    step: torch.Tensor               # 0-dim int64


def make_optimizer(cfg: HVAEConfig, params: dict):
    """``optax.adam(cfg.lr)``: Adam on every parameter, tagged Euclidean."""
    return riemannian_adam(cfg.lr,
                           tags=tags_from_names(params, lambda name: None))


def init_model(cfg: HVAEConfig, seed: int = 0, device="cuda",
               params: Optional[dict] = None):
    """(model, optimizer, state) on ``device``: parameters from a CPU
    generator seeded with ``seed`` (the same on every device) unless
    ``params`` are given, the step generator on the device."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(seed))
    params = pytree.tree_map(lambda t: t.to(dev).contiguous(), params)
    opt = make_optimizer(cfg, params)
    state = TrainState(params, opt.init(params),
                       torch.Generator(device=dev).manual_seed(seed + 1),
                       torch.zeros((), dtype=torch.int64, device=dev))
    return HVAE(cfg), opt, state


def _conv_context(x: torch.Tensor):
    return f32_convolutions() if x.device.type == "cuda" \
        else contextlib.nullcontext()


@torch.no_grad()
def train_step(model: HVAE, opt, state: TrainState, x: torch.Tensor, *,
               eps: Optional[torch.Tensor] = None):
    """One Adam step on the batch ``x`` [B, H, W], ε drawn from the
    state's generator unless given; returns (state, loss, recon, kl), the
    last three 0-dim device tensors."""
    if eps is None:
        eps = torch.randn((x.shape[0], model.cfg.latent_dim),
                          generator=state.generator, device=x.device)
    prior = model.prior(x.dtype, x.device)
    leaves, spec = pytree.tree_flatten(state.params)
    with torch.enable_grad(), _conv_context(x):
        live = [t.detach().requires_grad_(True) for t in leaves]
        out = model(pytree.tree_unflatten(live, spec), x, eps=eps)
        recon, kl = elbo_terms(out, prior, x)
        elbo = recon - model.cfg.kl_weight * kl
        loss = -torch.mean(elbo)
        grads = torch.autograd.grad(loss, live)
    grads = pytree.tree_unflatten(list(grads), spec)
    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    params = apply_updates(state.params, updates)
    return (TrainState(params, opt_state, state.generator, state.step + 1),
            loss.detach(), torch.mean(recon).detach(),
            torch.mean(kl).detach())


def train_step_sampled(model: HVAE, opt, state: TrainState,
                       x_all: torch.Tensor, *,
                       idx: Optional[torch.Tensor] = None,
                       eps: Optional[torch.Tensor] = None):
    """Like :func:`train_step`, the batch's ``batch_size`` ids drawn on
    the device from the state's generator (then ε), so the data
    iterator's state is the generator's and a CUDA graph can replay the
    step.  ``idx``/``eps`` replace the draws."""
    if idx is None:
        idx = torch.randint(0, x_all.shape[0], (model.cfg.batch_size,),
                            generator=state.generator, device=x_all.device)
    return train_step(model, opt, state, x_all[idx], eps=eps)


def chunk_step(model: HVAE, opt):
    """``(state, x_all) -> (state, [loss, recon, kl])``: the sampled step
    in the form ``train/loop.py``'s chunked stepper takes."""
    def step(state, x_all):
        state, loss, recon, kl = train_step_sampled(model, opt, state, x_all)
        return state, torch.stack([loss, recon, kl])

    return step


@torch.no_grad()
def iwae_bound(model: HVAE, params: dict, x: torch.Tensor,
               generator: Optional[torch.Generator] = None, k: int = 16, *,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The K-sample importance-weighted bound, mean over the batch:
    log (1/K) Σ_k p(x, z_k) / q(z_k | x).  ``eps`` [K, B, d] replaces the
    K draws."""
    prior = model.prior(x.dtype, x.device)
    with _conv_context(x):
        q = model.encoder(params["encoder"], x)
        z = q.rsample(generator, (k,), eps=eps)             # [K, B, D]
        logits = model.decoder(params["decoder"], z)
        recon, kl = elbo_terms((q, z, logits), prior, x)
    logw = recon - kl                                       # [K, B]
    return torch.mean(torch.logsumexp(logw, dim=0) - math.log(float(k)))


def train(cfg: HVAEConfig, images: np.ndarray, steps: int = 200,
          seed: int = 0, device="cuda"):
    """Minibatch loop; returns (model, state, last metrics)."""
    model, opt, state = init_model(cfg, seed, device)
    x_all = torch.as_tensor(np.asarray(images), dtype=cfg.dtype,
                            device=state.step.device)
    out = None
    for _ in range(steps):
        state, *out = train_step_sampled(model, opt, state, x_all)
    metrics = {} if out is None else dict(
        zip(("loss", "recon", "kl"), (float(t) for t in out)))
    return model, state, metrics

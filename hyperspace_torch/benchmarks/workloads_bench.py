"""Training throughput, the HyboNet and HVAE legs of
``hyperspace_tpu/benchmarks/workloads_bench.py``.

- ``hybonet``: vocabulary 8,192, 8 classes, L 128, dim 128, 4 heads,
  2 layers, batch 256, ``train_step_sampled`` over a 2,048-sample
  synthetic corpus (sequences of 64–128 tokens);
- ``hybonet_long``: L 4,096, dim 64, 2 heads, 1 layer, batch 2,
  ``train_step`` on a fixed batch (sequences of 4,095–4,096 tokens), the
  flash kernels in both directions at long context;
- ``hvae``: the hyperbolic VAE at its defaults (28 × 28 images, conv
  (32, 64), hidden 256, latent 2 on the ball) at batch 256,
  ``train_step_sampled`` over ``synthetic_mnist(num_samples=2048,
  seed=0)``; besides the step-by-step time, the per-step time of one
  chunk of ``scan_chunk_k`` sampled steps through ``train/loop.py``'s
  chunked stepper (a CUDA graph replayed on the card), the CLI's
  ``scan_chunk`` path.

    python -m hyperspace_torch.benchmarks.workloads_bench [--steps 10]
        [--repeats 3] [--device cuda]

prints one JSON object with a line per leg: ``step_ms`` (the least of
``repeats`` timed runs of ``steps`` steps, host clock ending in a
synchronise), ``tokens_per_s`` (batch × L / step time) or
``images_per_s`` (batch / step time), the shapes, the attention
implementation, the precision, the losses and the device.  The
product-space leg of the JAX bench waits for its model.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable

import torch

from hyperspace_torch.benchmarks.hgcn_bench import card_name
from hyperspace_torch.data.mnist import synthetic_mnist
from hyperspace_torch.data.text import synthetic_text
from hyperspace_torch.kernels._support import resolve_device
from hyperspace_torch.models import hvae, hybonet
from hyperspace_torch.train.loop import make_chunked_stepper

LEGS = {
    "hybonet": hybonet.HyboNetConfig(
        vocab_size=8192, num_classes=8, max_len=128, dim=128, num_heads=4,
        num_layers=2, batch_size=256),
    "hybonet_long": hybonet.HyboNetConfig(
        vocab_size=8192, num_classes=8, max_len=4096, dim=64, num_heads=2,
        num_layers=1, batch_size=2),
}


@dataclasses.dataclass
class Leg:
    """A leg's model and data on one device; :meth:`step` runs one
    training step and returns its loss (a device tensor)."""

    name: str
    cfg: hybonet.HyboNetConfig
    model: hybonet.HyboNetClassifier
    step: Callable[[], torch.Tensor]
    device: torch.device


def setup_leg(name: str, *, device="cuda", seed: int = 0,
              cfg: hybonet.HyboNetConfig | None = None) -> Leg:
    """The leg's config (``cfg`` overrides it), data and model on
    ``device``."""
    dev = resolve_device(device)
    cfg = LEGS[name] if cfg is None else cfg
    long = name == "hybonet_long"
    ds = synthetic_text(num_samples=4 if long else 2048,
                        vocab_size=cfg.vocab_size,
                        num_classes=cfg.num_classes, max_len=cfg.max_len,
                        min_len=cfg.max_len - 1 if long else cfg.max_len // 2,
                        seed=0)
    model, opt, state = hybonet.init_model(cfg, seed=seed, device=dev)
    toks, mask, labels = (torch.as_tensor(a, device=dev)
                          for a in (ds.tokens, ds.mask, ds.labels))
    if long:
        b = cfg.batch_size
        toks, mask, labels = toks[:b], mask[:b], labels[:b]
    run = hybonet.train_step if long else hybonet.train_step_sampled

    def step():
        nonlocal state
        state, loss = run(model, opt, state, toks, mask, labels)
        return loss

    return Leg(name, cfg, model, step, dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_leg(leg: Leg, steps: int = 10, repeats: int = 3,
            warmup: int = 1) -> dict[str, Any]:
    """Time ``repeats`` runs of ``steps`` steps after ``warmup`` untimed
    ones; the leg's line of the bench."""
    losses = [leg.step() for _ in range(warmup)]
    _sync(leg.device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        losses += [leg.step() for _ in range(steps)]
        _sync(leg.device)
        times.append(time.perf_counter() - t0)
    step_s = min(times) / steps
    cfg = leg.cfg
    return {
        "step_ms": step_s * 1e3,
        "tokens_per_s": cfg.batch_size * cfg.max_len / step_s,
        "batch": [cfg.batch_size, cfg.max_len], "dim": cfg.dim,
        "heads": cfg.num_heads, "layers": cfg.num_layers,
        "attention_impl": cfg.attention_impl, "precision": cfg.precision,
        "steps": steps, "repeats": repeats,
        "repeat_ms": [t / steps * 1e3 for t in times],
        "losses": [float(x) for x in losses],
        "device": str(leg.device),
        "card": card_name() if leg.device.type == "cuda" else None,
    }


HVAE_LEG = hvae.HVAEConfig(batch_size=256)
HVAE_IMAGES = 2048
SCAN_CHUNK_K = 32


@dataclasses.dataclass
class HVAELeg:
    """The HVAE leg's model, optimiser, state and images on one device."""

    cfg: hvae.HVAEConfig
    model: hvae.HVAE
    opt: Any
    state: hvae.TrainState
    x_all: torch.Tensor
    device: torch.device

    def step(self) -> torch.Tensor:
        self.state, loss, _recon, _kl = hvae.train_step_sampled(
            self.model, self.opt, self.state, self.x_all)
        return loss


def setup_hvae_leg(*, device="cuda", seed: int = 0,
                   cfg: hvae.HVAEConfig | None = None,
                   num_images: int = HVAE_IMAGES) -> HVAELeg:
    dev = resolve_device(device)
    cfg = HVAE_LEG if cfg is None else cfg
    ds = synthetic_mnist(num_samples=num_images, size=cfg.image_size,
                         seed=0)
    model, opt, state = hvae.init_model(cfg, seed=seed, device=dev)
    x_all = torch.as_tensor(ds.images, dtype=cfg.dtype, device=dev)
    return HVAELeg(cfg, model, opt, state, x_all, dev)


def run_hvae_leg(leg: HVAELeg, steps: int = 10, repeats: int = 3,
                 warmup: int = 1, chunk: int = SCAN_CHUNK_K) -> dict:
    """Step-by-step times as :func:`run_leg` takes them, then ``repeats``
    chunks of ``chunk`` graphed steps after one capturing chunk
    (``chunk`` 0: no chunk fields)."""
    losses = [leg.step() for _ in range(warmup)]
    _sync(leg.device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        losses += [leg.step() for _ in range(steps)]
        _sync(leg.device)
        times.append(time.perf_counter() - t0)
    step_s = min(times) / steps
    cfg = leg.cfg
    out = {
        "step_ms": step_s * 1e3,
        "images_per_s": cfg.batch_size / step_s,
        "batch": [cfg.batch_size, cfg.image_size, cfg.image_size],
        "kind": cfg.kind, "latent_dim": cfg.latent_dim,
        "precision": cfg.precision, "steps": steps, "repeats": repeats,
        "repeat_ms": [t / steps * 1e3 for t in times],
    }
    if chunk > 1:
        out.update(run_hvae_chunks(leg, chunk, repeats))
        out["scan_chunk_dispatch_overhead_ms"] = (
            out["step_ms"] - out["scan_chunk_step_ms"])
        losses += out.pop("losses")
    out.update({"losses": [float(x) for x in losses],
                "device": str(leg.device),
                "card": card_name() if leg.device.type == "cuda" else None})
    return out


def run_hvae_chunks(leg: HVAELeg, chunk: int = SCAN_CHUNK_K,
                    repeats: int = 3) -> dict:
    """``repeats`` timed chunks of ``chunk`` sampled steps after one
    capturing chunk: per-step ms and images/s of the fastest, every
    chunk's per-step ms, and the losses."""
    run = make_chunked_stepper(hvae.chunk_step(leg.model, leg.opt), chunk)
    leg.state, rows = run(leg.state, leg.x_all)          # captures
    losses = [float(x) for x in rows[:, 0]]
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        leg.state, rows = run(leg.state, leg.x_all)
        _sync(leg.device)
        times.append(time.perf_counter() - t0)
        losses += [float(x) for x in rows[:, 0]]
    scan_ms = min(times) / chunk * 1e3
    return {"scan_chunk_k": chunk, "scan_chunk_step_ms": scan_ms,
            "scan_chunk_images_per_s": leg.cfg.batch_size / (scan_ms / 1e3),
            "scan_chunk_repeat_ms": [t / chunk * 1e3 for t in times],
            "losses": losses}


def run_workloads_bench(steps: int = 10, repeats: int = 3, *,
                        device="cuda", seed: int = 0) -> dict[str, Any]:
    """Every leg; ``hybonet_long`` takes max(steps // 2, 3) steps a run,
    as the JAX bench does."""
    out = {}
    for name in LEGS:
        n = steps if name == "hybonet" else max(steps // 2, 3)
        out[name] = run_leg(setup_leg(name, device=device, seed=seed), n,
                            repeats)
    out["hvae"] = run_hvae_leg(setup_hvae_leg(device=device, seed=seed),
                               steps, repeats)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run_workloads_bench(args.steps, args.repeats,
                                         device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

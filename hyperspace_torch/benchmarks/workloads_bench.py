"""HyboNet training throughput, the two HyboNet legs of
``hyperspace_tpu/benchmarks/workloads_bench.py``.

- ``hybonet``: vocabulary 8,192, 8 classes, L 128, dim 128, 4 heads,
  2 layers, batch 256, ``train_step_sampled`` over a 2,048-sample
  synthetic corpus (sequences of 64–128 tokens);
- ``hybonet_long``: L 4,096, dim 64, 2 heads, 1 layer, batch 2,
  ``train_step`` on a fixed batch (sequences of 4,095–4,096 tokens), the
  flash kernels in both directions at long context.

    python -m hyperspace_torch.benchmarks.workloads_bench [--steps 10]
        [--repeats 3] [--device cuda]

prints one JSON object with a line per leg: ``step_ms`` (the least of
``repeats`` timed runs of ``steps`` steps, host clock ending in a
synchronise), ``tokens_per_s`` (batch × L / step time), the shapes, the
attention implementation, the precision, the losses and the device.  The
other legs of the JAX bench wait for their models.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable

import torch

from hyperspace_torch.benchmarks.hgcn_bench import card_name
from hyperspace_torch.data.text import synthetic_text
from hyperspace_torch.kernels._support import resolve_device
from hyperspace_torch.models import hybonet

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


def run_workloads_bench(steps: int = 10, repeats: int = 3, *,
                        device="cuda", seed: int = 0) -> dict[str, Any]:
    """Both legs; ``hybonet_long`` takes max(steps // 2, 3) steps a run,
    as the JAX bench does."""
    out = {}
    for name in LEGS:
        n = steps if name == "hybonet" else max(steps // 2, 3)
        out[name] = run_leg(setup_leg(name, device=device, seed=seed), n,
                            repeats)
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

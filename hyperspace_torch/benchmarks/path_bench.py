"""Gyro-linear layer step and two-stage exact batch on one card.

The two paths that launch ``hyp_linear`` and ``pdist``, at the sizes
``chip_smoke.py`` drives them, timed alone so that two checkouts can be
compared on one card in one run:

- ``gyro_layers``: HypLinear(128) on the ball c = 1 → HypAct(c 1 → 0.5,
  relu) → HypLinear(32) on 169,343 points at radius 0.8, mean squared
  distance to targets, AdamW; step ms on the host's clock after one
  warm-up step, device busy ms a step, idle share;
- ``two_stage``: :class:`QueryEngine` over 82,115 ball rows (10-dim,
  c = 1, the WordNet nouns' size) in the two-stage scan mode, batches of
  1,024 distinct ids never asked before through :class:`RequestBatcher`,
  k = 10; median batch ms and engine-call ms (each ending in the copy of
  the answer to the host), busy ms a batch, idle share, ``pdist``
  launches a batch.

Busy ms come from ``torch.profiler`` put on the card's clock
(:mod:`devtime`); ``kernel_ms`` is the busy time of the items whose name
holds the kernel's.  Prints one JSON object a leg.

    python -m hyperspace_torch.benchmarks.path_bench [--seed 0]
        [--steps 10] [--legs gyro_layers,two_stage]

To time another checkout's package with this file, put that checkout's
root first on ``PYTHONPATH`` and run the file by its path; ``package``
in the output names the package that was timed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

ROWS, DIM, C, BATCH, K = 82_115, 10, 1.0, 1024, 10
LAYER_ROWS, D_IN, WIDTH, D_OUT = 169_343, 128, 128, 32


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def busy(fn, wall_ms: float, kernel: str, reps: int) -> dict:
    """Device busy ms per call of ``fn``, its share of ``wall_ms`` left
    idle, and the busy ms of the items named after ``kernel``."""
    from hyperspace_torch.benchmarks.devtime import profile_window

    items, _, windows = profile_window(torch, fn, reps)
    total = sum(items.values())
    return {"busy_ms": total, "idle_share": 1.0 - total / wall_ms,
            "kernel_ms": sum(v for k, v in items.items() if kernel in k),
            "clock_checked": any(w["accepted"] for w in windows)}


def ball_points(gen, shape, c: float, radius: float) -> torch.Tensor:
    from hyperspace_torch.manifolds import PoincareBall

    v = torch.randn(shape, generator=gen, device=gen.device) * (
        radius / np.sqrt(shape[-1] * c))
    return PoincareBall(c).expmap0(v).contiguous()


def gyro_layers(seed: int, steps: int) -> dict:
    from hyperspace_torch import kernels as K_
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.nn import HypAct, HypLinear
    from hyperspace_torch.optim.adamw import AdamW

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = ball_points(gen, (LAYER_ROWS, D_IN), 1.0, 0.8)
    tgt = ball_points(gen, (LAYER_ROWS, D_OUT), 0.5, 0.5)
    b1, b2 = PoincareBall(1.0), PoincareBall(0.5)
    wgen = torch.Generator().manual_seed(seed)
    stack = torch.nn.Sequential(
        HypLinear(D_IN, WIDTH, b1, generator=wgen), HypAct(b1, b2, torch.relu),
        HypLinear(WIDTH, D_OUT, b2, generator=wgen)).to(dev)
    opt = AdamW(dict(stack.named_parameters()), lr=1e-2, weight_decay=1e-4)

    def step():
        for p in stack.parameters():
            p.grad = None
        loss = torch.mean(b2.sqdist(stack(x), tgt))
        loss.backward()
        opt.step()
        return loss.detach()

    first = float(step())                           # warm-up
    K_.hyp_linear.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = K_.hyp_linear.launches / steps
    return {"leg": "gyro_layers", "rows": LAYER_ROWS, "steps": steps,
            "step_ms": step_ms, "hyp_linear_launches_a_step": launches,
            "loss_first": first, "loss_last": float(losses[-1]),
            **busy(step, step_ms, "hyp_linear", 3)}


def two_stage(seed: int) -> dict:
    from hyperspace_torch.kernels.distmat import pdist
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.serve import QueryEngine, RequestBatcher

    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.standard_normal((ROWS, DIM)) * 0.5,
                        dtype=torch.float32)
    table = PoincareBall(C).expmap0(v).numpy()
    eng = QueryEngine(table, ("poincare", C), scan_mode="two_stage")
    batcher = RequestBatcher(eng)
    cold = rng.permutation(ROWS)[:40 * BATCH].reshape(40, BATCH)
    walls = {"engine": [], "batcher": []}
    for j, ids in enumerate(cold[:21]):
        t0 = time.perf_counter()
        i, d = eng.topk_neighbors(ids.astype(np.int32), K)
        i.cpu(), d.cpu()
        t1 = time.perf_counter()
        pdist.launches = 0
        batcher.topk(ids.tolist(), K)
        t2 = time.perf_counter()
        if j:                                          # after a warm-up
            walls["engine"].append(t1 - t0)
            walls["batcher"].append(t2 - t1)
    if batcher.stats()["cache_hit"]:
        raise AssertionError("a batch hit the cache")
    launches = pdist.launches
    med = float(np.median(walls["batcher"])) * 1e3
    more = iter(cold[21:])
    return {"leg": "two_stage", "rows": ROWS, "bucket": BATCH, "k": K,
            "batch_ms": med,
            "engine_ms": float(np.median(walls["engine"])) * 1e3,
            "pdist_launches_a_batch": launches,
            **busy(lambda: batcher.topk(next(more).tolist(), K), med,
                   "pdist", 5)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--legs", default="gyro_layers,two_stage")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("path_bench: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    import hyperspace_torch

    head = {"package": hyperspace_torch.__file__, "card": card_name()}
    for leg in args.legs.split(","):
        out = (gyro_layers(args.seed, args.steps) if leg == "gyro_layers"
               else two_stage(args.seed))
        emit({**head, **out})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

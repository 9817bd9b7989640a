"""Gyro-linear layer step, two-stage exact batch, IVF fused batch and HGCN
steps on one card.

The paths that launch ``hyp_linear``, ``pdist``, ``scan_topk_cand`` and
the cluster kernels, at the sizes ``chip_smoke.py`` drives them, timed
alone so that two checkouts can be compared on one card in one run:

- ``gyro_layers``: HypLinear(128) on the ball c = 1 → HypAct(c 1 → 0.5,
  relu) → HypLinear(32) on 169,343 points at radius 0.8, mean squared
  distance to targets, AdamW; step ms on the host's clock after one
  warm-up step, device busy ms a step, idle share;
- ``two_stage``: :class:`QueryEngine` over 82,115 ball rows (10-dim,
  c = 1, the WordNet nouns' size) in the two-stage scan mode, batches of
  1,024 distinct ids never asked before through :class:`RequestBatcher`,
  k = 10; median batch ms and engine-call ms (each ending in the copy of
  the answer to the host), busy ms a batch, idle share, ``pdist``
  launches a batch;
- ``ivf_fused``: :class:`QueryEngine` over the 82,115 ball rows drawn in
  512 clusters as ``chip_smoke.py``'s approximate lanes draw them (its
  ``clustered_table``), an IVF index of ``auto_ncells`` cells, nprobe 8,
  the fused scan mode, batches of 1,024 distinct cold ids through
  :class:`RequestBatcher`, k = 10: median batch ms and engine-call ms,
  busy ms a batch, idle share, the device ms of ``scan_topk_cand`` a
  batch (``kernel_ms``, its scan and split-merge items) and its
  launches a batch;
- ``hgcn_mean`` and ``hgcn_att``: the HGCN link-prediction step at
  ogbn-arxiv scale that ``chip_smoke.py``'s ``train`` and ``att_train``
  phases run (``hgcn_bench.setup_lp``, bf16 messages, hidden (128, 32);
  the attention arm with ``use_att``): step ms after one warm-up step,
  busy ms a step, idle share, the device ms of each kernel of
  ``csrc/cluster.cu`` a step (``cluster_ms``, by item name) and the
  launches a step of ``cluster_aggregate``, ``cluster_att_fwd`` and
  ``cluster_att_bwd``.

Busy ms come from ``torch.profiler`` put on the card's clock
(:mod:`devtime`); ``kernel_ms`` is the busy time of the items whose name
holds the kernel's.  Prints one JSON object a leg.

    python -m hyperspace_torch.benchmarks.path_bench [--seed 0]
        [--steps 10]
        [--legs gyro_layers,two_stage,ivf_fused,hgcn_mean,hgcn_att]

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
IVF_CLUSTERS, NPROBE = 512, 8
LAYER_ROWS, D_IN, WIDTH, D_OUT = 169_343, 128, 128, 32


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# the kernels of csrc/cluster.cu, by the names the profiler shows, of
# this checkout and of those before the row plan
CLUSTER_KERNELS = ("agg_rows_kernel", "att_bwd_rows_kernel", "row_sum_kernel",
                   "cluster_kernel", "att_bwd_kernel", "block_ptr_kernel")


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


def ivf_fused(seed: int) -> dict:
    from hyperspace_torch.benchmarks.devtime import profile_window
    from hyperspace_torch.kernels import scan_topk as T
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.serve import QueryEngine, RequestBatcher
    from hyperspace_torch.serve.index import auto_ncells, build_index

    rng = np.random.default_rng([seed, 16])
    centers = rng.standard_normal((IVF_CLUSTERS, DIM)) * 0.25
    vv = (centers[rng.integers(0, IVF_CLUSTERS, size=ROWS)]
          + rng.standard_normal((ROWS, DIM)) * 0.05)
    table = PoincareBall(C).expmap0(
        torch.as_tensor(vv, dtype=torch.float32)).numpy()
    index = build_index(table, ("poincare", C), auto_ncells(ROWS), iters=8,
                        seed=0, balance=2.0)
    eng = QueryEngine(table, ("poincare", C), index=index, nprobe=NPROBE,
                      scan_mode="fused")
    batcher = RequestBatcher(eng)
    cold = rng.permutation(ROWS)[:40 * BATCH].reshape(40, BATCH)
    walls = {"engine": [], "batcher": []}
    for j, ids in enumerate(cold[:21]):
        t0 = time.perf_counter()
        i, d = eng.topk_neighbors(ids.astype(np.int32), K)
        i.cpu(), d.cpu()
        t1 = time.perf_counter()
        T.scan_topk_cand.launches = 0
        batcher.topk(ids.tolist(), K)
        t2 = time.perf_counter()
        if j:                                          # after a warm-up
            walls["engine"].append(t1 - t0)
            walls["batcher"].append(t2 - t1)
    if batcher.stats()["cache_hit"]:
        raise AssertionError("a batch hit the cache")
    launches = T.scan_topk_cand.launches
    med = float(np.median(walls["batcher"])) * 1e3
    more = iter(cold[21:])
    items, _, windows = profile_window(
        torch, lambda: batcher.topk(next(more).tolist(), K), 5)
    total = sum(items.values())
    cand = {k[:90]: v for k, v in items.items()
            if "scan_cand" in k or "merge" in k}
    return {"leg": "ivf_fused", "rows": ROWS, "ncells": index.ncells,
            "nprobe": NPROBE, "bucket": BATCH, "k": K, "batch_ms": med,
            "engine_ms": float(np.median(walls["engine"])) * 1e3,
            "scan_topk_cand_launches_a_batch": launches,
            "busy_ms": total, "idle_share": 1.0 - total / med,
            "kernel_ms": sum(cand.values()), "kernel_items": cand,
            "clock_checked": any(w["accepted"] for w in windows)}


def hgcn(seed: int, steps: int, use_att: bool) -> dict:
    from hyperspace_torch.benchmarks import hgcn_bench as B
    from hyperspace_torch.benchmarks.devtime import profile_window
    from hyperspace_torch.kernels import cluster as KC

    setup = B.setup_lp(device="cuda", seed=seed, use_att=use_att)
    first = float(setup.step())                     # warm-up
    KC.cluster_aggregate.launches = KC.cluster_att_bwd.launches = 0
    KC.cluster_att_fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [setup.step() for _ in range(steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = {"cluster_aggregate": KC.cluster_aggregate.launches / steps,
                "cluster_att_fwd": KC.cluster_att_fwd.launches / steps,
                "cluster_att_bwd": KC.cluster_att_bwd.launches / steps}
    items, _, windows = profile_window(torch, setup.step, 3)
    total = sum(items.values())
    cl = {k[:90]: v for k, v in items.items()
          if any(name in k for name in CLUSTER_KERNELS)}
    return {"leg": "hgcn_att" if use_att else "hgcn_mean",
            "nodes": setup.num_nodes, "steps": steps, "step_ms": step_ms,
            "launches_a_step": launches, "loss_first": first,
            "loss_last": float(losses[-1]), "busy_ms": total,
            "idle_share": 1.0 - total / step_ms,
            "clock_checked": any(w["accepted"] for w in windows),
            "cluster_ms": cl, "cluster_ms_total": sum(cl.values())}


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
    legs = {"gyro_layers": lambda: gyro_layers(args.seed, args.steps),
            "two_stage": lambda: two_stage(args.seed),
            "ivf_fused": lambda: ivf_fused(args.seed),
            "hgcn_mean": lambda: hgcn(args.seed, args.steps, False),
            "hgcn_att": lambda: hgcn(args.seed, args.steps, True)}
    for leg in args.legs.split(","):
        emit({**head, **legs[leg]()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

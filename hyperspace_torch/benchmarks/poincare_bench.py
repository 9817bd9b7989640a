"""Poincaré-embedding epoch time (counterpart of ``bench.py``'s
``bench_poincare``): BASELINE.json's second metric.

    python -m hyperspace_torch.benchmarks.poincare_bench [--repeats 3]
        [--device cuda] [--depth 5] [--branching 9] [--no-large]

The WordNet-noun-scale stand-in is the JAX bench's synthetic tree (depth
5, branching 9: 66,430 nodes, 323,847 closure pairs), dim 10, c = 1,
batch 1,024, 10 negatives, lr 0.3, burn-in 100 steps at 0.01; an epoch
is ⌊pairs / batch⌋ = 316 steps.  Each strategy runs one untimed epoch
(which captures its CUDA graph where it has one), then ``repeats`` timed
epochs on the host's clock, each ending in a synchronisation:

- ``dense``: :func:`train_step` a step (whole-table update);
- ``sparse``: :func:`train_step_sparse` (``torch.unique`` a step);
- ``planned``: :func:`train_step_planned_packed` on a host-built plan;
- ``dense_scan`` / ``planned_scan``: the epoch as one chunk (a CUDA graph
  of one step replayed);
- ``mined`` / ``mined_scan``: the dense step with hard negatives mined
  through ``scan_topk`` (beside the headline, not in it).

The headline ``poincare_embed_epoch_time`` is the fastest of the first
five, with its repeat spread (max / min).  ``large_table`` re-times the
strategies on the depth-6 tree (597,871 rows) with Riemannian Adam over
50 steps, as step ms.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable

import torch

from hyperspace_torch.benchmarks.hgcn_bench import card_name
from hyperspace_torch.data.wordnet import synthetic_tree
from hyperspace_torch.kernels._support import resolve_device
from hyperspace_torch.models import poincare_embed as pe

HEADLINE = ("dense", "sparse", "planned", "dense_scan", "planned_scan")
STRATEGIES = HEADLINE + ("mined", "mined_scan")


def bench_config(num_nodes: int, **kw) -> pe.PoincareEmbedConfig:
    """``bench.py``'s and ``configs/poincare_wordnet.yaml``'s shapes."""
    return pe.PoincareEmbedConfig(num_nodes=num_nodes, dim=10,
                                  batch_size=1024, neg_samples=10, **kw)


@dataclasses.dataclass
class Runner:
    """One strategy: ``epoch()`` runs ``steps`` steps from the state held
    in ``state`` and returns their losses (on the device)."""

    name: str
    cfg: pe.PoincareEmbedConfig
    opt: Any
    state: Any
    epoch_fn: Callable
    steps: int

    def epoch(self) -> torch.Tensor:
        self.state, losses = self.epoch_fn(self.state)
        return losses


def make_runner(name: str, cfg: pe.PoincareEmbedConfig, pairs: torch.Tensor,
                plan: pe.SparsePlan, steps: int, seed: int = 0) -> Runner:
    """The runner of strategy ``name`` (:data:`STRATEGIES`), from a fresh
    state seeded from ``seed``; ``plan`` holds ``steps`` plan rows."""
    if name.startswith("mined"):
        cfg = dataclasses.replace(cfg, neg_mode="mined")
    if name == "sparse":
        cfg = dataclasses.replace(cfg, sparse=True)
    state, opt = pe.init_state(cfg, seed, pairs.device)
    if name in ("dense_scan", "mined_scan"):
        fn = lambda st: pe.train_epoch_scan(cfg, opt, st, pairs, steps)  # noqa
    elif name == "planned_scan":
        state = pe.pack_state(cfg, state)
        fn = lambda st: pe.train_epoch_planned_packed(cfg, opt, st, plan)  # noqa
    else:
        if name == "planned":
            state = pe.pack_state(cfg, state)
            one = lambda st: pe.train_step_planned_packed(  # noqa: E731
                cfg, opt, st, plan)
        else:
            step_fn = pe.make_train_step(cfg)
            one = lambda st: step_fn(cfg, opt, st, pairs)  # noqa: E731

        def fn(st):
            losses = []
            for _ in range(steps):
                st, loss = one(st)
                losses.append(loss)
            return st, torch.stack(losses)
    return Runner(name, cfg, opt, state, fn, steps)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_runner(run: Runner, repeats: int) -> dict:
    """One untimed epoch, then ``repeats`` timed ones: the fastest
    seconds, the spread, and the timed epochs' losses (first, last)."""
    dev = run.state[0].device
    run.epoch()
    _sync(dev)
    times, losses = [], None
    for _ in range(repeats):
        t0 = time.perf_counter()
        losses = run.epoch()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return {"s": min(times), "spread": max(times) / min(times),
            "times": times, "loss_first": float(losses[0]),
            "loss_last": float(losses[-1])}


def run_poincare_bench(repeats: int = 3, *, device="cuda", seed: int = 0,
                       depth: int = 5, branching: int = 9,
                       large: bool = True, large_depth: int = 6,
                       large_steps: int = 50) -> dict:
    """The epoch times of every strategy and, with ``large``, the step
    ms of each at the large table; see the module docstring."""
    dev = resolve_device(device)
    ds = synthetic_tree(depth, branching)
    cfg = bench_config(ds.num_nodes)
    steps = max(1, ds.num_pairs // cfg.batch_size)
    pairs = torch.as_tensor(ds.pairs, dtype=torch.int64, device=dev)
    plan = pe.plan_sparse_steps(cfg, ds.pairs, steps, seed=seed, device=dev)
    epochs = {name: time_runner(make_runner(name, cfg, pairs, plan, steps,
                                            seed), repeats)
              for name in STRATEGIES}
    update = min(HEADLINE, key=lambda n: epochs[n]["s"])
    out = {
        "metric": "poincare_embed_epoch_time", "value": epochs[update]["s"],
        "unit": "s", "update": update,
        "repeat_spread": epochs[update]["spread"],
        "num_nodes": ds.num_nodes, "num_pairs": ds.num_pairs,
        "steps_per_epoch": steps, "batch_size": cfg.batch_size,
        **{f"{n}_epoch_s": e["s"] for n, e in epochs.items()},
        "epochs": epochs, "device": str(dev),
        "card": card_name() if dev.type == "cuda" else None,
    }
    if large:
        big = synthetic_tree(large_depth, branching)
        big_cfg = bench_config(big.num_nodes, optimizer="radam")
        big_pairs = torch.as_tensor(big.pairs, dtype=torch.int64,
                                    device=dev)
        big_plan = pe.plan_sparse_steps(big_cfg, big.pairs, large_steps,
                                        seed=seed, device=dev)
        lt = {"num_nodes": big.num_nodes, "num_pairs": big.num_pairs,
              "optimizer": "radam", "steps": large_steps}
        for name in ("dense", "sparse", "planned", "planned_scan"):
            r = time_runner(make_runner(name, big_cfg, big_pairs, big_plan,
                                        large_steps, seed),
                            max(2, repeats - 1))
            lt[f"{name}_step_ms"] = r["s"] / large_steps * 1e3
        lt["update"] = min(("dense", "sparse", "planned", "planned_scan"),
                           key=lambda n: lt[f"{n}_step_ms"])
        out["large_table"] = lt
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--branching", type=int, default=9)
    ap.add_argument("--no-large", action="store_true",
                    help="skip the depth-6 large-table leg")
    args = ap.parse_args(argv)
    print(json.dumps(run_poincare_bench(
        args.repeats, device=args.device, depth=args.depth,
        branching=args.branching, large=not args.no_large)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

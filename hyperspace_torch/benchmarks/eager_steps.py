"""Eager (``scan_chunk=1``) training steps of HyboNet and HGCN on one card,
timed alone so that two checkouts can be compared in one run.

- ``hybonet_accum1`` and ``hybonet_accum2``: the CLI's HyboNet step
  (``models.hybonet.train_step_sampled``) at the width of
  ``configs/hybonet_textclf.yaml`` (dim 128, 4 layers, 4 heads, batch 64)
  on the CLI's synthetic text, its AdamW behind ``accum`` 1 or 2
  (``optim.accum.with_grad_accumulation``); a step is one microstep, as
  the CLI counts ``steps``;
- ``hgcn_lp``: the CLI's LP step (``models.hgcn.train_step_lp``) at
  ogbn-arxiv scale with hidden (128, 32) and bf16 messages and decoder
  (``hgcn_bench.setup_lp(step="lp")``).

Each leg runs ``--warmup`` steps, then ``--repeats`` windows of
``--steps`` steps, each ending in a sync: ``ms_per_step`` is the median
window's ms a step on the host's clock, ``windows_ms`` every window's.
``busy_ms`` is the card's busy time a step under ``torch.profiler`` put
on the card's clock (:mod:`devtime`), ``idle_share`` its share of the
median step left idle.  A host-bound step is explained by what the host
does a step, from a ``torch.profiler`` window of its own:
``aten_ops_a_step`` (operators called), ``runtime_calls_a_step`` (CUDA
runtime calls by name: launches, copies, synchronisations) and
``top_host_ms`` (the operators of most host time a step, their own
time).  Prints one JSON object a leg.

    python -m hyperspace_torch.benchmarks.eager_steps [--legs ...]
        [--steps 16] [--repeats 5] [--warmup 4] [--seed 0]

To time another checkout's package with this file, put that checkout's
root first on ``PYTHONPATH`` and run the file by its path; ``package``
in the output names the package that was timed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import torch

HB_YAML = os.path.join("configs", "hybonet_textclf.yaml")
LEGS = ("hybonet_accum1", "hybonet_accum2", "hgcn_lp")


def card_name() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def hybonet_step(seed: int, accum: int, root: str):
    """The CLI's HyboNet step at the config's width, as a closure."""
    from hyperspace_torch.cli import train as cli_train
    from hyperspace_torch.data import text as T
    from hyperspace_torch.models import hybonet
    from hyperspace_torch.optim.accum import with_grad_accumulation

    keys = dict(p.split("=", 1) for p in cli_train.read_flat_yaml(
        os.path.join(root, HB_YAML)))
    ds, _ = T.load_text("text", None)
    tr, _ = ds.split(0.8, seed=seed)
    cfg = hybonet.HyboNetConfig(
        vocab_size=ds.vocab_size, num_classes=ds.num_classes,
        max_len=ds.tokens.shape[1], dim=int(keys["dim"]),
        num_layers=int(keys["num_layers"]),
        num_heads=int(keys["num_heads"]),
        batch_size=int(keys["batch_size"]))
    dev = torch.device("cuda")
    model, opt, st = hybonet.init_model(cfg, seed, dev)
    opt, _ = with_grad_accumulation(opt, None, accum)
    data = [torch.as_tensor(a, device=dev)
            for a in (tr.tokens, tr.mask, tr.labels)]

    def step():
        return hybonet.train_step_sampled(model, opt, st, *data)[1]

    return step, {"dim": cfg.dim, "num_layers": cfg.num_layers,
                  "num_heads": cfg.num_heads, "batch_size": cfg.batch_size,
                  "accum": accum}


def hgcn_step(seed: int):
    """The CLI's LP step at ogbn-arxiv scale, as a closure."""
    from hyperspace_torch.benchmarks import hgcn_bench as B

    setup = B.setup_lp(device="cuda", seed=seed, step="lp")
    return setup.step, {"nodes": setup.num_nodes,
                        "hidden_dims": list(setup.cfg.hidden_dims)}


def host_calls(step, reps: int = 4, top_n: int = 8) -> dict:
    """What the host does a step of ``step``, over ``reps`` steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    host = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU]
    top = sorted(host, key=lambda e: -e.self_cpu_time_total)[:top_n]
    return {"aten_ops_a_step": sum(e.count for e in host
                                   if e.key.startswith("aten::")) / reps,
            "runtime_calls_a_step": {e.key: e.count / reps for e in host
                                     if e.key.startswith("cuda")},
            "top_host_ms": {e.key: e.self_cpu_time_total / 1e3 / reps
                            for e in top}}


def time_leg(step, steps: int, repeats: int, warmup: int) -> dict:
    from hyperspace_torch.benchmarks.devtime import profile_window

    for _ in range(warmup):
        loss = step()
    first = float(loss)
    windows = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) * 1e3 / steps)
    ms = statistics.median(windows)
    items, _, wins = profile_window(torch, step, 4)
    busy = sum(items.values()) if items else None
    return {"ms_per_step": ms, "windows_ms": windows, "busy_ms": busy,
            "idle_share": None if busy is None else 1.0 - busy / ms,
            "clock_checked": any(w["accepted"] for w in wins),
            "loss_after_warmup": first, "loss_last": float(loss),
            **host_calls(step)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legs", default=",".join(LEGS))
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--root", default=".",
                    help="the checkout whose configs/ give the widths")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("eager_steps: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    import hyperspace_torch

    head = {"package": hyperspace_torch.__file__, "card": card_name()}
    for leg in args.legs.split(","):
        if leg.startswith("hybonet_accum"):
            step, shape = hybonet_step(args.seed, int(leg[-1]), args.root)
        elif leg == "hgcn_lp":
            step, shape = hgcn_step(args.seed)
        else:
            raise SystemExit(f"eager_steps: no leg {leg!r}; want {LEGS}")
        print(json.dumps({**head, "leg": leg, **shape,
                          **time_leg(step, args.steps, args.repeats,
                                     args.warmup)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

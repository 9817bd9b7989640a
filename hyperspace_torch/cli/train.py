"""Training entry point: ``python -m hyperspace_torch.cli.train``
(counterpart of ``hyperspace_tpu/cli/train.py``, the ``hybonet``
workload).

    python -m hyperspace_torch.cli.train hybonet --yaml configs/hybonet_textclf.yaml
    python -m hyperspace_torch.cli.train hybonet steps=200 dim=64 device=cpu

``--yaml`` reads a flat ``key: value`` file (the repository's configs);
``key=value`` arguments override it.  Run keys (``steps``, ``seed``,
``data_root``, ``precision``, ``accum``, ``log``, ``device``) go to
:class:`RunConfig`, the rest to the workload's config; an unknown key is
a usage error.  ``accum`` must be 1 (gradient accumulation is not
ported).  ``log=PATH`` appends one ``{"step", "loss"}`` JSON line per
step at the end of the run.  ``device=cuda`` is the default; ``device=cpu``
runs the kernels' plain versions.  Prints one JSON line,
``{"workload", "source", "loss", "accuracy"}``: the last step's loss and
the accuracy on the held-out 20 %.  Checkpoints, telemetry, chaos,
scanned chunks and meshes are not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os

from hyperspace_torch import precision as precision_lib
from hyperspace_torch.cli.serve import _coerce, _json_safe, apply_overrides


@dataclasses.dataclass
class RunConfig:
    steps: int = 500
    seed: int = 0
    data_root: str | None = None  # directory holding ``<dataset>.tsv``
    precision: str = "f32"        # f32 | bf16, copied into the workload
    accum: int = 1                # microbatches per update (1 only)
    log: str | None = None        # JSONL path of per-step losses
    device: str = "cuda"          # cuda | cpu


def split_overrides(pairs: list[str], run: RunConfig):
    """Partition key=value args into (run config, workload overrides)."""
    run_names = {f.name for f in dataclasses.fields(RunConfig)}
    run_kv, wl_kv = {}, {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"expected key=value, got {p!r}")
        k, v = p.split("=", 1)
        (run_kv if k in run_names else wl_kv)[k] = v
    return apply_overrides(run, run_kv), wl_kv


def read_flat_yaml(path: str) -> list[str]:
    """``key=value`` pairs from a flat YAML mapping of scalars (``key:
    value`` lines, ``#`` comments), the form of the repository's
    configs."""
    pairs = []
    with open(path) as f:
        for n, line in enumerate(f, 1):
            body = line.split(" #", 1)[0].strip()
            if not body or body.startswith("#"):
                continue
            key, sep, value = body.partition(":")
            if not sep or not key.strip() or line[0].isspace():
                raise SystemExit(f"{path}:{n}: want a flat 'key: value' "
                                 f"line, got {line.rstrip()!r}")
            pairs.append(f"{key.strip()}={value.strip()}")
    return pairs


def run_hybonet(run: RunConfig, overrides: dict) -> dict:
    from hyperspace_torch.data import text as T
    from hyperspace_torch.models import hybonet

    dataset = overrides.pop("dataset", "text")
    ds, source = T.load_text(dataset, run.data_root)
    tr, te = ds.split(0.8, seed=run.seed)
    overrides.setdefault("precision", run.precision)
    if "dtype" in overrides:
        overrides["dtype"] = precision_lib.parse_dtype(overrides["dtype"])
    cfg = apply_overrides(
        hybonet.HyboNetConfig(vocab_size=ds.vocab_size,
                              num_classes=ds.num_classes,
                              max_len=ds.tokens.shape[1]), overrides)
    model, losses = hybonet.train(cfg, tr, run.steps, run.seed, run.device)
    if run.log:
        os.makedirs(os.path.dirname(os.path.abspath(run.log)), exist_ok=True)
        with open(run.log, "a") as f:
            for i, x in enumerate(losses, 1):
                f.write(json.dumps(_json_safe({"step": i, "loss": x})) + "\n")
    res = hybonet.evaluate(model, te)
    return {"workload": "hybonet", "source": source,
            "loss": losses[-1] if losses else math.nan, **res}


def hgcn_mode_defaults(base, overrides: dict, sampled: bool):
    """HGCN's mode-aware defaults, as the JAX package ships them: sampled
    minibatches and the attention arm train at lr 3e-3 (the full-graph
    1e-2 oscillates or collapses there), and attention also clips the
    global gradient norm at 1.0.  An explicit ``lr``/``clip_norm`` in
    ``overrides`` wins."""
    use_att = _coerce(False, overrides.get("use_att", "false"))
    if (sampled or use_att) and "lr" not in overrides:
        base = dataclasses.replace(base, lr=3e-3)
    if use_att and "clip_norm" not in overrides:
        base = dataclasses.replace(base, clip_norm=1.0)
    return base


WORKLOADS = {"hybonet": run_hybonet}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="hyperspace_torch.cli.train",
        description="Train a hyperspace_torch workload.")
    ap.add_argument("workload", choices=sorted(WORKLOADS))
    ap.add_argument("overrides", nargs="*",
                    help="key=value overrides (run- or workload-config)")
    ap.add_argument("--yaml", default=None,
                    help="flat YAML file of overrides (CLI wins)")
    # intermixed: overrides may come after --yaml on any Python 3.12
    args = ap.parse_intermixed_args(argv)
    pairs = (read_flat_yaml(args.yaml) if args.yaml else []) + args.overrides
    run, wl_overrides = split_overrides(pairs, RunConfig())
    try:
        precision_lib.get_policy(run.precision)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if run.accum != 1:
        raise SystemExit(f"accum={run.accum}: gradient accumulation is not "
                         "ported (want accum=1)")
    result = WORKLOADS[args.workload](run, wl_overrides)
    print(json.dumps(_json_safe(result)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

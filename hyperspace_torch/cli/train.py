"""Training entry point: ``python -m hyperspace_torch.cli.train``
(counterpart of ``hyperspace_tpu/cli/train.py``, the ``hybonet``,
``poincare``, ``hvae`` and ``hgcn`` workloads).

    python -m hyperspace_torch.cli.train hybonet --yaml configs/hybonet_textclf.yaml
    python -m hyperspace_torch.cli.train hybonet steps=200 dim=64 device=cpu
    python -m hyperspace_torch.cli.train poincare --yaml configs/poincare_wordnet.yaml
    python -m hyperspace_torch.cli.train hvae --yaml configs/hvae_mnist.yaml
    python -m hyperspace_torch.cli.train hgcn --yaml configs/hgcn_arxiv_lp.yaml data_root=DIR
    python -m hyperspace_torch.cli.train hgcn task=nc dataset=cora device=cpu

``--yaml`` reads a flat ``key: value`` file (the repository's configs);
``key=value`` arguments override it.  Run keys (``steps``, ``seed``,
``data_root``, ``precision``, ``accum``, ``log``, ``device``,
``scan_chunk``, ``host_table``, ``graph_cache``, ``multihost``) go to
:class:`RunConfig`, the rest to the workload's config; an unknown key is
a usage error.  ``accum`` must be 1 (gradient accumulation is not
ported).  ``log=PATH`` appends one ``{"step", "loss"}`` JSON line per
step at the end of the run.  ``device=cuda`` is the default;
``device=cpu`` runs the kernels' plain versions.

``hybonet`` prints ``{"workload", "source", "loss", "accuracy"}``: the
last step's loss and the accuracy on the held-out 20 %.  ``poincare``
trains Poincaré embeddings on the closure TSV at ``data_root`` (a file;
without it the synthetic tree of depth 5, branching 4) and prints
``{"workload", "steps", "mean_rank", "map"}``; ``scan_chunk=K`` runs K
steps a chunk (one CUDA graph replayed K times on the card, the step
budget rounded up to a multiple of K; dense steps only).  ``hvae``
trains the hyperbolic VAE on the MNIST IDX files at ``data_root`` (a
directory; without them ``synthetic_mnist``) and prints ``{"workload",
"source", "loss", "recon", "kl", "iwae"}``: the last step's metrics and
the 16-sample IWAE bound of the first 256 images; ``scan_chunk=K``
graphs its sampled step as ``poincare`` does, and ``conv_features``
takes comma-separated widths.

``hgcn`` trains full-batch HGCN on ``dataset`` (``cora`` or
``ogbn-arxiv``) from its files under ``data_root`` (``cora.content`` /
``cora.cites``, or OGB's ``raw/*.csv``; without them the synthetic
hierarchy of ``data.graphs.load_graph``): ``reorder=true|bfs|community``
relabels the nodes first, the host prep runs in C++ where a compiler is
found and is cached per ``graph_cache`` (auto, true or false), and
``task=lp`` trains link prediction with ``models.hgcn.train_step_lp``,
``task=nc`` node classification with ``train_step_nc``.  It prints
``{"workload", "task", "dataset", "source", "loss", ...}`` with the test
ROC-AUC (``lp``) or the val/test accuracy and macro-F1 (``nc``), then
``prep`` (the host prep's path, ``"native"`` or ``"numpy"``) and
``seconds`` (the whole run).  ``hidden_dims`` takes a JSON list, the
``*dtype`` keys dtype names.  ``sampled=true``, meshes
(``multihost=true``) and ``scan_chunk>1`` exit "not ported".

Checkpoints, telemetry, chaos, meshes and the host-resident table
(``host_table=1``) are not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import torch

from hyperspace_torch import precision as precision_lib
from hyperspace_torch.cli.serve import _coerce, _json_safe, apply_overrides


@dataclasses.dataclass
class RunConfig:
    steps: int = 500
    seed: int = 0
    # hybonet: a directory holding ``<dataset>.tsv``; poincare: the
    # closure TSV itself
    data_root: str | None = None
    precision: str = "f32"        # f32 | bf16, copied into the workload
    accum: int = 1                # microbatches per update (1 only)
    log: str | None = None        # JSONL path of per-step losses
    device: str = "cuda"          # cuda | cpu
    scan_chunk: int = 1           # steps a chunk (poincare, dense steps)
    host_table: bool = False      # the beyond-HBM table: not ported
    graph_cache: str = "auto"     # hgcn's host-prep cache: auto|true|false
    multihost: bool = False       # meshes: not ported


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


def _write_log(path: str, losses) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        for i, x in enumerate(losses, 1):
            f.write(json.dumps(_json_safe({"step": i, "loss": x})) + "\n")


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
        _write_log(run.log, losses)
    res = hybonet.evaluate(model, te)
    return {"workload": "hybonet", "source": source,
            "loss": losses[-1] if losses else math.nan, **res}


def run_poincare(run: RunConfig, overrides: dict) -> dict:
    from hyperspace_torch.data import wordnet
    from hyperspace_torch.kernels._support import resolve_device
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.models import poincare_embed as pe
    from hyperspace_torch.train import loop

    if run.host_table:
        raise SystemExit("host_table=1: the host-resident embedding table "
                         "is not ported")
    if run.data_root:
        ds = wordnet.load_closure_tsv(run.data_root)
    else:
        ds = wordnet.synthetic_tree(depth=5, branching=4)
    overrides.setdefault("precision", run.precision)
    cfg = apply_overrides(pe.PoincareEmbedConfig(num_nodes=ds.num_nodes),
                          overrides)
    if run.scan_chunk > 1 and cfg.sparse:
        raise SystemExit(
            "scan_chunk>1 chunks the dense step only — drop sparse=true or "
            "scan_chunk (the planned-sparse epoch is "
            "poincare_embed.train_epoch_planned_packed)")
    dev = resolve_device(run.device)
    state, opt = pe.init_state(cfg, run.seed, dev)
    pairs = torch.as_tensor(ds.pairs, dtype=torch.int64, device=dev)
    step_fn = pe.make_train_step(cfg)
    k = max(int(run.scan_chunk), 1)
    stepper = loop.make_chunked_stepper(
        lambda st, p: step_fn(cfg, opt, st, p), k,
        counters=pe.path_counters())
    losses = []
    for _ in range(loop.round_steps_to_chunk(run.steps, k) // k):
        state, loss = stepper(state, pairs)
        losses.append(loss.reshape(-1))
    if run.log and losses:
        _write_log(run.log, torch.cat(losses).tolist())
    table = PoincareBall(cfg.c).proj(state.table)
    res = pe.evaluate(table, ds.pairs, cfg.c)
    return {"workload": "poincare", "steps": int(state.step), **res}


def run_hvae(run: RunConfig, overrides: dict) -> dict:
    from hyperspace_torch.data import mnist as M
    from hyperspace_torch.models import hvae
    from hyperspace_torch.train import loop

    ds, source = M.load_mnist(run.data_root)
    overrides.setdefault("precision", run.precision)
    if "conv_features" in overrides:
        overrides["conv_features"] = tuple(
            int(f) for f in overrides["conv_features"].split(",") if f)
    if "dtype" in overrides:
        overrides["dtype"] = precision_lib.parse_dtype(overrides["dtype"])
    cfg = apply_overrides(hvae.HVAEConfig(image_size=ds.images.shape[1]),
                          overrides)
    model, opt, state = hvae.init_model(cfg, run.seed, run.device)
    dev = state.step.device
    x_all = torch.as_tensor(ds.images, dtype=cfg.dtype, device=dev)
    k = max(int(run.scan_chunk), 1)
    step = hvae.chunk_step(model, opt)
    stepper = loop.make_chunked_stepper(step, k)
    outs = []
    for _ in range(loop.round_steps_to_chunk(run.steps, k) // k):
        state, out = stepper(state, x_all)
        outs.append(out.reshape(-1, 3))
    rows = torch.cat(outs).tolist() if outs else [[math.nan] * 3]
    if run.log and outs:
        _write_log(run.log, [r[0] for r in rows])
    gen = torch.Generator(device=dev).manual_seed(1)
    iwae = hvae.iwae_bound(model, state.params, x_all[:256], gen, k=16)
    loss, recon, kl = rows[-1]
    return {"workload": "hvae", "source": source, "loss": loss,
            "recon": recon, "kl": kl, "iwae": float(iwae)}


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


def _graph_cache(run: RunConfig):
    """``graph_cache`` as the ``cache`` argument of ``data.graphs``."""
    v = run.graph_cache.lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    if v == "auto":
        return "auto"
    raise SystemExit(f"graph_cache={run.graph_cache!r}: want auto/true/false")


def _precision_default(run: RunConfig, overrides: dict) -> dict:
    """Copy the run's ``precision`` into the workload's overrides unless
    they set it (explicit wins)."""
    overrides.setdefault("precision", run.precision)
    return overrides


# the neighbour-sampled mode's keys (configs/hgcn_sampled_nc.yaml)
_SAMPLED_KEYS = ("fanouts", "batch", "plan_steps")


def run_hgcn(run: RunConfig, overrides: dict) -> dict:
    from hyperspace_torch.data import graphs as G
    from hyperspace_torch.kernels._support import resolve_device
    from hyperspace_torch.models import hgcn

    t0 = time.perf_counter()
    task = overrides.pop("task", "lp")
    dataset = overrides.pop("dataset", "cora")
    reorder = overrides.pop("reorder", "false").lower()
    sampled = overrides.pop("sampled", "false").lower() in ("1", "true",
                                                            "yes")
    for k in _SAMPLED_KEYS:
        overrides.pop(k, None)
    if sampled:
        raise SystemExit("sampled=true: neighbour-sampled HGCN "
                         "(models/hgcn_sampled.py) is not ported")
    if run.multihost:
        raise SystemExit("multihost=true: meshes are not ported (the port "
                         "trains HGCN on one device)")
    if run.scan_chunk > 1:
        raise SystemExit(f"scan_chunk={run.scan_chunk}: chunked (graphed) "
                         "HGCN steps are not ported (want scan_chunk=1)")
    if task not in ("lp", "nc"):
        raise SystemExit(f"task={task!r}: want lp or nc")
    if reorder not in ("0", "false", "no", "1", "true", "yes", "bfs",
                       "community"):
        raise SystemExit(
            f"reorder={reorder!r}: want true/false, bfs, or community")
    gc = _graph_cache(run)
    dev = resolve_device(run.device)
    if "hidden_dims" in overrides:
        overrides["hidden_dims"] = tuple(json.loads(overrides["hidden_dims"]))
    for k in ("dtype", "agg_dtype", "decoder_dtype"):
        if k in overrides:
            overrides[k] = precision_lib.parse_dtype(overrides[k])
    edges, x, labels, ncls, source = G.load_graph(dataset, run.data_root)
    if reorder not in ("0", "false", "no"):
        # locality relabeling: the block density the cluster kernels use
        edges, x, labels, _ = G.apply_locality_order(
            edges, x, labels,
            method="community" if reorder == "community" else "bfs",
            cache=gc)
    base = hgcn_mode_defaults(
        hgcn.HGCNConfig(feat_dim=x.shape[1],
                        num_classes=ncls if task == "nc" else 0),
        overrides, sampled)
    cfg = apply_overrides(base, _precision_default(run, overrides))
    num_nodes = x.shape[0]
    cmp_ = G.cluster_min_pair_for(cfg.use_att)
    losses = []
    if task == "lp":
        split = G.split_edges(edges, num_nodes, x, seed=run.seed,
                              cluster_min_pair=cmp_, cache=gc)
        graph = split.graph
        model, opt, state = hgcn.init_lp(cfg, graph, seed=run.seed,
                                         device=dev)
        ga = G.to_device(graph, dev)
        train_pos = G.index_tensor(split.train_pos, dev)
        for _ in range(run.steps):
            state, loss = hgcn.train_step_lp(model, opt, num_nodes, state,
                                             ga, train_pos)
            losses.append(loss)
        res = hgcn.evaluate_lp(model, split, "test", ga=ga)
    else:
        tr, va, te = G.node_split_masks(num_nodes, seed=run.seed)
        graph = G.prepare(edges, num_nodes, x, labels=labels,
                          num_classes=ncls, train_mask=tr, val_mask=va,
                          test_mask=te, cluster_min_pair=cmp_, cache=gc)
        model, opt, state = hgcn.init_nc(cfg, graph, seed=run.seed,
                                         device=dev)
        ga = G.to_device(graph, dev)
        lab, mask = hgcn.nc_targets(graph, dev)
        for _ in range(run.steps):
            state, loss = hgcn.train_step_nc(model, opt, state, ga, lab,
                                             mask)
            losses.append(loss)
        res = hgcn.evaluate_nc(model, graph, ga=ga)
    # one host read of the losses, after the steps
    losses = torch.stack(losses).tolist() if losses else []
    if run.log and losses:
        _write_log(run.log, losses)
    return {"workload": "hgcn", "task": task, "dataset": dataset,
            "source": source, "loss": losses[-1] if losses else math.nan,
            **res, "prep": graph.prep,
            "seconds": time.perf_counter() - t0}


WORKLOADS = {"hybonet": run_hybonet, "poincare": run_poincare,
             "hvae": run_hvae, "hgcn": run_hgcn}


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

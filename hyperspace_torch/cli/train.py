"""Training entry point: ``python -m hyperspace_torch.cli.train``
(counterpart of ``hyperspace_tpu/cli/train.py``, its five workloads).

    python -m hyperspace_torch.cli.train hybonet --yaml configs/hybonet_textclf.yaml
    python -m hyperspace_torch.cli.train hybonet steps=200 dim=64 accum=2 device=cpu
    python -m hyperspace_torch.cli.train poincare --yaml configs/poincare_wordnet.yaml
    python -m hyperspace_torch.cli.train hvae --yaml configs/hvae_mnist.yaml
    python -m hyperspace_torch.cli.train hgcn --yaml configs/hgcn_arxiv_lp.yaml data_root=DIR
    python -m hyperspace_torch.cli.train hgcn task=nc dataset=cora device=cpu
    python -m hyperspace_torch.cli.train product --yaml configs/product_multihost.yaml
    python -m hyperspace_torch.cli.train poincare steps=2000 ckpt_dir=ck resume=true

``--yaml`` reads a flat ``key: value`` file (the repository's configs);
``key=value`` arguments override it.  The keys of :class:`RunConfig` go
to the run, the rest to the workload's config; an unknown key is a usage
error.  ``device=cuda`` is the default; ``device=cpu`` runs the kernels'
plain versions.

Every workload builds its state and a stepper and goes through one loop,
``train/loop.py:run_loop``: ``log=PATH`` appends its JSONL records
(``{"step", "ts", "host", "loss"}`` each time a call crosses a multiple
of ``eval_every``, 50 when 0; chunked runs add the interval's
``loss_mean``/``loss_last``/``loss_min``/``loss_max`` and close with a
record of the last steps; ``health/*`` records every ``health_every``
calls), ``tensorboard_dir=`` mirrors the numbers to TensorBoard,
``ckpt_dir=`` saves every ``ckpt_every`` steps and the last, and
``resume=true`` continues from the newest committed checkpoint (the
state, optimizer moments and counts, generators and step count), so a
resumed run is the run that was stopped.  ``accum=K`` accumulates K
microbatch gradients an update (``hybonet`` and ``hvae``; ``steps``
counts microsteps).  ``health_every=N`` samples the numerical-health
monitor every N calls (``health_eps``, ``health_tol``, ``health_abort``).
``scan_chunk=K`` runs K steps a call (one CUDA graph replayed K times on
the card; the step budget rounded up to a multiple of K) for every
workload: ``poincare`` (dense steps), ``hvae``, ``product``, ``hybonet``
(any ``accum``) and ``hgcn`` (``task=lp`` and ``nc``, either arm; the
graph, its row plan and the host prep are built once, outside the
captured step).

Telemetry, as JAX's: ``telemetry=1`` writes the run manifest first in
the JSONL log, ``span/*`` and ``ctr/*`` fields in every record and a
closing ``telemetry_summary``; ``trace_out=PATH`` dumps the host spans
as a Chrome trace (Perfetto); ``metrics_out=PATH`` writes the registry's
Prometheus text every ``metrics_every`` seconds and at the end;
``profile_steps=N`` waits for the card after each of the first N steps'
dispatches and records ``train/phase/device_step_ms``.  The guard:
``rollback=N`` (needs ``ckpt_dir``) rewinds to the last committed
checkpoint on a non-finite loss or a health violation, at most N times
(``rollback_lr_backoff`` is the scale handed to the hook and recorded);
``chaos=site:kind[:key=value...]`` arms faults at ``ckpt.save``,
``train.step_nan`` and ``data.next_batch`` (the host prefetcher's: it
fires on a path that runs one, ``host_table=1``) (``chaos_seed``), and
the result gains a ``chaos`` block.

``poincare host_table=1`` keeps the packed table (rows and optimizer
moments) in host memory and trains through a device hot-row cache of
``hot_rows`` rows (0: a chunk's worst-case working set), one planned
chunk of ``host_chunk_steps`` steps a dispatch with the touched rows
written back at each chunk boundary (``train/host_embed.py``), bitwise
the in-HBM planned trainer fed the same plans; ``host_gather_ahead=1``
gathers upcoming chunks' rows in the prefetch thread (rows evicted and
touched again may be up to 3 chunks stale).  It refuses ``sparse=true``
and ``scan_chunk>1``, saves the master under ``<ckpt_dir>/host_table``
(``save_sharded``) and prints ``{"workload", "steps", "host_table",
"mean_rank", "map"}``, or ``"eval_skipped": "beyond-hbm"`` past
``EVAL_MAX_ROWS`` rows.

``hybonet`` prints ``{"workload", "source", "loss", "accuracy"}`` (the
held-out 20 %).  ``poincare`` trains on the closure TSV at ``data_root``
(without it the synthetic tree of depth 5, branching 4) and prints
``{"workload", "steps", "mean_rank", "map"}``.  ``hvae`` trains on the
MNIST IDX files at ``data_root`` (without them ``synthetic_mnist``) and
prints ``{"workload", "source", "loss", "recon", "kl", "iwae"}`` (the
16-sample IWAE bound of the first 256 images); ``conv_features`` takes
comma-separated widths.  ``product`` trains product-manifold embeddings
with learned curvatures on the closure TSV at ``data_root`` (without it
the tree of depth 5, branching 3) and prints ``{"workload", "mean_rank",
"map", "curvatures"}``; ``factors`` takes a JSON list of ``[kind, dim]``.
``hgcn`` trains full-batch HGCN on ``dataset`` (``cora`` or
``ogbn-arxiv``) from its files under ``data_root`` (``cora.content`` /
``cora.cites``, or OGB's ``raw/*.csv``; without them the synthetic
hierarchy of ``data.graphs.load_graph``): ``reorder=true|bfs|community``
relabels the nodes, the host prep runs in C++ where a compiler is found
and is cached per ``graph_cache`` (auto, true or false), ``task=lp``
trains link prediction, ``task=nc`` node classification.  It prints
``{"workload", "task", "dataset", "source", "loss", ...}`` with the test
ROC-AUC (``lp``) or the val/test accuracy and macro-F1 (``nc``), then
``prep`` (``"native"`` or ``"numpy"``) and ``seconds``.  ``hidden_dims``
takes a JSON list, the ``*dtype`` keys dtype names.

Not ported, each exiting with its name when set away from its default:
meshes and multi-process runs (``multihost``, ``tp``, ``coordinator``,
``num_processes``, ``process_id``), XLA's compilation cache
(``compile_cache_dir``) and sampled HGCN (``sampled=true``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Any, NamedTuple

import torch

from hyperspace_torch import precision as precision_lib
from hyperspace_torch.cli.serve import _coerce, _json_safe, apply_overrides
from hyperspace_torch.optim.accum import with_grad_accumulation
from hyperspace_torch.telemetry.trace import span
from hyperspace_torch.train.loop import (make_chunked_stepper,
                                         round_steps_to_chunk, run_loop)


@dataclasses.dataclass
class RunConfig:
    steps: int = 500
    seed: int = 0
    eval_every: int = 0           # log cadence in steps; 0 = every 50
    log: str | None = None        # JSONL path of run_loop's records
    tensorboard_dir: str | None = None
    ckpt_dir: str | None = None
    ckpt_every: int = 100         # <= 0: the final save only
    resume: bool = False
    # hybonet: a directory holding ``<dataset>.tsv``; poincare, product:
    # the closure TSV itself; hvae: the MNIST IDX files' directory
    data_root: str | None = None
    multihost: bool = False
    tp: int = 2
    scan_chunk: int = 1           # steps a call (a CUDA graph on the card)
    graph_cache: str = "auto"     # hgcn's host-prep cache: auto|true|false
    accum: int = 1                # microbatches an update (hybonet, hvae)
    precision: str = "f32"        # f32 | bf16, copied into the workload
    host_table: bool = False
    hot_rows: int = 0
    host_chunk_steps: int = 8
    host_gather_ahead: bool = False
    compile_cache_dir: str | None = None
    telemetry: bool = False
    trace_out: str | None = None
    metrics_out: str | None = None
    metrics_every: float = 30.0
    profile_steps: int = 0
    health_every: int = 0         # health samples every N calls; 0 = off
    health_eps: float = 1e-2      # warn below this ball margin
    health_tol: float = 1e-3      # warn above this constraint residual
    health_abort: bool = False
    chaos: str | None = None
    chaos_seed: int = 0
    rollback: int = 0
    rollback_lr_backoff: float = 0.5
    coordinator: str = "127.0.0.1:9357"
    num_processes: int = 1
    process_id: int = 0
    device: str = "cuda"          # cuda | cpu


# the JAX run keys that are not ported, by what they belong to
NOT_PORTED = {
    **dict.fromkeys(("tp", "coordinator", "num_processes", "process_id"),
                    "meshes and multi-process runs"),
    "compile_cache_dir": "XLA's persistent compilation cache",
}


def check_ported(run: RunConfig) -> None:
    """Exit, naming the key, for a run key that is not ported and is set
    away from its default."""
    defaults = RunConfig()
    for name, what in NOT_PORTED.items():
        value = getattr(run, name)
        if value != getattr(defaults, name):
            raise SystemExit(f"{name}={value!r}: not ported ({what})")
    if run.multihost:
        raise SystemExit("multihost=true: meshes are not ported (the port "
                         "trains on one device)")


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


# --- the loop's plumbing ---------------------------------------------------


class ModuleState(NamedTuple):
    """The state of a workload whose parameters an ``nn.Module`` owns
    (HyboNet, HGCN): the model, its optimizer and the step's
    generators and count.  ``train/checkpoint.py`` saves and restores it
    through the model's and the optimizer's ``state_dict``."""

    model: Any
    opt: Any
    train: Any


def _reject_accum(run: RunConfig, workload: str) -> None:
    if run.accum > 1:
        raise SystemExit(
            f"accum>1 is wired for hybonet/hvae only — the {workload} "
            "step updates full-batch (hgcn full-graph) or sparse rows "
            "(embeddings), where microbatch accumulation has no meaning")


def _chunk_run(run: RunConfig) -> RunConfig:
    """The step budget rounded up to a ``scan_chunk`` multiple: every call
    runs a full chunk, so the logged and saved steps are the steps
    taken."""
    rounded = round_steps_to_chunk(run.steps, run.scan_chunk)
    if rounded != run.steps:
        print(f"scan_chunk={run.scan_chunk}: step budget rounded up "
              f"{run.steps} -> {rounded} (every dispatch runs a full "
              "chunk)", flush=True)
    return dataclasses.replace(run, steps=rounded)


def _chunked(run: RunConfig, step_fn, **kw):
    """``(stepper, steps a call)``: ``step_fn(state) -> (state, loss)`` as
    ``scan_chunk`` steps a call (``train/loop.py``, a CUDA graph on the
    card; ``live=True`` for a :class:`ModuleState`, updated in place),
    unchanged for ``scan_chunk <= 1``."""
    k = max(int(run.scan_chunk), 1)
    return make_chunked_stepper(step_fn, k, **kw), k


def _maybe_health(run: RunConfig, build):
    """``build()`` only when health sampling is on."""
    return build() if run.health_every > 0 else None


def _module_health():
    from hyperspace_torch.telemetry.health import make_health_fn

    return make_health_fn(None, params_of=lambda st: dict(
        st.model.named_parameters()))


def _precision_default(run: RunConfig, overrides: dict) -> dict:
    """Copy the run's ``precision`` into the workload's overrides unless
    they set it (explicit wins)."""
    overrides.setdefault("precision", run.precision)
    return overrides


# --- the workloads -----------------------------------------------------------


def run_hybonet(run: RunConfig, overrides: dict) -> dict:
    from hyperspace_torch.data import text as T
    from hyperspace_torch.models import hybonet

    dataset = overrides.pop("dataset", "text")
    ds, source = T.load_text(dataset, run.data_root)
    tr, te = ds.split(0.8, seed=run.seed)
    if "dtype" in overrides:
        overrides["dtype"] = precision_lib.parse_dtype(overrides["dtype"])
    cfg = apply_overrides(
        hybonet.HyboNetConfig(vocab_size=ds.vocab_size,
                              num_classes=ds.num_classes,
                              max_len=ds.tokens.shape[1]),
        _precision_default(run, overrides))
    model, opt, train = hybonet.init_model(cfg, run.seed, run.device)
    opt, _ = with_grad_accumulation(opt, None, run.accum)
    data = [torch.as_tensor(a, device=train.generator.device)
            for a in (tr.tokens, tr.mask, tr.labels)]

    def step(st):
        _, loss = hybonet.train_step_sampled(st.model, st.opt, st.train,
                                             *data)
        return st, loss

    if run.scan_chunk > 1:
        run = _chunk_run(run)
    stepper, spc = _chunked(run, step, live=True,
                            counters=hybonet.path_counters())
    _, loss = run_loop(run, ModuleState(model, opt, train), stepper,
                       steps_per_call=spc,
                       health_fn=_maybe_health(run, _module_health))
    with span("eval"):
        res = hybonet.evaluate(model, te)
    return {"workload": "hybonet", "source": source, "loss": float(loss),
            **res}


def run_poincare(run: RunConfig, overrides: dict) -> dict:
    _reject_accum(run, "poincare")
    from hyperspace_torch.data import wordnet
    from hyperspace_torch.kernels._support import resolve_device
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.models import poincare_embed as pe
    from hyperspace_torch.telemetry.health import make_health_fn
    from hyperspace_torch.train.checkpoint import reproject_rows

    if run.data_root:
        ds = wordnet.load_closure_tsv(run.data_root)
    else:
        ds = wordnet.synthetic_tree(depth=5, branching=4)
    cfg = apply_overrides(pe.PoincareEmbedConfig(num_nodes=ds.num_nodes),
                          _precision_default(run, overrides))
    if run.host_table:
        return _run_poincare_hosted(run, cfg, ds)
    if run.scan_chunk > 1 and cfg.sparse:
        raise SystemExit(
            "scan_chunk>1 chunks the dense step only — drop sparse=true or "
            "scan_chunk (the planned-sparse epoch is "
            "poincare_embed.train_epoch_planned_packed)")
    dev = resolve_device(run.device)
    state, opt = pe.init_state(cfg, run.seed, dev)
    pairs = torch.as_tensor(ds.pairs, dtype=torch.int64, device=dev)
    ball = PoincareBall(cfg.c)

    def project(st):
        st.table.copy_(reproject_rows(ball, st.table))
        return st

    if run.scan_chunk > 1:
        run = _chunk_run(run)
    step_fn = pe.make_train_step(cfg)
    stepper, spc = _chunked(run, lambda st: step_fn(cfg, opt, st, pairs),
                            counters=pe.path_counters())
    health_fn = _maybe_health(run, lambda: make_health_fn(
        ball, params_of=lambda st: st.table))
    state, _ = run_loop(run, state, stepper, project=project,
                        steps_per_call=spc, health_fn=health_fn)
    with span("eval"):
        res = pe.evaluate(ball.proj(state.table), ds.pairs, cfg.c)
    # the state's step is the count taken (a resumed chunked run may pass
    # run.steps)
    return {"workload": "poincare", "steps": int(state.step), **res}


def _run_poincare_hosted(run: RunConfig, cfg, ds) -> dict:
    """``host_table=1``: the packed table in host memory, trained through
    a device hot-row cache, one planned chunk a dispatch
    (``train/host_embed.py``); the master saved under
    ``<ckpt_dir>/host_table``; evaluated when it fits."""
    import os

    from hyperspace_torch.kernels._support import resolve_device
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.models import poincare_embed as pe
    from hyperspace_torch.train import host_embed as he

    if cfg.sparse or run.scan_chunk > 1:
        raise SystemExit(
            "host_table=1 IS the planned-sparse chunked path — drop "
            "sparse=true / scan_chunk (chunking is host_chunk_steps=)")
    state, opt = pe.init_state(cfg, run.seed, resolve_device(run.device))
    trainer = he.HostPlannedTrainer.from_state(
        cfg, opt, state, chunk_steps=run.host_chunk_steps,
        hot_rows=run.hot_rows, seed=run.seed,
        gather_ahead=run.host_gather_ahead,
        profile=bool(run.profile_steps))
    del state
    trainer.run(ds.pairs, run.steps)
    if run.ckpt_dir:
        # one bounded block a shard, never the whole table in one array
        trainer.master.save_sharded(os.path.join(run.ckpt_dir,
                                                 "host_table"))
    if cfg.num_nodes > he.EVAL_MAX_ROWS:
        # the saved master is the product of a table past one card
        return {"workload": "poincare", "steps": int(trainer.step),
                "host_table": True, "eval_skipped": "beyond-hbm"}
    state = trainer.to_state()
    with span("eval"):
        res = pe.evaluate(PoincareBall(cfg.c).proj(state.table), ds.pairs,
                          cfg.c)
    return {"workload": "poincare", "steps": int(state.step),
            "host_table": True, **res}


def run_hvae(run: RunConfig, overrides: dict) -> dict:
    from hyperspace_torch.data import mnist as M
    from hyperspace_torch.models import hvae
    from hyperspace_torch.telemetry.health import make_health_fn

    ds, source = M.load_mnist(run.data_root)
    if "conv_features" in overrides:
        overrides["conv_features"] = tuple(
            int(f) for f in overrides["conv_features"].split(",") if f)
    if "dtype" in overrides:
        overrides["dtype"] = precision_lib.parse_dtype(overrides["dtype"])
    cfg = apply_overrides(hvae.HVAEConfig(image_size=ds.images.shape[1]),
                          _precision_default(run, overrides))
    model, opt, state = hvae.init_model(cfg, run.seed, run.device)
    # a wrapped optimizer has another state: the old one is not reused
    opt, opt_state = with_grad_accumulation(opt, state.params, run.accum)
    state = state._replace(opt_state=opt_state)
    x_all = torch.as_tensor(ds.images, dtype=cfg.dtype,
                            device=state.step.device)
    if run.scan_chunk > 1:
        run = _chunk_run(run)
    step = hvae.chunk_step(model, opt)
    chunk_fn, spc = _chunked(run, lambda st: step(st, x_all))
    last = {}

    def stepper(st):
        st, out = chunk_fn(st)          # [3] or [K, 3]: loss, recon, kl
        rows = out.reshape(-1, 3)
        last["recon_kl"] = rows[-1, 1:]  # read once, after the run
        return st, rows[:, 0] if spc > 1 else rows[0, 0]

    state, loss = run_loop(run, state, stepper, steps_per_call=spc,
                           health_fn=_maybe_health(run, make_health_fn))
    recon, kl = (last["recon_kl"].tolist() if last
                 else [math.nan, math.nan])
    gen = torch.Generator(device=x_all.device).manual_seed(1)
    with span("eval"):
        iwae = hvae.iwae_bound(model, state.params, x_all[:256], gen, k=16)
    return {"workload": "hvae", "source": source, "loss": float(loss),
            "recon": recon, "kl": kl, "iwae": float(iwae)}


def run_product(run: RunConfig, overrides: dict) -> dict:
    _reject_accum(run, "product")
    from hyperspace_torch.data import wordnet
    from hyperspace_torch.kernels._support import resolve_device
    from hyperspace_torch.models import product_embed as pme
    from hyperspace_torch.telemetry.health import health_stats
    from hyperspace_torch.train.checkpoint import reproject_rows

    if run.data_root:
        ds = wordnet.load_closure_tsv(run.data_root)
    else:
        ds = wordnet.synthetic_tree(depth=5, branching=3)
    if "factors" in overrides:
        overrides["factors"] = tuple(
            (str(k), int(d)) for k, d in json.loads(overrides["factors"]))
    cfg = apply_overrides(pme.ProductEmbedConfig(num_nodes=ds.num_nodes),
                          _precision_default(run, overrides))
    dev = resolve_device(run.device)
    state, curv_opt = pme.init_state(cfg, run.seed, dev)
    pairs = torch.as_tensor(ds.pairs, dtype=torch.int64, device=dev)
    if run.scan_chunk > 1:
        run = _chunk_run(run)
    stepper, spc = _chunked(
        run, lambda st: pme.train_step(cfg, curv_opt, st, pairs))

    def project(st):
        # onto the manifold of the restored curvatures
        m = pme.build_manifold(cfg, st.params.c_raw)
        st.params.table.copy_(reproject_rows(m, st.params.table))
        return st

    def product_health():
        # the manifold of the learned curvatures, rebuilt each check
        return lambda st: health_stats(
            st.params.table, pme.build_manifold(cfg, st.params.c_raw))

    state, _ = run_loop(run, state, stepper, project=project,
                        steps_per_call=spc,
                        health_fn=_maybe_health(run, product_health))
    with span("eval"):
        res = pme.evaluate(cfg, state.params, ds.pairs)
    return {"workload": "product", **res,
            "curvatures": pme.curvatures(cfg, state.params)}


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


# the neighbour-sampled mode's keys (configs/hgcn_sampled_nc.yaml)
_SAMPLED_KEYS = ("fanouts", "batch", "plan_steps")


def run_hgcn(run: RunConfig, overrides: dict) -> dict:
    from hyperspace_torch.data import graphs as G
    from hyperspace_torch.kernels._support import resolve_device
    from hyperspace_torch.models import hgcn

    _reject_accum(run, "hgcn")
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
    if task == "lp":
        split = G.split_edges(edges, num_nodes, x, seed=run.seed,
                              cluster_min_pair=cmp_, cache=gc)
        graph = split.graph
        model, opt, train = hgcn.init_lp(cfg, graph, seed=run.seed,
                                         device=dev)
        ga = G.to_device(graph, dev)
        train_pos = G.index_tensor(split.train_pos, dev)

        def step(st):
            _, loss = hgcn.train_step_lp(st.model, st.opt, num_nodes,
                                         st.train, ga, train_pos)
            return st, loss
    else:
        tr, va, te = G.node_split_masks(num_nodes, seed=run.seed)
        graph = G.prepare(edges, num_nodes, x, labels=labels,
                          num_classes=ncls, train_mask=tr, val_mask=va,
                          test_mask=te, cluster_min_pair=cmp_, cache=gc)
        model, opt, train = hgcn.init_nc(cfg, graph, seed=run.seed,
                                         device=dev)
        ga = G.to_device(graph, dev)
        lab, mask = hgcn.nc_targets(graph, dev)

        def step(st):
            _, loss = hgcn.train_step_nc(st.model, st.opt, st.train, ga, lab,
                                         mask)
            return st, loss
    if run.scan_chunk > 1:
        run = _chunk_run(run)
    stepper, spc = _chunked(run, step, live=True,
                            counters=hgcn.path_counters())
    _, loss = run_loop(run, ModuleState(model, opt, train), stepper,
                       steps_per_call=spc,
                       health_fn=_maybe_health(run, _module_health))
    with span("eval"):
        res = (hgcn.evaluate_lp(model, split, "test", ga=ga) if task == "lp"
               else hgcn.evaluate_nc(model, graph, ga=ga))
    return {"workload": "hgcn", "task": task, "dataset": dataset,
            "source": source, "loss": float(loss), **res,
            "prep": graph.prep, "seconds": time.perf_counter() - t0}


WORKLOADS = {"hybonet": run_hybonet, "poincare": run_poincare,
             "hvae": run_hvae, "hgcn": run_hgcn, "product": run_product}


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
    check_ported(run)
    if run.metrics_out and run.metrics_every <= 0:
        raise SystemExit(f"metrics_every={run.metrics_every}: want a "
                         "positive snapshot cadence in seconds")
    if run.rollback > 0 and not run.ckpt_dir:
        raise SystemExit("rollback=N needs ckpt_dir= — the divergence "
                         "guard rewinds to the last committed checkpoint")
    from hyperspace_torch.resilience import faults
    from hyperspace_torch.telemetry import cli_session

    try:
        chaos_armed = faults.install_chaos(run.chaos, run.chaos_seed)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    try:
        # the tracer comes up before the workload, so the host prep's
        # spans record too; the trace is dumped even if the run raises
        with cli_session(run.telemetry, run.trace_out):
            result = WORKLOADS[args.workload](run, wl_overrides)
        if chaos_armed:
            result["chaos"] = faults.stats()
    finally:
        if chaos_armed:    # an in-process caller never inherits them
            faults.clear()
    print(json.dumps(_json_safe(result)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""HGCN link-prediction throughput (counterpart of
``hyperspace_tpu/benchmarks/hgcn_bench.py``, ``step="pairs"``).

Samples/s = nodes × steps / time: one full-graph step processes every
node once (the HGCN convention).  Without the ogbn-arxiv files the graph
is the JAX bench's synthetic hierarchy at exactly arxiv scale (169,343
nodes, 1.166 M directed edges, 128 features), community-reordered, split
2% / 2% for validation and test.

    python -m hyperspace_torch.benchmarks.hgcn_bench [--steps 10]
        [--num-nodes 169343] [--device cuda]

prints one JSON object.  The defaults are the JAX bench's: float32
compute, bf16 edge messages and bf16 training decoder pass,
``hidden_dims=(128, 32)``, Lorentz, mean aggregation.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Any

import torch

from hyperspace_torch.data import graphs as G
from hyperspace_torch.kernels._support import resolve_device
from hyperspace_torch.models import hgcn
from hyperspace_torch.precision import parse_dtype

ARXIV_NODES = 169_343
ARXIV_EDGES = 1_166_243
ARXIV_FEATS = 128
ARXIV_CLASSES = 40


def arxiv_scale_graph(num_nodes: int = ARXIV_NODES, seed: int = 0):
    """Synthetic hierarchy at ogbn-arxiv edge density (the edge count
    scales with ``num_nodes``).  Returns (edges, x, labels, num_classes)."""
    n_edges = ARXIV_EDGES * num_nodes / ARXIV_NODES
    extra = (n_edges - (num_nodes - 1) * 3) / num_nodes
    return G.synthetic_hierarchy(
        num_nodes=num_nodes, branching=3, feat_dim=ARXIV_FEATS,
        ancestor_hops=3, extra_edge_frac=max(extra, 0.0),
        num_classes=ARXIV_CLASSES, seed=seed)


def arxiv_scale_split(num_nodes: int = ARXIV_NODES, seed: int = 0,
                      reorder: str | None = "community",
                      cluster_min_pair: int = 256):
    """:func:`arxiv_scale_graph` relabeled by ``reorder`` and split for
    LP; returns (split, x)."""
    edges, x, labels, _ = arxiv_scale_graph(num_nodes, seed)
    if reorder:
        edges, x, labels, _ = G.apply_locality_order(edges, x, labels,
                                                     method=reorder)
    split = G.split_edges(edges, num_nodes, x, val_frac=0.02, test_frac=0.02,
                          seed=seed, pad_multiple=65536,
                          cluster_min_pair=cluster_min_pair)
    return split, x


@dataclasses.dataclass
class LPSetup:
    """Everything a timed LP run needs, built once on one device."""

    cfg: hgcn.HGCNConfig
    split: G.LinkSplit
    model: hgcn.HGCNLinkPred
    opt: hgcn.AdamW
    state: hgcn.TrainState
    ga: G.DeviceGraph
    pos: hgcn.PlannedPairs
    neg_u: torch.Tensor
    neg_plan: tuple
    num_nodes: int
    device: torch.device
    prep_s: float  # host preparation seconds (graph, split, plans)

    def step(self, neg_v=None):
        self.state, loss = hgcn.train_step_lp_pairs(
            self.model, self.opt, self.num_nodes, self.state, self.ga,
            self.pos, self.neg_u, self.neg_plan, neg_v=neg_v)
        return loss


def setup_lp(num_nodes: int = ARXIV_NODES, *, device="cuda",
             dtype: str = "float32", agg_dtype: str | None = "bfloat16",
             decoder_dtype: str | None = "bfloat16", seed: int = 0,
             split: G.LinkSplit | None = None) -> LPSetup:
    """The bench's config, graph, model and step inputs on ``device``
    (``split`` reuses an already prepared split)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if split is None:
        split, _ = arxiv_scale_split(num_nodes, seed=seed,
                                     cluster_min_pair=G.cluster_min_pair_for(
                                         False))
    num_nodes = split.graph.num_nodes
    cfg = hgcn.HGCNConfig(
        feat_dim=split.graph.x.shape[1], hidden_dims=(128, 32),
        kind="lorentz", dtype=parse_dtype(dtype),
        agg_dtype=parse_dtype(agg_dtype),
        decoder_dtype=parse_dtype(decoder_dtype))
    pos_host = split.train_pos
    neg_u, neg_plan = hgcn.make_static_negatives(
        num_nodes, len(pos_host) * cfg.neg_per_pos, seed=seed, device=dev)
    pos = hgcn.make_planned_pairs(pos_host, num_nodes, dev)
    prep_s = time.perf_counter() - t0
    model, opt, state = hgcn.init_lp(cfg, split.graph, seed=seed, device=dev)
    ga = G.to_device(split.graph, dev)
    return LPSetup(cfg, split, model, opt, state, ga, pos, neg_u, neg_plan,
                   num_nodes, dev, prep_s)


def card_name() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_hgcn_bench(steps: int = 10, warmup: int = 1,
                   num_nodes: int = ARXIV_NODES, *, device="cuda",
                   dtype: str = "float32", agg_dtype: str = "bfloat16",
                   decoder_dtype: str | None = "bfloat16",
                   setup: LPSetup | None = None) -> dict[str, Any]:
    """Time ``steps`` training steps after ``warmup`` untimed ones.

    Returns samples/s (``num_nodes × steps / time``), the step time, the
    loss of every step, ``frac_clustered``, the host preparation
    seconds and the device (with the card's name and power limit on
    CUDA).  ``setup`` reuses a prepared :class:`LPSetup`."""
    if setup is None:
        setup = setup_lp(num_nodes, device=device, dtype=dtype,
                         agg_dtype=agg_dtype, decoder_dtype=decoder_dtype)
    dev = setup.device
    warm = [setup.step() for _ in range(warmup)]
    _sync(dev)
    t0 = time.perf_counter()
    losses = [setup.step() for _ in range(steps)]
    _sync(dev)
    elapsed = time.perf_counter() - t0
    cs = setup.split.graph.cluster_split
    return {
        "metric": "hgcn_samples_per_sec",
        "value": setup.num_nodes * steps / elapsed,
        "unit": "samples/s",
        "step_ms": elapsed / steps * 1e3,
        "steps": steps,
        "warmup_losses": [float(x) for x in warm],
        "losses": [float(x) for x in losses],
        "num_nodes": setup.num_nodes,
        "num_edges_padded": int(setup.split.graph.senders.shape[0]),
        "train_pairs": int(setup.pos.u.shape[0]),
        "frac_clustered": None if cs is None else cs.frac_clustered,
        "host_prep_s": setup.prep_s,
        "device": str(dev),
        "card": card_name() if dev.type == "cuda" else None,
        "dtype": str(setup.cfg.dtype), "agg_dtype": str(
            setup.cfg.agg_dtype), "decoder_dtype": str(
                setup.cfg.decoder_dtype),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--num-nodes", type=int, default=ARXIV_NODES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_hgcn_bench(args.steps, args.warmup, args.num_nodes,
                         device=args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

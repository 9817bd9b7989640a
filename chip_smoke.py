#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths, its
Poincaré ops, its Poincaré-embedding trainer, HGCN node classification,
the hyperbolic VAE and HGCN through its CLI from graphs on disk on one
GPU and check them.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises and exits non-zero; nothing is caught; each
prints its seconds):

1. require CUDA; print the card's name and power limit;
2. build every kernel of the paths from ``hyperspace_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
3. hold each serving kernel against its plain PyTorch version on the
   card, at the shapes the serving path gives it and at the full table;
4. the serving path: a Poincaré table of WordNet-noun size (82,115 × 10,
   c = 1, made from ``--seed``) and its hyperboloid lift are exported as
   artifacts, loaded back, and served through the ``serve`` JSONL loop
   (``topk`` at buckets 8 and 1024, ``score`` with ``prob``, ``stats``)
   with both scan modes; the answers are checked against each other and
   against a float64 brute force on the CPU, and every serving kernel's
   launch count must have risen during this phase;
5. the training data: the HGCN link-prediction bench's synthetic
   hierarchy at ogbn-arxiv scale (169,343 nodes), community-reordered,
   split, with its cluster split and the clustered edges' row plan (host
   preparation, timed on its own; the row plan's build again alone);
6. hold each scatter kernel against its plain version on the card at the
   training path's shapes (the real straggler, clustered and decoder
   edge sets), plus an input with empty rows and padding edges, the
   straggler and decoder sets from an unaligned data_ptr, 3,000 edges
   over all 169,343 rows and no edge at all; ``csr_segment_sum`` and
   ``cluster_aggregate`` launched twice must give the same bits, the
   latter with the step's row plan and, built on the card, without;
7. the training path: ``run_hgcn_bench`` (bf16 edge messages and decoder
   pass, hidden (128, 32), Lorentz) for one warm-up and 10 timed steps;
   every loss finite, the last timed loss below the first, and the
   launch counts must rise by steps × 7 (``csr_segment_sum``) and
   steps × 4 (``cluster_aggregate``), with no row plan built in the
   steps; then the device busy time, idle share and top device items of
   a step, the peak device memory, and the test ROC-AUC after the steps;
8. the whole step on the card against the port on the CPU (the plain
   versions), 2 steps each on a 20,000-node split with its cluster
   split, from the same parameters and negatives: losses within rel 2e-2;
9. the attention arm's data: phase 5's split with its cluster split
   rebuilt at the attention threshold (128 edges a pair), its row plan's
   build timed alone; the gate must be open; then
   ``csr_segment_reduce_1d`` (sum and max),
   ``csr_att_bwd_edges``, ``cluster_att_fwd`` and ``cluster_att_bwd``
   against their plain versions on the path's straggler and clustered
   edge sets at F = 128 and 32, bf16 and f32, plus inputs with empty rows
   and padding edges and with F = 8 and 130, ``csr_att_bwd_edges`` also
   on unaligned views of its rows and (d_num | d_den); and
   ``csr_segment_sum`` at the arm's widths (F + 1 = 129 and 33, bf16) on
   both edge sets; each kernel launched twice must give the same bits,
   ``cluster_att_fwd`` and ``cluster_att_bwd`` with the step's row plan
   (the subset's built on the card) and, on the path's set, the same
   bits without it;
10. the attention training path: ``run_hgcn_bench`` with ``use_att`` (lr
   3e-3, clip 1.0) for one warm-up and 10 timed steps; losses finite and
   falling, and the launch counts exactly steps × 2 for each attention
   kernel, × 7 for ``csr_segment_sum`` and 0 for ``cluster_aggregate``,
   with no row plan built in the steps;
   the device busy time, idle share, top device items, peak memory and
   test ROC-AUC;
11. two attention steps on the card against the CPU on phase 8's split,
   its cluster split at 128 with the gate held open on both: losses
   within rel 2e-2;
12. hold the HyboNet kernels (flash attention forward, dq, dk/dv and
   ``hyp_mlr``) against their plain versions at the three HyboNet
   entry points' shapes (the bench leg, the long-context leg, the CLI
   config), with padded sequences (query rows with no valid key) and an
   extra case whose lengths are not a tile multiple: forward output and
   lse; dq, dk, dv and dτ of the whole Function against autograd of the
   dense twin (dτ against its float64 twin), for an output cotangent
   drawn from a generator seeded from ``--seed``, each held norm-wise
   (largest error over the case's largest entry) as the JAX package
   holds its own kernel; MLR logits at those shapes and at HGCN node
   classification's head ([169,343, 40, 32], and 1,003 rows), launched
   twice for the same bits;
13. the HyboNet bench legs (``workloads_bench``: ``hybonet`` and
   ``hybonet_long``): step ms, tokens/s, device busy ms and idle share,
   peak memory, the largest device items, and each kernel's launch count
   (exactly layers, layers, layers and 1 a step);
14. the CLI, ``cli.train hybonet --yaml configs/hybonet_textclf.yaml``
   at its 500 steps: loss and accuracy; the last loss finite and below
   the first;
15. two HyboNet steps on the card against the port on the CPU from the
   same parameters and batches: losses within rel 1e-4 (all f32);
16. the approximate serving lanes (run right after phase 4): an
   82,115 × 10 Poincaré table of 512 clusters (bench.py's IVF
   generator, from ``--seed``), its IVF index built on the card with the
   export defaults (``ncells`` auto = 287, 8 iterations, seed 0, balance
   2) and its PQ payload (m = 3), exported and loaded back; the build
   seconds;
17. hold ``scan_topk_cand`` and ``scan_topk_pq`` against their plain
   versions on the card: the candidate lists of nprobe 1 and 8 at
   k = 10 and 256, a 37-wide list with pads in mid-list, a query with no
   candidate and k above the reachable, queries off the table without
   ``exclude_self``, hyperboloid rows, and two ids at one distance with
   the lower id at the later position, in different splits of 8
   queries (the earlier position must come first); the ADC scan at the
   path's m = 3,
   k = 170, at m = 8, k = 256, and with ``col0`` and ``n`` cut; both
   slab scans at the path's shapes on an insertion storm (every row
   nearer than all before it) and on identical rows or codes, whose ids
   must equal the plain version's and be the lowest k columns; each
   launched twice must give the same bits;
18. the lanes through the ``serve`` loop: f32 exact, nprobe 1, 2, 4, 8,
   PQ, and PQ with nprobe 8, each under ``two_stage`` and ``fused``,
   the counts set to 0 before each run and read after: exactly one
   ``scan_topk_cand`` a batch under IVF fused, one ``scan_topk_pq`` a
   batch under PQ fused, none under two-stage; the two modes
   rank-identical; every PQ distance the f32 distance of its id;
   recall@10 of each lane against the f32 exact answers;
19. queries/s and batch latency at bucket 1024, k = 10, for each lane
   but PQ with IVF, both modes, with the card's busy time and idle share;
20. hold the Poincaré ball's seven row-wise ops and ``hyp_linear``
   against their plain versions on the card: the ops at the path shapes
   ([82,115, 10], [169,343, 128], [256, 48], [82,115, 8]) with c 1, 0.5
   and 2.3, at
   d = 7, 130 and 200, leading dims [3, 8, 48], bf16 inputs (within one
   bf16 ulp of the f32 plain version), r ∈ {−1.5, 0, 0.5, 3}, points at
   the proj margin, zero rows, a bias [d] broadcast against [n, d];
   ``hyp_linear`` at [169,343, 128] × [128, 128] and × [128, 32],
   [256, 48] × [48, 32], odd widths, 1000 → 700 (many tiles), Mx = 0
   rows, zero bias, bf16, leading dims; rtol 2e-4, atol 2e-5 (2e-4 for
   ``hyp_linear``); each launched twice must give the same bits, and the
   gradients through each Function must equal autograd of the plain
   version (to a device tensor c and r too);
21. the op path: a Riemannian update through the public ops
   (``logmap``, ``expmap``, ``ptransp``, ``expmap0``,
   ``mobius_scalar_mul``, ``mobius_add``, ``logmap0``) at each path
   shape, the counts set to 0 before and read after (exactly one launch
   of each op a shape); points stay in the ball, and the chain matches
   the plain versions on the CPU on 2,000 rows;
22. the layer path at arxiv width: HypLinear(128) → HypAct(ball c = 1 →
   ball c = 0.5, relu) → HypLinear(32) on 169,343 ball points, loss the
   mean squared distance to targets; card against the port on the CPU
   on 20,000 rows from the same parameters (loss and gradients within
   rel 1e-4, all f32); one warm-up and 10 AdamW steps: losses finite
   and falling, exactly 2 ``hyp_linear`` launches a forward; step ms,
   device busy time, idle share and peak memory;
23. print the kernels line (device times of each kernel and its plain
   version at the main paths' shapes, bounds, launches, the library
   call's time, ``csr_segment_sum`` also at the attention arm's widths:
   for flash dq and dk/dv together, the one backward call
   of ``scaled_dot_product_attention``; their blocks an SM and parts;
   for the two slab scans the scan kernel and the split merge apart),
   the top-k throughput at bucket 1024 (batches of cold ids
   through the batcher, the engine call alone, and the card's busy
   share), the launch floor (``floor_ms``: an empty kernel's device time,
   ``benchmarks/launch_floor.py``), the ``nvidia-smi`` line, and finally
   ``{"ok": true, "device": {...}}``; the times are taken before phases
   24-29, which run last, and the kernels line gains their shapes
   (``*_pe_*`` keys: device ms, plain ms, bound ms, ``index_add_``'s ms
   for the segment sum, launches on the path and a step);
24. Poincaré embeddings (``models/poincare_embed.py``) on the card against
   the CPU: 5 explicit-batch steps of every path (dense, mined, sparse,
   planned, packed) with RSGD and RAdam on a depth-3 tree from one start
   read by ``state_from_jax``: tables within rel 1e-4;
25. the path's kernels at its shapes against their plain versions,
   launched twice for the same bits: ``pdist`` at [1024, 66,430, 10]
   (queries are table rows, as in ``evaluate``: the self column is held
   within 1e-2, apart), ``scan_topk`` on a 64-row mining pool with
   duplicated rows (their lower slot first), ``expmap`` at [66,430, 10]
   and [12,288, 10], ``ptransp`` at [597,871, 10] and [12,288, 10],
   ``csr_segment_sum`` at [12,288, 10] on a planned step's slots; then
   their device times;
26. training on the depth-5, branching-9 tree (66,430 nodes, 323,847
   pairs, 316 steps an epoch), dim 10, batch 1,024, 10 negatives, every
   strategy of ``benchmarks/poincare_bench.py`` with RAdam and with RSGD:
   an epoch (two where graphed, the first capturing), every loss finite,
   the counts exact over the last epoch (1 ``expmap`` a step, 1
   ``ptransp`` a RAdam step, 1 ``scan_topk`` a mined step, 1
   ``csr_segment_sum`` a planned step, no ``pdist``); RAdam's loss falls
   (last 50 steps' mean below the first 50's), RSGD's over 12 graphed
   dense epochs; graphed epochs bitwise equal to the same steps run
   eagerly from the same state and generator;
27. ``evaluate`` before and after RAdam's two graphed epochs: 317
   ``pdist`` launches, MAP rising, the kernel's MAP and mean rank within
   1e-3 of the plain version's on the card;
28. the bench leg (``run_poincare_bench``, 2 timed repeats): epoch seconds
   of every strategy, the headline, step ms at the depth-6 table
   (597,871 rows, RAdam), peak memory, and the device busy time and idle
   share of 20 steps of each strategy;
29. ``cli.train poincare --yaml configs/poincare_wordnet.yaml steps=300``:
   MAP, mean rank and seconds;
30. node classification's data (run after phase 22): phase 5's reordered
   graph whole, with its cluster split, 40 classes and
   ``node_split_masks`` (60 / 20 / 20 %), prepared by
   ``hgcn_bench.arxiv_scale_nc_graph``;
31. the NC path (``models/hgcn.py``: Lorentz, hidden (128, 32), bf16 edge
   messages): one warm-up and 10 timed steps, every loss finite and the
   last below the first; launches exact: 4 ``csr_segment_sum``, 4
   ``cluster_aggregate`` and 1 ``hyp_mlr`` a step, 2, 2 and 1 an
   evaluation, no row plan built (the last loss held below the first
   step's: at lr 1e-2 the first update takes most of the fall); step ms,
   nodes/s, peak memory, val/test accuracy and macro-F1, the device busy
   time, idle share and top items of a step; ``csr_segment_sum`` on the
   graph's own straggler receivers and ``cluster_aggregate`` on its own
   clustered pairs with their row plan, bf16 at F 128 and 32, each held
   against its plain version as in phase 6 and launched twice for the
   same bits; ``hyp_mlr`` on the head's
   own input (the ball image of the encoder's output), launched twice for
   the same bits: at the first step against its plain version at phase
   12's tier, after the steps (every row within f32's resolution of the
   ball's rim) no further from float64 than the plain version;
32. two NC steps on the card against two on the CPU on a 20,000-node
   graph from the same parameters: losses within rel 2e-2 (bf16 lanes);
33. the hyperbolic VAE at ``configs/hvae_mnist.yaml``'s width (hidden
   256, conv (32, 64), latent 8, batch 128, c = 1) on 4,096 synthetic
   MNIST images from ``--seed``, both latent geometries: 3 steps on the
   card and on the CPU from the same parameters, ids and ε: loss, recon,
   kl and every parameter within rel 1e-4 (f32, cuDNN's TF32 off);
34. 50 sampled steps on the card, each geometry: every loss finite, the
   last 10 steps' mean below the first 10's; the IWAE bound (k = 16, 256
   images) finite and at least the ELBO of the same 16 draws;
35. the ``hvae`` bench leg (``workloads_bench``: batch 256, latent 2),
   stepwise: step ms, images/s, device busy time, idle share, top items,
   peak memory;
36. last, after every profiled time: the bench leg's graphed chunks of 32
   steps (per-step ms, images/s), as the path runs them and again under
   cuDNN's determinism; on both geometries, a graphed chunk of 8 sampled
   steps against the same steps run eagerly from the same state and
   generator: bitwise equal under cuDNN's determinism, and within rel
   1e-5 (parameters norm-wise, metrics) without it, as the path runs;
37. ``cli.train hvae --yaml configs/hvae_mnist.yaml scan_chunk=100`` (its
   800 steps in 8 graphed chunks): loss, recon, kl, IWAE and seconds.

38. the disk layouts: ``community_power_law_graph`` at its defaults
   (ogbn-arxiv's statistics: 169,343 nodes, 1,166,243 edges, 128
   features, 40 classes, all used) written by ``write_ogb_csv_layout``
   and a Cora-sized graph (2,708 papers, 5,429 citations, 1,433 binary
   words, 7 classes) by ``write_cora_layout``, both loaded back (edges
   and labels exact, features within ``%.6g``); write and load seconds;
39. host prep on the arxiv layout: the native BFS order and edge layout
   bitwise their Python and numpy versions, each path's seconds; a
   prep-cache miss and then a hit in a cache root of the phase's own:
   identical layouts, the hit faster (every other prep in the smoke
   runs with the cache off);
40. ``cli.train hgcn --yaml configs/hgcn_arxiv_lp.yaml data_root=<arxiv
   layout> steps=12 graph_cache=false`` in this process: ``prep`` is
   ``"native"``, every logged loss finite, the last below the first;
   launches exactly 12 × (4 ``csr_segment_sum``, 4 ``cluster_aggregate``)
   plus an evaluation's 4 and 4, no row plan built; then the CLI's step
   on the identical split: step ms, samples/s, device busy time, idle
   share, top items, peak memory, and the CLI's test ROC-AUC;
41. ``train_step_lp_planned`` on that split: ``graph_edge_sqdist``'s
   [E, 33] bf16 scatter held against its plain version (and from an
   unaligned view), launched twice for the same bits; one warm-up and
   10 steps, losses finite and falling, launches exactly 6 and 4 a step;
   step ms and the device's share;
42. ``learn_c=true`` on the card against the CPU, two steps each of LP
   (pairs and plain) and NC on a 20,000-node graph of the same kind, from
   the same parameters and negatives: losses and the last layer's
   learned curvature within rel 2e-2, that curvature moved; ``hyp_mlr``
   with the learned (device) curvature against its plain version at
   phase 12's tier, ``dc`` included, launched twice for the same bits;
43. ``task=nc`` on the arxiv layout (40 classes) and ``use_att=true`` LP
   on the Cora layout through the CLI, 5 steps each: losses finite,
   launches exact (NC: 4, 4, 1 a step and 2, 2, 1 an evaluation;
   attention without a cluster split: 4 ``csr_segment_sum``, 2
   ``csr_att_bwd_edges``, 2 ``csr_segment_reduce_1d`` a step, 4
   ``csr_segment_sum`` an evaluation, no cluster kernel); then the total
   seconds.

The kernels line (phase 23) also gives ``hyp_mlr`` at the NC head's own
input (``*_nc_head`` keys: device ms, plain ms, bound, no library call)
and, for the three kernels of the NC path, their launches there, a step
and an evaluation (``launches_nc``, ``launches_per_step_nc``,
``launches_per_eval_nc``), and for the two scatter kernels their largest
error on the NC graph's edge sets (``max_abs_err_nc``); and, from
phases 38-43, the launches of each CLI path (``launches_hgcn_cli``,
``launches_planned``, ``launches_hgcn_cli_nc``,
``launches_hgcn_cli_att_cora``, each with its per-step and
per-evaluation count), ``csr_segment_sum`` at the arxiv layout's
stragglers and ``cluster_aggregate`` at its clustered pairs (F 128:
``*_hgcn_cli``: shape, ms, bound, the library call's ms, largest error),
``csr_segment_sum`` at ``graph_edge_sqdist``'s [E, 33] bf16 scatter
(``*_graph_edges_hgcn_cli``) and ``hyp_mlr`` at the NC head's shape with
the curvature as a device tensor and as a number (``ms_nc_device_c``,
``ms_nc_number_c``).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROWS, DIM, C = 82115, 10, 1.0      # BASELINE.json configs[0]: WordNet nouns
BATCH, K = 1024, 10
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM float32 outside tensor cores
TF32_FLOPS_PER_S = 495e12          # H100 SXM dense TF32 on the tensor cores
TF32_PASSES = 3                    # a 3×TF32 product: lo·hi + hi·lo + hi·hi
# kernel vs plain version, both float32: the Gram form
# cancels near d = 0 and the two sum in different orders
RTOL, ATOL = 1e-5, 1e-4
# served float32 answers vs the float64 brute force: the float32 Gram
# form's forward error grows as 1/(1 - c‖x‖²)² toward the boundary
TRUTH_RTOL, TRUTH_ATOL = 1e-3, 1e-3
REPO = os.path.dirname(os.path.abspath(__file__))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def timed_ms(torch, fn, reps: int = 20) -> float:
    """Mean time per call of ``fn`` on the card's clock (CUDA events
    around ``reps`` back-to-back calls, after one warm-up call): device
    work plus any gap the host's launch path leaves between calls."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_items(torch, fn, reps: int) -> dict:
    """Device time per call of ``fn`` by item (kernel, copy, fill) under
    ``torch.profiler`` (``benchmarks/devtime.py``): only the events that
    ran on the card, a dropped launch not read as a faster call, and a
    window whose timestamps disagree with CUDA events (a calibration
    spin timed both ways) profiled again.  ``{}`` when no window
    recorded a device event."""
    return profile_items(torch, fn, reps)[0]


def profile_items(torch, fn, reps: int) -> tuple[dict, list]:
    """(:func:`device_items`, the names of the host operators ``fn``
    ran in the same window).  Each window refused because the profiler's
    timestamps disagree with the card's clock is reported on a line of
    its own."""
    from hyperspace_torch.benchmarks.devtime import profile_window

    items, ops, windows = profile_window(torch, fn, reps)
    for win in windows:
        if items and not win["accepted"]:
            emit({"phase": "profiler_window_refused",
                  "item": max(items, key=items.get)[:80], **win})
    return items, ops


def device_ms(torch, fn, reps: int = 20) -> float:
    """Summed device time of everything ``fn`` runs on the card, per
    call: a kernel's own time, free of the host's launch overhead.  Where
    the profiler recorded nothing, the time comes from CUDA events
    instead (:func:`timed_ms`, which adds the launch path's gaps)."""
    items = device_items(torch, fn, reps)
    if items:
        return sum(items.values())
    emit({"phase": "profiler_fallback", "reps": reps})
    return timed_ms(torch, fn, reps)


def device_share(torch, fn, wall_ms: float, reps: int = 5,
                 top_n: int = 3) -> dict:
    """Device busy time per call of ``fn``, its share of ``wall_ms`` (the
    call's unprofiled wall time) and the ``top_n`` largest device items."""
    items = device_items(torch, fn, reps)
    if not items:                  # the profiler recorded nothing
        return {"device_busy_ms": None, "device_idle_share": None,
                "top_device_ms": "not measured"}
    busy = sum(items.values())
    top = sorted(items.items(), key=lambda r: -r[1])[:top_n]
    named = {}                     # names cut to 60 characters may collide
    for k, ms in top:
        named[k[:60]] = named.get(k[:60], 0.0) + ms
    # the port's own kernels sit in a top-level anonymous namespace
    # (PyTorch's in at::native::(anonymous namespace), but for the
    # backward of an indexed gather, which sits there too)
    hand = sum(ms for k, ms in items.items()
               if k.removeprefix("void ").startswith("(anonymous namespace)")
               and "::indexing_backward_kernel" not in k)
    return {"device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "hand_kernels_ms": hand, "device_items": len(items),
            "top_device_ms": named}


def scan_parts(torch, fn, reps: int = 20) -> dict:
    """Device ms of one slab top-k call (``ms``: every item it runs on
    the card) and of its scan kernel and its split merge apart."""
    items = device_items(torch, fn, reps)
    if not items:
        emit({"phase": "profiler_fallback", "reps": reps})
        return {"ms": timed_ms(torch, fn, reps), "scan_ms": None,
                "merge_ms": None}
    return {"ms": sum(items.values()),
            "scan_ms": sum(v for k, v in items.items() if "scan_" in k),
            "merge_ms": sum(v for k, v in items.items() if "merge" in k)}


def bound_ms(nbytes: float, flops: float,
             tf32_flops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take: the bytes over the memory
    rate or the operations over their peak rates (``flops`` in f32
    outside the tensor cores, ``tf32_flops`` on them), the larger."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = (flops / F32_FLOPS_PER_S + tf32_flops / TF32_FLOPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# float32 operations per distance beyond the 2·D of the Gram product:
# the clamps and products of the closed form, sqrt, log1p and the final
# division
_CLOSED_FORM_FLOPS = 15


def pdist_cost(n: int, m: int, d: int) -> tuple[float, float]:
    """(bytes, operations) of an [n, m] distance matrix: inputs read and
    the output written once; each row's squared norm taken once."""
    return (4.0 * (n * d + m * d + n * m),
            float(n) * m * (2 * d + _CLOSED_FORM_FLOPS) + 2.0 * (n + m) * d)


def scan_cost(b: int, m: int, n: int, d: int, k: int) -> tuple[float, float]:
    """(bytes, operations) of a top-k scan of ``b`` queries over an
    ``m``-row slab of which ``n`` rows are real: the table, queries and
    query ids read once, the [b, k] answer written once; the distances
    to the real rows only."""
    return (4.0 * (m * d + b * d + b) + 8.0 * b * k,
            float(b) * min(n, m) * (2 * d + _CLOSED_FORM_FLOPS)
            + 2.0 * (b + m) * d)


# --- the training path: HGCN link prediction at ogbn-arxiv scale ------------

TRAIN_STEPS = 10
LAUNCHES_PER_STEP = {"csr_segment_sum": 7, "cluster_aggregate": 4}
CARD_CPU_NODES = 20_000
CARD_CPU_RTOL = 2e-2        # bf16 lanes: docs/precision.md's loss budget
F32_EPS = 2.0 ** -24


def bf16_ulp(torch, x):
    """One bf16 ulp of each (float32) entry of ``x``; 0 where x is 0."""
    _, e = torch.frexp(x)
    ulp = torch.ldexp(torch.ones_like(x), (e - 8).to(torch.int32))
    return torch.where(x == 0, torch.zeros_like(x), ulp)


def check_scatter(torch, kernel, label, got, want, order_bound,
                  again=None) -> float:
    """Hold a scatter kernel's output against its plain version's, both
    in the output type: f32 at rtol = atol = 1e-5; bf16 within one bf16
    ulp of the plain result plus ``order_bound`` (both sum the same f32
    terms, in other orders: 2·k·2^-24·Σ|term| per row).  ``again``, a
    second launch on the same input, must give the same bits."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{kernel} {label}: {got.dtype} {got.shape} "
                             f"vs {want.dtype} {want.shape}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if got.dtype == torch.bfloat16:
        tol = bf16_ulp(torch, w) + order_bound
    else:
        tol = 1e-5 + 1e-5 * w.abs()
    over = int((diff > tol).sum())
    worst = float(diff.max()) if diff.numel() else 0.0
    bitwise = again is None or bool(torch.equal(got, again))
    emit({"phase": "check", "kernel": kernel, "case": label,
          "shape": list(got.shape), "dtype": str(got.dtype),
          "max_abs_err": worst, "over_tolerance": over,
          **({} if again is None else {"repeat_bitwise_equal": bitwise})})
    if over or not bitwise:
        raise AssertionError(f"{kernel} {label}: {over} entries beyond "
                             f"tolerance, repeat bitwise equal: {bitwise}")
    return worst


def check_segsum(torch, gen, label, recv, n, f, dtype, n_real=None) -> float:
    """``csr_segment_sum`` on random values over ``recv`` (zero past
    ``n_real``; a negative ``n_real`` the same from a view one element
    into its storage, an unaligned data_ptr) against its plain version,
    launched twice."""
    from hyperspace_torch.kernels.segment import (csr_segment_sum,
                                                  csr_segment_sum_plain)

    e, off = recv.shape[0], int(n_real is not None and n_real < 0)
    flat = torch.randn(e * f + off, generator=gen, device=recv.device)
    vals = flat.to(dtype)[off:].view(e, f)
    if n_real is not None:
        vals[abs(n_real):] = 0         # padding edges carry zero values
    got = csr_segment_sum(vals, recv, None, n)
    again = csr_segment_sum(vals, recv, None, n)
    torch.cuda.synchronize()
    want = csr_segment_sum_plain(vals, recv, n)
    k = torch.bincount(recv.long(), minlength=n).float()[:, None]
    bound = 2.0 * k * F32_EPS * csr_segment_sum_plain(vals.float().abs(),
                                                      recv, n)
    return check_scatter(torch, "csr_segment_sum", label, got, want, bound,
                         again)


def check_cluster(torch, gen, label, agg, n, f, dtype) -> float:
    """``cluster_aggregate`` on random h over the clustered pairs of
    ``agg`` (a device graph's cluster split) as the step calls it, with
    its row plan, launched twice and once with the plan built on the
    card, against its plain version."""
    from hyperspace_torch.kernels.cluster import (cluster_aggregate,
                                                  cluster_aggregate_plain)

    h = torch.randn(n, f, generator=gen, device=agg.c_recv.device).to(dtype)
    got = cluster_aggregate(h, agg.c_wf, agg.c_recv, agg.c_send, None, n,
                            rows=agg.c_rows)
    again = cluster_aggregate(h, agg.c_wf, agg.c_recv, agg.c_send, None, n,
                              rows=agg.c_rows)
    built = cluster_aggregate(h, agg.c_wf, agg.c_recv, agg.c_send, None, n)
    torch.cuda.synchronize()
    if not torch.equal(got, built):
        raise AssertionError(f"cluster_aggregate F={f}: the plan built on "
                             "the card gives other bits")
    want = cluster_aggregate_plain(h, agg.c_wf, agg.c_recv, agg.c_send, n)
    w_used = agg.c_wf.to(dtype).float()     # bf16 h: rounded weights
    k = torch.bincount(agg.c_recv.long(), minlength=n).float()[:, None]
    bound = 2.0 * k * F32_EPS * cluster_aggregate_plain(
        h.float().abs(), w_used.abs(), agg.c_recv, agg.c_send, n)
    return check_scatter(torch, "cluster_aggregate", f"{label} F={f}",
                         got, want, bound, again)


def segment_cost(e: int, f: int, n: int, size: int) -> tuple[float, float]:
    """(bytes, operations) of a sorted segment sum: values and receivers
    read once, the [n, f] output written once; one add per value."""
    return (float(e) * f * size + 4.0 * e + float(n) * f * size,
            float(e) * f)


def cluster_cost(e: int, f: int, n: int, size: int,
                 receiver_ids: bool = False) -> tuple[float, float]:
    """(bytes, operations) of the cluster aggregation: h read once, the
    least input that defines the sum (a sender and a weight an edge, a
    row pointer a row), the output written once; one multiply-add per
    edge and column.  ``receiver_ids``: the count before the row plan,
    12 B an edge (receiver, sender, weight) and no row pointer."""
    ids = 12.0 * e if receiver_ids else 8.0 * e + 4.0 * (n + 1)
    return (2.0 * n * f * size + ids, 2.0 * e * f)


def train_path(torch, args, card: dict) -> dict:
    """Phases 5–8; returns what the kernels line needs."""
    from hyperspace_torch.benchmarks import hgcn_bench as B
    from hyperspace_torch.kernels import cluster as KC
    from hyperspace_torch.kernels.cluster import (build_cluster_rows,
                                                  build_cluster_split,
                                                  cluster_aggregate)
    from hyperspace_torch.kernels.segment import csr_segment_sum
    from hyperspace_torch.models import hgcn

    dev = torch.device("cuda")
    # --- phase 5: the training data ------------------------------------
    # the reordered graph is kept: node classification (phase 30) trains
    # on the whole of it
    t0 = time.perf_counter()
    graph = B.arxiv_scale_reordered(seed=args.seed)
    graph_s = time.perf_counter() - t0
    split, _ = B.arxiv_scale_split(seed=args.seed, graph=graph)
    split_s = time.perf_counter() - t0 - graph_s
    setup = B.setup_lp(device=dev, seed=args.seed, split=split)
    agg, n = setup.ga.cluster, setup.num_nodes
    cs = setup.split.graph.cluster_split
    if cs is None:
        raise AssertionError("no cluster split at arxiv scale")
    n_strag = int(cs.s_mask.sum())
    t1 = time.perf_counter()
    build_cluster_rows(cs.c_recv, cs.c_send, n, with_rev=True)
    # host_prep_s counts what it counted when setup_lp built the split
    # itself: the graph, the split and the pairs; graph_s and split_s are
    # its first two parts
    emit({"phase": "train_setup",
          "host_prep_s": graph_s + split_s + setup.prep_s,
          "graph_s": graph_s, "split_s": split_s,
          "row_plan_s": time.perf_counter() - t1,
          "seconds": time.perf_counter() - t0, "nodes": n,
          "edges_padded": int(setup.split.graph.senders.shape[0]),
          "edges_real": setup.split.graph.num_edges,
          "frac_clustered": cs.frac_clustered,
          "clustered_edges": len(cs.c_recv),
          "straggler_edges": n_strag,
          "straggler_edges_padded": len(cs.s_recv),
          "train_pairs": int(setup.pos.u.shape[0]),
          "max_in_degree": int(setup.split.graph.deg.max())})

    # --- phase 6: the scatter kernels against their plain versions -----
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 1)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    err = {"csr_segment_sum": 0.0, "cluster_aggregate": 0.0}

    def seg_case(label, recv, f, dtype, n_real=None):
        err["csr_segment_sum"] = max(err["csr_segment_sum"], check_segsum(
            torch, gen, label, recv, n, f, dtype, n_real))

    bf16, f32 = torch.bfloat16, torch.float32
    seg_case("stragglers", agg.s_recv, 128, bf16, n_strag)
    seg_case("stragglers", agg.s_recv, 32, bf16, n_strag)
    seg_case("decoder u", setup.pos.u, 33, bf16)
    seg_case("decoder v sorted", setup.pos.v_sorted, 33, f32)
    sparse = np.sort(rng.choice(n // 3, 200_000) * 3)   # 2 rows in 3 empty
    seg_case("empty rows + padding", torch.as_tensor(np.concatenate(
        [sparse, np.full(50_000, n - 1)]).astype(np.int32), device=dev),
        33, bf16, 200_000)
    # the same edge sets from an unaligned data_ptr (a view one element
    # in), a few thousand edges over all the rows, and no edge at all
    seg_case("stragglers, unaligned view", agg.s_recv, 128, bf16, -n_strag)
    seg_case("decoder u, unaligned view", setup.pos.u, 33, bf16, -len(
        setup.pos.u))
    few = np.sort(rng.choice(n, 3_000, replace=False)).astype(np.int32)
    seg_case("3,000 edges over all rows", torch.as_tensor(few, device=dev),
             128, bf16)
    seg_case("no edge", torch.zeros(0, dtype=torch.int32, device=dev), 128,
             bf16)

    def cl_case(f, dtype):
        err["cluster_aggregate"] = max(err["cluster_aggregate"],
                                       check_cluster(torch, gen, "clustered",
                                                     agg, n, f, dtype))

    cl_case(128, bf16)
    cl_case(32, bf16)
    cl_case(128, f32)
    emit({"phase": "scatter_checks", "seconds": time.perf_counter() - t0})

    # --- phase 7: the training path --------------------------------------
    t0 = time.perf_counter()
    csr_segment_sum.launches = cluster_aggregate.launches = 0
    KC.row_plan_builds = 0
    torch.cuda.reset_peak_memory_stats()
    res = B.run_hgcn_bench(steps=TRAIN_STEPS, warmup=1, setup=setup)
    launches = {"csr_segment_sum": csr_segment_sum.launches,
                "cluster_aggregate": cluster_aggregate.launches,
                "row_plan_builds": KC.row_plan_builds}
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    emit({"phase": "train", "steps": TRAIN_STEPS, "warmup": 1,
          "warmup_loss": res["warmup_losses"], "losses": losses,
          "step_ms": res["step_ms"], "samples_per_s": res["value"],
          "launches": launches, "peak_device_memory_bytes": peak,
          "seconds": time.perf_counter() - t0, **card})
    for name, per_step in LAUNCHES_PER_STEP.items():
        if launches[name] != (TRAIN_STEPS + 1) * per_step:
            raise AssertionError(
                f"{name}: {launches[name]} launches over {TRAIN_STEPS + 1} "
                f"steps, want {per_step} a step")
    if launches["row_plan_builds"]:
        raise AssertionError(f"the steps built {launches['row_plan_builds']} "
                             "row plans; the split's should serve them all")
    if not np.all(np.isfinite(losses + res["warmup_losses"])):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    t1 = time.perf_counter()
    share = device_share(torch, setup.step, res["step_ms"], reps=3, top_n=8)
    auc = hgcn.evaluate_lp(setup.model, setup.split, "test", setup.ga)
    emit({"phase": "train_profile", "step_ms": res["step_ms"], **share,
          "test_roc_auc_after_steps": auc["roc_auc"],
          "seconds": time.perf_counter() - t1, **card})

    # --- phase 8: the whole step, card against CPU --------------------
    t0 = time.perf_counter()
    split, _ = B.arxiv_scale_split(CARD_CPU_NODES, seed=args.seed)
    g = split.graph
    g.cluster_split = build_cluster_split(   # prepare(cluster=True)'s split
        g.senders, g.receivers, g.edge_mask, g.deg, CARD_CPU_NODES,
        rev_perm=g.rev_perm)
    if not len(g.cluster_split.c_recv):
        raise AssertionError("the 20,000-node split clusters no edge")
    runs = {}
    for where in ("cuda", "cpu"):
        s = B.setup_lp(device=where, split=split, seed=args.seed)
        gen = torch.Generator().manual_seed(args.seed + 7)
        out = []
        for _ in range(2):
            neg_v = torch.randint(0, CARD_CPU_NODES, s.neg_u.shape,
                                  generator=gen, dtype=torch.int32)
            out.append(float(s.step(neg_v.to(s.device))))
        runs[where] = (out, {k: v.float().cpu() for k, v in
                             s.model.state_dict().items()})
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"][0],
                                                  runs["cpu"][0]))
    pdiff = max(float((runs["cuda"][1][k] - v).abs().max())
                for k, v in runs["cpu"][1].items())
    emit({"phase": "card_vs_cpu", "nodes": CARD_CPU_NODES,
          "frac_clustered": g.cluster_split.frac_clustered,
          "losses_cuda": runs["cuda"][0], "losses_cpu": runs["cpu"][0],
          "max_rel_loss_diff": rel, "max_param_abs_diff": pdiff,
          "seconds": time.perf_counter() - t0})
    if not rel <= CARD_CPU_RTOL:
        raise AssertionError(f"card and CPU losses differ by {rel}")
    return {"setup": setup, "launches": launches, "err": err,
            "cpu_split": split, "graph": graph}


def train_kernel_entries(torch, tr: dict, card: dict) -> list:
    """The scatter kernels' entries of the kernels line, timed at the
    training path's largest shapes on this run's inputs."""
    from hyperspace_torch.kernels.cluster import (cluster_aggregate,
                                                  cluster_aggregate_plain)
    from hyperspace_torch.kernels.segment import (csr_segment_sum,
                                                  csr_segment_sum_plain)

    setup = tr["setup"]
    agg, n, dev = setup.ga.cluster, setup.num_nodes, setup.device
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(11)

    def rand(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    r = agg.s_recv
    vals = {f: rand(r.shape[0], f) for f in (128, 32)}
    u = setup.pos.u
    vals_u = rand(u.shape[0], 33)
    v32, v32_32, vu32 = vals[128].float(), vals[32].float(), vals_u.float()
    r64, u64 = r.long(), u.long()

    def seg(v, rr):
        return lambda: csr_segment_sum(v, rr, None, n)

    sb, sby = bound_ms(*segment_cost(r.shape[0], 128, n, 2))
    seg_entry = {
        "name": "csr_segment_sum", "route": "cuda",
        "source": "hyperspace_torch/kernels/csrc/segment.cu",
        "entry": "hs_csr_segment_sum",
        "replaces": "hyperspace_tpu/kernels/segment.py:132",
        "launches": tr["launches"]["csr_segment_sum"],
        "launches_per_step": LAUNCHES_PER_STEP["csr_segment_sum"],
        "max_abs_err": tr["err"]["csr_segment_sum"],
        "shape": [r.shape[0], 128, n], "dtype": "bfloat16",
        "ms": device_ms(torch, seg(vals[128], r)),
        "plain_ms": device_ms(torch, lambda: csr_segment_sum_plain(
            vals[128], r, n)),
        "bound_ms": sb, "bound_by": sby,
        "library_ms": device_ms(torch, lambda: torch.zeros(
            (n, 128), device=dev).index_add_(0, r64, v32)),
        "library_call": "index_add_ of the f32 values into an f32 [N, F]",
        "call_ms": timed_ms(torch, seg(vals[128], r)),
        "ms_F32": device_ms(torch, seg(vals[32], r)),
        "bound_ms_F32": bound_ms(*segment_cost(r.shape[0], 32, n, 2))[0],
        "library_ms_F32": device_ms(torch, lambda: torch.zeros(
            (n, 32), device=dev).index_add_(0, r64, v32_32)),
        "ms_decoder_F33": device_ms(torch, seg(vals_u, u)),
        "bound_ms_decoder_F33": bound_ms(*segment_cost(u.shape[0], 33, n,
                                                       2))[0],
        "library_ms_decoder_F33": device_ms(torch, lambda: torch.zeros(
            (n, 33), device=dev).index_add_(0, u64, vu32)),
        **card}
    e = agg.c_recv.shape[0]
    h = {f: rand(n, f) for f in (128, 32)}
    h32 = h[128].float()
    w_csr = torch.sparse_coo_tensor(
        torch.stack([agg.c_recv.long(), agg.c_send.long()]), agg.c_wf,
        (n, n)).coalesce().to_sparse_csr()

    def clu(hh):         # as the step calls it, with its row plan
        return lambda: cluster_aggregate(hh, agg.c_wf, agg.c_recv,
                                         agg.c_send, None, n,
                                         rows=agg.c_rows)

    cb, cby = bound_ms(*cluster_cost(e, 128, n, 2))
    cl_entry = {
        "name": "cluster_aggregate", "route": "cuda",
        "source": "hyperspace_torch/kernels/csrc/cluster.cu",
        "entry": "hs_cluster_aggregate",
        "replaces": "hyperspace_tpu/kernels/cluster.py:213",
        "launches": tr["launches"]["cluster_aggregate"],
        "launches_per_step": LAUNCHES_PER_STEP["cluster_aggregate"],
        "max_abs_err": tr["err"]["cluster_aggregate"],
        "shape": [n, 128, e], "dtype": "bfloat16",
        "ms": device_ms(torch, clu(h[128])),
        "plain_ms": device_ms(torch, lambda: cluster_aggregate_plain(
            h[128], agg.c_wf, agg.c_recv, agg.c_send, n), reps=5),
        "bound_ms": cb, "bound_by": cby,
        "bound_ms_receiver_ids": bound_ms(*cluster_cost(e, 128, n, 2,
                                                        True))[0],
        "library_ms": device_ms(torch, lambda: torch.sparse.mm(w_csr, h32)),
        "library_call": "torch.sparse.mm of the f32 CSR weight matrix "
                        "and f32 h",
        "call_ms": timed_ms(torch, clu(h[128])),
        "ms_F32": device_ms(torch, clu(h[32])),
        "bound_ms_F32": bound_ms(*cluster_cost(e, 32, n, 2))[0],
        **card}
    return [seg_entry, cl_entry]


# --- the HGCN attention arm at ogbn-arxiv scale ------------------------------

ATT_LAUNCHES_PER_STEP = {"cluster_att_fwd": 2, "cluster_att_bwd": 2,
                         "csr_att_bwd_edges": 2, "csr_segment_reduce_1d": 2,
                         "csr_segment_sum": 7, "cluster_aggregate": 0}
ATT_BOUND = 30.0
ATT_SLOPE = 0.2


def att_counts() -> dict:
    from hyperspace_torch.kernels import cluster as KC
    from hyperspace_torch.kernels import segment as KS

    return {name: getattr(KC if name.startswith("cluster") else KS,
                          name).launches for name in ATT_LAUNCHES_PER_STEP}


def att_reset() -> None:
    from hyperspace_torch.kernels import cluster as KC
    from hyperspace_torch.kernels import segment as KS

    for name in ATT_LAUNCHES_PER_STEP:
        getattr(KC if name.startswith("cluster") else KS, name).launches = 0


def check_att(torch, kernel, label, got, again, want, scale, terms,
              weight_ulp=2.0 ** -23) -> float:
    """Hold an attention kernel's f32 output against its plain version's:
    within (2·terms·2^-24 + weight_ulp)·scale, where ``scale`` is the
    plain version's result on the absolute inputs (each output's absolute
    term sum) and ``terms`` the terms of each sum (the row's edge count,
    plus F + 1 where a dot product feeds it): both sum the same f32
    terms in other orders, and a weight may sit one ulp apart (one bf16
    ulp, at most 2^-7 of it, where it is rounded to bf16).  A second launch on the same input
    must give the same bits."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{kernel} {label}: {got.dtype} {got.shape} "
                             f"vs {want.dtype} {want.shape}")
    diff = (got - want).abs()
    tol = (2.0 * terms * F32_EPS + weight_ulp) * scale.abs()
    over = int((diff > tol).sum())
    worst = float(diff.max()) if diff.numel() else 0.0
    bitwise = bool(torch.equal(got, again))
    emit({"phase": "check", "kernel": kernel, "case": label,
          "shape": list(got.shape), "max_abs_err": worst,
          "over_tolerance": over, "repeat_bitwise_equal": bitwise})
    if over or not bitwise:
        raise AssertionError(f"{kernel} {label}: {over} entries beyond "
                             f"tolerance, repeat bitwise equal: {bitwise}")
    return worst


def att_path(torch, args, card: dict, tr: dict) -> dict:
    """Phases 9–11; returns what the kernels line needs."""
    from hyperspace_torch.benchmarks import hgcn_bench as B
    from hyperspace_torch.data import graphs as G
    from hyperspace_torch.kernels import cluster as KC
    from hyperspace_torch.kernels import segment as KS
    from hyperspace_torch.models import hgcn

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    # --- phase 9: phase 5's split, its cluster split at the attention
    # threshold; the four kernels against their plain versions ----------
    t0 = time.perf_counter()
    split = tr["setup"].split
    g = split.graph
    g.cluster_split = KC.build_cluster_split(
        g.senders, g.receivers, g.edge_mask, g.deg, g.num_nodes,
        min_pair_edges=G.cluster_min_pair_for(True), rev_perm=g.rev_perm)
    split_s = time.perf_counter() - t0
    setup = B.setup_lp(device=dev, split=split, seed=args.seed, use_att=True)
    agg, n = setup.ga.cluster, setup.num_nodes
    cs = g.cluster_split
    n_strag = int(cs.s_mask.sum())
    t1 = time.perf_counter()
    KC.build_cluster_rows(cs.c_recv, cs.c_send, n, with_rev=True)
    emit({"phase": "att_setup", "cluster_split_s": split_s,
          "row_plan_s": time.perf_counter() - t1,
          "seconds": time.perf_counter() - t0, "nodes": n,
          "min_pair_edges": G.cluster_min_pair_for(True),
          "frac_clustered": cs.frac_clustered, "att_ok": agg.att_ok,
          "clustered_edges": len(cs.c_recv), "straggler_edges": n_strag,
          "straggler_edges_padded": len(cs.s_recv),
          "lr": setup.cfg.lr, "clip_norm": setup.cfg.clip_norm})
    if not agg.att_ok:
        raise AssertionError(f"the attention gate is shut at arxiv scale "
                             f"(frac_clustered {cs.frac_clustered})")

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    err = {name: 0.0 for name in ("csr_segment_reduce_1d",
                                  "csr_att_bwd_edges", "cluster_att_fwd",
                                  "cluster_att_bwd", "csr_segment_sum")}

    def rand(*shape, dtype=f32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    rng = np.random.default_rng(args.seed + 2)
    sparse = np.sort(rng.choice(n // 3, 200_000) * 3)   # 2 rows in 3 empty
    sparse_r = torch.as_tensor(np.concatenate(
        [sparse, np.full(50_000, n - 1)]).astype(np.int32), device=dev)
    csr_sets = {"stragglers": (agg.s_recv, n_strag),
                "empty rows + padding": (sparse_r, 200_000)}

    def twice(fn):
        a = fn()
        b = fn()
        torch.cuda.synchronize()
        return a, b

    for label, (r, n_real) in csr_sets.items():
        k = torch.bincount(r.long(), minlength=n).float()
        v = rand(r.shape[0])
        v[n_real:] = 0                      # padding edges carry zeros
        for op in ("sum", "max"):
            got, again = twice(lambda: KS.csr_segment_reduce_1d(v, r, None,
                                                                n, op))
            want = KS.csr_segment_reduce_1d_plain(v, r, n, op)
            scale = (KS.csr_segment_reduce_1d_plain(v.abs(), r, n)
                     if op == "sum" else torch.zeros_like(want))
            err["csr_segment_reduce_1d"] = max(
                err["csr_segment_reduce_1d"], check_att(
                    torch, "csr_segment_reduce_1d", f"{label} {op}", got,
                    again, want, scale, k, 0.0))
        # B1 at the attention arm's widths: the (num | den) messages of
        # the first layer (F + 1 = 129) and of the second (33)
        for f in (129, 33):
            err["csr_segment_sum"] = max(err["csr_segment_sum"], check_segsum(
                torch, gen, f"attention {label}", r, n, f, bf16, n_real))
        # off: h and dn as views one element into their storage
        for f, dt, off in ((128, bf16, 0), (32, bf16, 0), (128, f32, 0),
                           (8, f32, 0), (130, bf16, 0), (128, bf16, 1),
                           (33, f32, 1)):
            dn = rand(n * (f + 1) + off)[off:].view(n, f + 1)
            h = rand(r.shape[0] * f + off, dtype=dt)[off:].view(-1, f)
            w = torch.rand(r.shape[0], generator=gen, device=dev) * 3
            w[n_real:] = 0
            lm = rand(r.shape[0], scale=8.0).clamp(-29.0, 29.0)
            got, again = twice(lambda: KS.csr_att_bwd_edges(
                dn, h, w, lm, r, None, n, ATT_BOUND, ATT_SLOPE))
            want = KS.csr_att_bwd_edges_plain(dn, h, w, lm, r, n, ATT_BOUND,
                                              ATT_SLOPE)
            sc = KS.csr_att_bwd_edges_plain(dn.abs(), h.abs(), w, lm, r, n,
                                            ATT_BOUND, ATT_SLOPE)
            tag = f"{label} F={f} {str(dt)[6:]}" + (", unaligned views"
                                                     if off else "")
            e0 = check_att(torch, "csr_att_bwd_edges", f"{tag} dpre",
                           got[0], again[0], want[0], sc[0], f + 1)
            e1 = check_att(torch, "csr_att_bwd_edges", f"{tag} d_alpha_r",
                           got[1], again[1], want[1], sc[1], f + 1 + k)
            err["csr_att_bwd_edges"] = max(err["csr_att_bwd_edges"], e0, e1)

    # rows 1, 2 of every 3 empty, and closed under reversal as
    # cluster_att_bwd's involution needs: both ends a multiple of 3
    every3 = ((agg.c_recv % 3) == 0) & ((agg.c_send % 3) == 0)
    # the path's set with the step's row plan; the subset's plan is built
    # on the card at each call
    c_sets = {"clustered": (agg.c_recv, agg.c_send, agg.c_rows),
              "clustered, empty rows": (agg.c_recv[every3].contiguous(),
                                        agg.c_send[every3].contiguous(),
                                        None)}
    a_s, a_r = rand(n, scale=0.7), rand(n, scale=0.7) + 0.3
    for label, (r, s_, rows) in c_sets.items():
        k = torch.bincount(r.long(), minlength=n).float()
        for f, dt in ((128, bf16), (32, bf16), (128, f32), (8, f32),
                      (130, bf16)):
            if label != "clustered" and f not in (128, 130):
                continue
            wulp = 2.0 ** -7 if dt == bf16 else 2.0 ** -23
            h = rand(n, f, dtype=dt)
            gext = rand(n, f + 1)
            tag = f"{label} F={f} {str(dt)[6:]}"
            got, again = twice(lambda: KC.cluster_att_fwd(
                h, a_s, a_r, r, s_, None, n, ATT_SLOPE, ATT_BOUND, rows=rows))
            if rows is not None:
                built = KC.cluster_att_fwd(h, a_s, a_r, r, s_, None, n,
                                           ATT_SLOPE, ATT_BOUND)
                if not torch.equal(got, built):
                    raise AssertionError(f"cluster_att_fwd {tag}: the plan "
                                         "built on the card gives other bits")
            want = KC.cluster_att_fwd_plain(h, a_s, a_r, r, s_, n, ATT_SLOPE,
                                            ATT_BOUND)
            sc = KC.cluster_att_fwd_plain(h.abs(), a_s, a_r, r, s_, n,
                                          ATT_SLOPE, ATT_BOUND)
            err["cluster_att_fwd"] = max(err["cluster_att_fwd"], check_att(
                torch, "cluster_att_fwd", tag, got, again, want, sc,
                k[:, None], wulp))
            got, again = twice(lambda: KC.cluster_att_bwd(
                gext, h, a_s, a_r, r, s_, None, n, ATT_SLOPE, ATT_BOUND,
                rows=rows))
            if rows is not None:
                built = KC.cluster_att_bwd(gext, h, a_s, a_r, r, s_, None, n,
                                           ATT_SLOPE, ATT_BOUND)
                if not all(torch.equal(a, b) for a, b in zip(got, built)):
                    raise AssertionError(f"cluster_att_bwd {tag}: the plan "
                                         "built on the card gives other bits")
            want = KC.cluster_att_bwd_plain(gext, h, a_s, a_r, r, s_, n,
                                            ATT_SLOPE, ATT_BOUND)
            sc = KC.cluster_att_bwd_plain(gext.abs(), h.abs(), a_s, a_r, r,
                                          s_, n, ATT_SLOPE, ATT_BOUND)
            for i, (part, terms, wu) in enumerate((
                    ("dh", k[:, None], wulp), ("d_alpha_s", f + 1 + k, 0.0),
                    ("d_alpha_r", f + 1 + k, 0.0))):
                err["cluster_att_bwd"] = max(err["cluster_att_bwd"],
                                             check_att(
                    torch, "cluster_att_bwd", f"{tag} {part}", got[i],
                    again[i], want[i], sc[i], terms, wu + 2.0 ** -23))
    emit({"phase": "att_checks", "seconds": time.perf_counter() - t0})

    # --- phase 10: the attention training path -------------------------
    t0 = time.perf_counter()
    att_reset()
    KC.row_plan_builds = 0
    torch.cuda.reset_peak_memory_stats()
    res = B.run_hgcn_bench(steps=TRAIN_STEPS, warmup=1, setup=setup)
    launches = {**att_counts(), "row_plan_builds": KC.row_plan_builds}
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    emit({"phase": "att_train", "steps": TRAIN_STEPS, "warmup": 1,
          "warmup_loss": res["warmup_losses"], "losses": losses,
          "step_ms": res["step_ms"], "samples_per_s": res["value"],
          "use_att": res["use_att"], "lr": res["lr"],
          "clip_norm": res["clip_norm"],
          "frac_clustered": res["frac_clustered"], "launches": launches,
          "peak_device_memory_bytes": peak,
          "seconds": time.perf_counter() - t0, **card})
    for name, per_step in ATT_LAUNCHES_PER_STEP.items():
        if launches[name] != (TRAIN_STEPS + 1) * per_step:
            raise AssertionError(
                f"attention: {name} launched {launches[name]} times in "
                f"{TRAIN_STEPS + 1} steps, want {per_step} a step")
    if launches["row_plan_builds"]:
        raise AssertionError(f"the attention steps built "
                             f"{launches['row_plan_builds']} row plans")
    if not np.all(np.isfinite(losses + res["warmup_losses"])):
        raise AssertionError(f"non-finite attention loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the attention loss did not fall: {losses}")
    t1 = time.perf_counter()
    share = device_share(torch, setup.step, res["step_ms"], reps=3, top_n=12)
    auc = hgcn.evaluate_lp(setup.model, setup.split, "test", setup.ga)
    emit({"phase": "att_profile", "step_ms": res["step_ms"], **share,
          "test_roc_auc_after_steps": auc["roc_auc"],
          "peak_device_memory_bytes": peak,
          "seconds": time.perf_counter() - t1, **card})

    # --- phase 11: two attention steps, card against CPU ---------------
    t0 = time.perf_counter()
    split20 = tr["cpu_split"]
    g20 = split20.graph
    g20.cluster_split = KC.build_cluster_split(
        g20.senders, g20.receivers, g20.edge_mask, g20.deg, CARD_CPU_NODES,
        min_pair_edges=G.cluster_min_pair_for(True), rev_perm=g20.rev_perm)
    runs = {}
    for where in ("cuda", "cpu"):
        s20 = B.setup_lp(device=where, split=split20, seed=args.seed,
                         use_att=True)
        s20.ga.cluster.use_att_cluster = True    # all four kernels run
        gen20 = torch.Generator().manual_seed(args.seed + 9)
        out = []
        for _ in range(2):
            neg_v = torch.randint(0, CARD_CPU_NODES, s20.neg_u.shape,
                                  generator=gen20, dtype=torch.int32)
            out.append(float(s20.step(neg_v.to(s20.device))))
        runs[where] = out
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"], runs["cpu"]))
    emit({"phase": "att_card_vs_cpu", "nodes": CARD_CPU_NODES,
          "frac_clustered": g20.cluster_split.frac_clustered,
          "losses_cuda": runs["cuda"], "losses_cpu": runs["cpu"],
          "max_rel_loss_diff": rel, "seconds": time.perf_counter() - t0})
    if not rel <= CARD_CPU_RTOL:
        raise AssertionError(f"attention: card and CPU losses differ by "
                             f"{rel}")
    return {"setup": setup, "launches": launches, "err": err}


def att_segsum_times(torch, at: dict) -> dict:
    """``csr_segment_sum``'s times at the attention arm's two widths: the
    (num | den) messages of the first layer (F + 1 = 129) and the second
    (33), bf16, on the attention split's straggler edges, beside their
    bounds and ``index_add_``'s time."""
    from hyperspace_torch.kernels.segment import csr_segment_sum

    setup = at["setup"]
    r, n, dev = setup.ga.cluster.s_recv, setup.num_nodes, setup.device
    gen = torch.Generator(device=dev).manual_seed(17)
    r64 = r.long()
    out = {"shape_att": [r.shape[0], n]}
    for f in (129, 33):
        v = torch.randn(r.shape[0], f, generator=gen, device=dev).to(
            torch.bfloat16)
        v32 = v.float()
        out[f"ms_att_F{f}"] = device_ms(
            torch, lambda: csr_segment_sum(v, r, None, n))
        out[f"bound_ms_att_F{f}"] = bound_ms(*segment_cost(r.shape[0], f, n,
                                                           2))[0]
        out[f"library_ms_att_F{f}"] = device_ms(torch, lambda: torch.zeros(
            (n, f), device=dev).index_add_(0, r64, v32))
    return out


def att_kernel_entries(torch, at: dict, card: dict) -> list:
    """The attention kernels' entries of the kernels line, timed at the
    attention path's shapes on this run's edge sets: the stragglers (B3,
    B5) and the clustered edges (B6) at F = 128, bf16 rows; bounds from
    the bytes each must move (inputs read once, outputs written once) or
    its f32 operations."""
    from hyperspace_torch.kernels import cluster as KC
    from hyperspace_torch.kernels import segment as KS

    setup = at["setup"]
    agg, n, dev = setup.ga.cluster, setup.num_nodes, setup.device
    gen = torch.Generator(device=dev).manual_seed(13)
    f32, bf16 = torch.float32, torch.bfloat16

    def rand(*shape, dtype=f32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    base = lambda name, entry, line, shape: {
        "name": name, "route": "cuda", "entry": entry,
        "replaces": f"hyperspace_tpu/kernels/{line}",
        "launches": at["launches"][name],
        "launches_per_step": ATT_LAUNCHES_PER_STEP[name],
        "max_abs_err": at["err"][name], "shape": shape}
    seg_src = "hyperspace_torch/kernels/csrc/segment.cu"
    cl_src = "hyperspace_torch/kernels/csrc/cluster.cu"
    r = agg.s_recv
    e = r.shape[0]
    v = rand(e)
    r64 = r.long()
    lengths = torch.bincount(r64, minlength=n)
    b3b, b3y = bound_ms(e * 8.0 + n * 4.0, float(e))
    entries = [{
        **base("csr_segment_reduce_1d", "hs_csr_segment_reduce_1d",
               "segment.py:257", [e, n]),
        "source": seg_src, "dtype": "float32", "op": "sum",
        "ms": device_ms(torch, lambda: KS.csr_segment_reduce_1d(
            v, r, None, n)),
        "plain_ms": device_ms(torch, lambda: KS.csr_segment_reduce_1d_plain(
            v, r, n)),
        "bound_ms": b3b, "bound_by": b3y,
        "library_ms": device_ms(torch, lambda: torch.zeros(
            n, device=dev).index_add_(0, r64, v)),
        "library_call": "index_add_ of the f32 values into an f32 [N]",
        "segment_reduce_ms": device_ms(torch, lambda: torch.segment_reduce(
            v, "sum", lengths=lengths)),
        "ms_max": device_ms(torch, lambda: KS.csr_segment_reduce_1d(
            v, r, None, n, "max")),
        "library_ms_max": device_ms(torch, lambda: torch.full(
            (n,), KS.NEG_FILL, device=dev).scatter_reduce_(0, r64, v,
                                                           "amax")),
        "call_ms": timed_ms(torch, lambda: KS.csr_segment_reduce_1d(
            v, r, None, n)), **card}]

    def b5_cost(f, size):
        return (e * (f * size + 16.0) + n * (4.0 * (f + 1) + 4.0),
                e * (2.0 * f + 8.0))

    dn = {f: rand(n, f + 1) for f in (128, 32)}
    hrow = {f: rand(e, f, dtype=bf16) for f in (128, 32)}
    w = torch.rand(e, generator=gen, device=dev) * 3
    lm = rand(e, scale=8.0).clamp(-29.0, 29.0)

    def b5(f):
        return lambda: KS.csr_att_bwd_edges(dn[f], hrow[f], w, lm, r, None,
                                            n, ATT_BOUND, ATT_SLOPE)

    b5b, b5y = bound_ms(*b5_cost(128, 2))
    entries.append({
        **base("csr_att_bwd_edges", "hs_csr_att_bwd_edges",
               "segment.py:392", [e, 128, n]),
        "source": seg_src, "dtype": "bfloat16 rows, f32 dn",
        "ms": device_ms(torch, b5(128)),
        "plain_ms": device_ms(torch, lambda: KS.csr_att_bwd_edges_plain(
            dn[128], hrow[128], w, lm, r, n, ATT_BOUND, ATT_SLOPE), reps=5),
        "bound_ms": b5b, "bound_by": b5y, "library_ms": None,
        "call_ms": timed_ms(torch, b5(128)),
        "ms_F32": device_ms(torch, b5(32)),
        "bound_ms_F32": bound_ms(*b5_cost(32, 2))[0], **card})

    ce = agg.c_recv.shape[0]
    h = {f: rand(n, f, dtype=bf16) for f in (128, 32)}
    gx = {f: rand(n, f + 1) for f in (128, 32)}
    a_s, a_r = rand(n, scale=0.7), rand(n, scale=0.7) + 0.3
    cr, csn = agg.c_recv, agg.c_send

    def fwd_cost(f, size, receiver_ids=False):
        # the least input: a sender an edge and a row pointer a row (before
        # the row plan: a receiver and a sender an edge); h and the two
        # scores read once, the [n, f + 1] f32 partials written once
        ids = ce * 8.0 if receiver_ids else ce * 4.0 + 4.0 * (n + 1)
        return (ids + n * (f * size + 8.0) + n * 4.0 * (f + 1),
                ce * (2.0 * f + 20.0))

    def bwd_cost(f, size, receiver_ids=False):
        # the least input: a sender an edge and a row pointer a row (before
        # the row plan: a receiver and a sender an edge); g, h and the two
        # scores read once, dh, dα_s and dα_r written once
        ids = ce * 8.0 if receiver_ids else ce * 4.0 + 4.0 * (n + 1)
        return (ids + n * (4.0 * (f + 1) + f * size + 8.0)
                + n * 4.0 * (f + 2), ce * (6.0 * f + 40.0))

    def fwd(f):          # as the step calls it, with its row plan
        return lambda: KC.cluster_att_fwd(h[f], a_s, a_r, cr, csn, None, n,
                                          ATT_SLOPE, ATT_BOUND,
                                          rows=agg.c_rows)

    def bwd(f):          # as the step calls it, with its row plan
        return lambda: KC.cluster_att_bwd(gx[f], h[f], a_s, a_r, cr, csn,
                                          None, n, ATT_SLOPE, ATT_BOUND,
                                          rows=agg.c_rows)

    fb, fby = bound_ms(*fwd_cost(128, 2))
    entries.append({
        **base("cluster_att_fwd", "hs_cluster_att_fwd", "cluster.py:401",
               [n, 128, ce]),
        "source": cl_src, "dtype": "bfloat16",
        "ms": device_ms(torch, fwd(128)),
        "plain_ms": device_ms(torch, lambda: KC.cluster_att_fwd_plain(
            h[128], a_s, a_r, cr, csn, n, ATT_SLOPE, ATT_BOUND), reps=5),
        "bound_ms": fb, "bound_by": fby, "library_ms": None,
        "bound_ms_receiver_ids": bound_ms(*fwd_cost(128, 2, True))[0],
        "call_ms": timed_ms(torch, fwd(128)),
        "ms_F32": device_ms(torch, fwd(32)),
        "bound_ms_F32": bound_ms(*fwd_cost(32, 2))[0], **card})
    bb, bby = bound_ms(*bwd_cost(128, 2))
    entries.append({
        **base("cluster_att_bwd", "hs_cluster_att_bwd", "cluster.py:575",
               [n, 128, ce]),
        "source": cl_src, "dtype": "bfloat16 h, f32 cotangent",
        "ms": device_ms(torch, bwd(128)),
        "plain_ms": device_ms(torch, lambda: KC.cluster_att_bwd_plain(
            gx[128], h[128], a_s, a_r, cr, csn, n, ATT_SLOPE, ATT_BOUND),
            reps=5),
        "bound_ms": bb, "bound_by": bby, "library_ms": None,
        "bound_ms_receiver_ids": bound_ms(*bwd_cost(128, 2, True))[0],
        "call_ms": timed_ms(torch, bwd(128)),
        "ms_F32": device_ms(torch, bwd(32)),
        "bound_ms_F32": bound_ms(*bwd_cost(32, 2))[0], **card})
    return entries


# --- the HyboNet path: text classification with flash attention -------------

# (batch, heads, L, dim) of the three entry points: workloads_bench's hybonet
# and hybonet_long legs and configs/hybonet_textclf.yaml through the CLI
HB_SHAPES = {"bench": (256, 4, 128, 128, 64),
              "long": (2, 2, 4096, 64, 4095),
              "cli": (64, 4, 32, 128, 8)}     # last: shortest sequence
# f32 kernels against their f32 plain versions (other summation orders)
FLASH_RTOL, FLASH_ATOL = 1e-4, 1e-5
LSE_TOL = 1e-5
MLR_RTOL, MLR_ATOL = 1e-4, 1e-5
# HGCN node classification's head (hyperspace_tpu/models/hgcn.py:263): the
# arxiv nodes, ogbn-arxiv's 40 classes (data/graphs.py:549-552), ball d 32
# (hidden (128, 32), configs/hgcn_sampled_nc.yaml)
MLR_NC_SHAPE = (169343, 40, 32)
# the whole Function against autograd of the dense twin: largest error
# over the largest entry, as the JAX package holds its own kernel
# (tests/kernels/test_attention.py, test_flash_backward_matches_twin);
# dτ the same way against the float64 twin, over the case: a head's dτ
# sums every pair's dσ·σ in f32 and may cancel far below its terms
FLASH_GRAD_TOL = 2e-3
HB_CARD_CPU_RTOL = 1e-4
HB_CLI_YAML = os.path.join("configs", "hybonet_textclf.yaml")


def hb_counts() -> dict:
    from hyperspace_torch.kernels import attention as A
    from hyperspace_torch.kernels.mlr import hyp_mlr

    return {"flash_fwd": A.flash_fwd.launches,
            "flash_dq": A.flash_dq.launches,
            "flash_dkv": A.flash_dkv.launches, "hyp_mlr": hyp_mlr.launches}


def hb_reset() -> None:
    from hyperspace_torch.kernels import attention as A
    from hyperspace_torch.kernels.mlr import hyp_mlr

    A.flash_fwd.launches = A.flash_dq.launches = 0
    A.flash_dkv.launches = hyp_mlr.launches = 0


def hb_inputs(torch, rng, dev, batch, heads, length, dim, min_len):
    """Attention inputs as an entry point gives them: q, k, v [B·h, L,
    dim/h + 1] on the hyperboloid, per-head β and τ, and the padding mask of
    sequences of min_len..L tokens (uint8 [B, L, L], shared by the
    heads; padded query rows have no valid key)."""
    d = dim // heads + 1
    b = batch * heads

    def rows(n):
        sp = rng.standard_normal((b, n, d - 1)) * 0.5
        t = np.sqrt(1.0 + np.sum(sp * sp, axis=-1, keepdims=True))
        return torch.as_tensor(np.concatenate([t, sp], axis=-1),
                               dtype=torch.float32, device=dev)

    lens = rng.integers(min_len, length + 1, batch)
    lens[0] = min_len
    m = np.arange(length)[None, :] < lens[:, None]
    att = m[:, None, :] & m[:, :, None]
    beta = rng.standard_normal(heads) * 0.3
    tau = 1.0 + rng.random(heads)
    f32 = dict(dtype=torch.float32, device=dev)
    return {"q": rows(length), "k": rows(length), "v": rows(length),
            "beta_h": torch.as_tensor(beta, **f32),
            "tau_h": torch.as_tensor(tau, **f32),
            "beta_b": torch.as_tensor(np.tile(beta, batch), **f32),
            "tau_b": torch.as_tensor(np.tile(tau, batch), **f32),
            "mask": torch.as_tensor(att.astype(np.uint8), device=dev),
            "group": heads, "batch": batch, "heads": heads,
            "valid_pairs": int(att.sum()) * heads}


def check_flash(torch, label, x, gen) -> dict:
    """Forward (out, lse) against the forward kernel's plain version; dq,
    dk, dv and dτ of the whole Function against the dense twin's
    autograd, for an output cotangent drawn from ``gen``.  Returns the
    largest errors."""
    from hyperspace_torch.kernels import attention as A

    q, k, v, mask, g = x["q"], x["k"], x["v"], x["mask"], x["group"]
    out, lse, _ = A.flash_fwd(q, k, v, C, x["beta_b"], x["tau_b"], mask, g)
    torch.cuda.synchronize()
    w_out, w_lse, _ = A.flash_fwd_plain(q, k, v, C, x["beta_b"],
                                        x["tau_b"], mask, g)
    over = int(((out - w_out).abs()
                > FLASH_ATOL + FLASH_RTOL * w_out.abs()).sum())
    over += int(((lse - w_lse).abs() > LSE_TOL * (1 + w_lse.abs())).sum())
    empty = lse == 1e30
    if not torch.equal(empty, w_lse == 1e30) or bool(
            (out[empty] != 0).any()):
        raise AssertionError(f"flash {label}: rows with no valid key differ")
    b4 = (x["batch"], x["heads"])
    shape4 = b4 + tuple(q.shape[1:])
    mask4 = mask.bool()[:, None]
    g_out = torch.randn(shape4, generator=gen, device=q.device)
    grads = {}
    for kind in ("kernel", "twin", "twin64"):
        dt = torch.float64 if kind == "twin64" else torch.float32
        ins = [t.reshape(b4 + tuple(t.shape[1:])).to(dt).clone()
               .requires_grad_() for t in (q, k, v)]
        tau = x["tau_h"].to(dt)[:, None, None].clone().requires_grad_()
        beta = x["beta_h"].to(dt)[:, None, None].clone().requires_grad_()
        if kind == "kernel":
            o = A.flash_attention(*ins, C, beta=beta, tau=tau, mask=mask4)
        else:
            o = A.flash_attention_plain(*ins, C, beta, tau, mask4)
        (o * g_out.to(dt)).sum().backward()
        grads[kind] = [t.grad.double() for t in (*ins, tau, beta)]
    torch.cuda.synchronize()
    errs = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        got, want = grads["kernel"][i], grads["twin"][i]
        errs[name] = float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-3)
    t64 = grads["twin64"][3]
    t_err = float((grads["kernel"][3] - t64).abs().max())
    errs["dtau"] = t_err / max(float(t64.abs().max()), 1e-3)
    dbeta_zero = bool((grads["kernel"][4] == 0).all())
    emit({"phase": "check", "kernel": "flash_attention", "case": label,
          "shape": list(q.shape), "mask_group": g,
          "empty_rows": int(empty.sum()),
          "out_max_abs_err": float((out - w_out).abs().max()),
          "lse_max_abs_err": float((lse - w_lse).abs().max()),
          "over_tolerance": over, **{f"{k}_err": e for k, e in errs.items()},
          "dtau_kernel": grads["kernel"][3].flatten().tolist(),
          "dtau_f64_twin": t64.flatten().tolist(), "dbeta_zero": dbeta_zero})
    if over or max(errs["dq"], errs["dk"], errs["dv"],
                   errs["dtau"]) > FLASH_GRAD_TOL or not dbeta_zero:
        raise AssertionError(f"flash {label}: kernels disagree with their "
                             "plain versions")
    return {"fwd": float((out - w_out).abs().max()),
            "dq": errs["dq"], "dkv": max(errs["dk"], errs["dv"])}


def check_mlr(torch, rng, dev, n, k, d) -> float:
    from hyperspace_torch.kernels.mlr import hyp_mlr, hyp_mlr_plain

    def ball(m, s):
        u = rng.standard_normal((m, d))
        u *= rng.uniform(0.0, s, (m, 1)) / np.linalg.norm(u, axis=1,
                                                          keepdims=True)
        return torch.as_tensor(u, dtype=torch.float32, device=dev)

    x, p = ball(n, 0.9), ball(k, 0.5)
    a = torch.as_tensor(rng.standard_normal((k, d)) * 0.1,
                        dtype=torch.float32, device=dev)
    got = hyp_mlr(x, p, a, C)
    again = hyp_mlr(x, p, a, C)
    torch.cuda.synchronize()
    want = hyp_mlr_plain(x, p, a, C)
    diff = (got - want).abs()
    over = int((diff > MLR_ATOL + MLR_RTOL * want.abs()).sum())
    same = bool(torch.equal(got, again))
    emit({"phase": "check", "kernel": "hyp_mlr", "shape": [n, k, d],
          "max_abs_err": float(diff.max()), "over_tolerance": over,
          "repeat_equal": same})
    if over or not same:
        raise AssertionError(f"hyp_mlr [{n}, {k}, {d}]: {over} entries "
                             f"beyond tolerance, repeat equal {same}")
    return float(diff.max())


def hybonet_path(torch, args, card: dict) -> dict:
    """Phases 12–15; returns what the kernels line needs."""
    import contextlib

    from hyperspace_torch.benchmarks import workloads_bench as WB
    from hyperspace_torch.cli import train as cli_train
    from hyperspace_torch.data.text import synthetic_text
    from hyperspace_torch.models import hybonet

    dev = torch.device("cuda")
    # --- phase 12: the HyboNet kernels against their plain versions ------
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 3)
    inputs = {name: hb_inputs(torch, rng, dev, *shape)
              for name, shape in HB_SHAPES.items()}
    err = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0,
           "hyp_mlr": 0.0}
    tails = hb_inputs(torch, rng, dev, 3, 2, 70, 16, 1)  # 70 = 64 + 6
    tails["k"] = tails["k"][:, :45].contiguous()     # Nk = 45 keys
    tails["v"] = tails["v"][:, :45].contiguous()
    tails["mask"] = tails["mask"][:, :, :45].contiguous()
    g_out = torch.Generator(device=dev).manual_seed(args.seed + 3)
    for label, x in (*inputs.items(), ("tails", tails)):
        e = check_flash(torch, label, x, g_out)
        err["flash_fwd"] = max(err["flash_fwd"], e["fwd"])
        err["flash_dq"] = max(err["flash_dq"], e["dq"])
        err["flash_dkv"] = max(err["flash_dkv"], e["dkv"])
    for n, k, d in ((256, 8, 128), (2, 8, 64), (64, 4, 128), (3, 300, 33),
                    MLR_NC_SHAPE, (1003, 40, 32), (1003, 300, 33)):
        err["hyp_mlr"] = max(err["hyp_mlr"], check_mlr(torch, rng, dev, n,
                                                       k, d))
    emit({"phase": "hybonet_checks", "seconds": time.perf_counter() - t0})

    # --- phase 13: the bench legs ---------------------------------------
    launches = {name: 0 for name in hb_counts()}
    legs = {}
    for name, steps in (("hybonet", 10), ("hybonet_long", 5)):
        t0 = time.perf_counter()
        leg = WB.setup_leg(name, device=dev, seed=args.seed)
        hb_reset()
        torch.cuda.reset_peak_memory_stats()
        res = WB.run_leg(leg, steps=steps, repeats=3)
        counts = hb_counts()
        peak = torch.cuda.max_memory_allocated()
        n_steps = 1 + 3 * steps
        layers = leg.cfg.num_layers
        want = {"flash_fwd": layers, "flash_dq": layers,
                "flash_dkv": layers, "hyp_mlr": 1}
        share = device_share(torch, leg.step, res["step_ms"], reps=3,
                             top_n=8)
        legs[name] = {**res, **share, "launches": counts,
                      "peak_device_memory_bytes": peak}
        emit({"phase": "hybonet_bench", "leg": name,
              **{k: v for k, v in res.items() if k != "losses"},
              "first_loss": res["losses"][0], "last_loss": res["losses"][-1],
              **share, "launches": counts, "steps_run": n_steps,
              "peak_device_memory_bytes": peak,
              "seconds": time.perf_counter() - t0, **card})
        for kname, per in want.items():
            if counts[kname] != n_steps * per:
                raise AssertionError(f"{name}: {kname} launched "
                                     f"{counts[kname]} times in {n_steps} "
                                     f"steps, want {per} a step")
            launches[kname] += counts[kname]
        if not np.all(np.isfinite(res["losses"])):
            raise AssertionError(f"{name}: non-finite loss {res['losses']}")

    # --- phase 14: the CLI with configs/hybonet_textclf.yaml -----------
    t0 = time.perf_counter()
    log = os.path.join(REPO, "build", "chip_smoke", "hybonet_cli.jsonl")
    if os.path.exists(log):
        os.remove(log)
    hb_reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_train.main(["hybonet", "--yaml", os.path.join(REPO, HB_CLI_YAML),
                        f"log={log}", "eval_every=1"])
    counts = hb_counts()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    with open(log) as f:
        losses = [json.loads(s)["loss"] for s in f]
    emit({"phase": "hybonet_cli", "config": HB_CLI_YAML, **res,
          "steps": len(losses), "first_loss": losses[0],
          "launches": counts, "seconds": time.perf_counter() - t0, **card})
    for kname, n in counts.items():
        if n < len(losses):
            raise AssertionError(f"CLI: {kname} launched {n} times in "
                                 f"{len(losses)} steps")
        launches[kname] += n
    if not (np.isfinite(res["loss"]) and res["loss"] < losses[0]):
        raise AssertionError(f"CLI: the loss did not fall: {losses[0]} -> "
                             f"{res['loss']}")

    # --- phase 15: two steps, card against CPU --------------------------
    t0 = time.perf_counter()
    ds = synthetic_text(num_samples=64, vocab_size=512, num_classes=4,
                        max_len=32, seed=args.seed)
    cfg = hybonet.HyboNetConfig(dim=64, num_heads=4, num_layers=2,
                                batch_size=32)
    runs = {}
    for where in ("cuda", "cpu"):
        model, opt, state = hybonet.init_model(cfg, seed=args.seed,
                                               device=where)
        losses_w = []
        for i in range(2):
            t, m, y = (torch.as_tensor(a[32 * i:32 * i + 32], device=where)
                       for a in (ds.tokens, ds.mask, ds.labels))
            state, loss = hybonet.train_step(model, opt, state, t, m, y)
            losses_w.append(float(loss))
        runs[where] = losses_w
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"], runs["cpu"]))
    emit({"phase": "hybonet_card_vs_cpu", "losses_cuda": runs["cuda"],
          "losses_cpu": runs["cpu"], "max_rel_loss_diff": rel,
          "seconds": time.perf_counter() - t0})
    if not rel <= HB_CARD_CPU_RTOL:
        raise AssertionError(f"HyboNet card and CPU losses differ by {rel}")
    return {"inputs": inputs, "err": err, "launches": launches,
            "legs": legs}


def flash_cost(x: dict, kind: str) -> tuple[float, float, float]:
    """(bytes, f32 operations, TF32 operations) of one flash kernel on an
    entry point's inputs: each input read once and each output written
    once, the mask as uint8 (one byte per (sequence, query, key), shared
    by the heads); multiply-adds over the valid (query, key) pairs only:
    2·D forward (Gram, p·v), 3·D in dq (Gram, ⟨dsp, v⟩, dσ·Jk), 4·D in
    dk/dv (Gram, p·dsp, ⟨dsp, v⟩, dσ·Jq), every one a 3×TF32 product on
    the tensor cores."""
    b, nq, d = x["q"].shape
    nk = x["k"].shape[1]
    rows_q, rows_k = 4.0 * b * nq * d, 4.0 * b * nk * d
    mask = float(x["mask"].numel()) + 8.0 * b
    if kind == "fwd":      # q, k, v in; out, lse, nrm out
        nbytes, macs = rows_q + 2 * rows_k + rows_q + 8.0 * b * nq, 2 * d
    elif kind == "dq":     # q, k, v, dsp, lse, di in; dq out
        nbytes, macs = 3 * rows_q + 2 * rows_k + 8.0 * b * nq, 3 * d
    else:                  # q, k, v, dsp, lse, di in; dk, dv out
        nbytes, macs = 2 * rows_q + 4 * rows_k + 8.0 * b * nq, 4 * d
    return nbytes + mask, 0.0, TF32_PASSES * 2.0 * macs * x["valid_pairs"]


def mlr_cost(n: int, k: int, d: int) -> tuple[float, float, float]:
    """(bytes, f32 operations, TF32 operations) of the MLR logits as the
    launch plan takes them: x, p, a read and the [n, k] logits written
    once; the row and class norms and about 30 operations of closed form
    per logit in f32; the two products x·pᵀ, x·aᵀ in f32 on the pair
    plan, as 3×TF32 on the tensor cores on the tile plan."""
    from hyperspace_torch.kernels.mlr import mlr_plan

    products = 4.0 * n * k * d
    f32 = 2.0 * (n + 3 * k) * d + 30.0 * n * k
    nbytes = 4.0 * (n * d + 2 * k * d + n * k)
    if mlr_plan(n, k, d).tile:
        return nbytes, f32, TF32_PASSES * products
    return nbytes, f32 + products, 0.0


def hybonet_kernel_entries(torch, hb: dict, card: dict) -> list:
    """The four HyboNet kernels' entries of the kernels line: device times
    at the bench leg's shape (the largest per launch), and at the long
    leg's and the CLI's."""
    from hyperspace_torch.kernels import attention as A
    from hyperspace_torch.kernels.mlr import hyp_mlr, hyp_mlr_plain

    dev = torch.device("cuda")
    runs = {}
    for name, x in hb["inputs"].items():
        q, k, v, m, g = x["q"], x["k"], x["v"], x["mask"], x["group"]
        bb, tb = x["beta_b"], x["tau_b"]
        out, lse, _ = A.flash_fwd(q, k, v, C, bb, tb, m, g)
        dsp = torch.randn_like(out)
        di = torch.sum(dsp * out, dim=-1)
        fa = (q, k, v, C, bb, tb, m, g)
        ba = fa + (dsp, lse, di)
        runs[name] = {
            "fwd": (lambda fa=fa: A.flash_fwd(*fa),
                    lambda fa=fa: A.flash_fwd_plain(*fa)),
            "dq": (lambda ba=ba: A.flash_dq(*ba),
                   lambda ba=ba: A.flash_dq_plain(*ba)),
            "dkv": (lambda ba=ba: A.flash_dkv(*ba),
                    lambda ba=ba: A.flash_dkv_plain(*ba))}
    # the library yardsticks, on (q·2/τ, Jk, v) with the boolean mask (the
    # score's constant (2/c + β)/τ cancels in the softmax), D zero-padded
    # to 40: one scaled_dot_product_attention call and the elementwise
    # Lorentz epilogue for the forward; for dq and dk/dv together, the one
    # backward call that its autograd makes (its forward and the epilogue
    # outside the timed window)
    def sdpa_inputs(x):
        bsz, h = x["batch"], x["heads"]
        d = x["q"].shape[-1]

        def pad40(t):
            return torch.nn.functional.pad(t, (0, 40 - d)).reshape(
                bsz, h, t.shape[1], 40)

        return (pad40(x["q"] * (2.0 / x["tau_b"])[:, None, None]),
                pad40(torch.cat([-x["k"][..., :1], x["k"][..., 1:]], dim=-1)),
                pad40(x["v"]), x["mask"].bool()[:, None])

    def library(x):
        qs, kf, vs, mb = sdpa_inputs(x)
        d = x["q"].shape[-1]

        def run():
            s = torch.nn.functional.scaled_dot_product_attention(
                qs, kf, vs, attn_mask=mb, scale=1.0)[..., :d]
            return A._epilogue(s, C)
        return run

    def library_bwd(x):
        qs, kf, vs, mb = sdpa_inputs(x)
        leaves = [t.detach().requires_grad_() for t in (qs, kf, vs)]
        o = torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=mb, scale=1.0)
        go = torch.randn_like(o)

        def run():
            return torch.autograd.grad(o, leaves, go, retain_graph=True)
        return run

    library_ms = {src: device_ms(torch, library(x),
                                 reps=5 if src == "long" else 20)
                  for src, x in hb["inputs"].items()}
    library_bwd_ms, bwd_call = {}, "not recorded"
    for src, x in hb["inputs"].items():
        fn = library_bwd(x)
        items, ops = profile_items(torch, fn, 5 if src == "long" else 20)
        library_bwd_ms[src] = (sum(items.values()) if items
                               else timed_ms(torch, fn))
        if src == "bench" and items:
            ops = [o for o in ops if "backward" in o and "aten::" in o]
            bwd_call = (f"{', '.join(ops)}; largest kernel "
                        f"{max(items, key=items.get)[:100]}")
        del fn
    bwd_library = ("one backward of scaled_dot_product_attention on (q·2/τ, "
                   "Jk, v), D padded to 40, bool mask, computing dq, dk and "
                   f"dv together (compare with dq + dk/dv): {bwd_call}")
    names = {"fwd": ("flash_attention_fwd", "hs_flash_fwd", ":199"),
             "dq": ("flash_attention_dq", "hs_flash_dq", ":410"),
             "dkv": ("flash_attention_dkv", "hs_flash_dkv", ":461")}
    per_step = {"fwd": "flash_fwd", "dq": "flash_dq", "dkv": "flash_dkv"}
    entries = []
    for kind, (name, entry, line) in names.items():
        kern, plain = runs["bench"][kind]
        bd, bby = bound_ms(*flash_cost(hb["inputs"]["bench"], kind))
        e = {"name": name, "route": "cuda",
             "source": "hyperspace_torch/kernels/csrc/attention.cu",
             "entry": entry,
             "replaces": f"hyperspace_tpu/kernels/attention.py{line}",
             "launches": hb["launches"][per_step[kind]],
             "launches_per_step": "num_layers",
             "max_abs_err": hb["err"][per_step[kind]],
             "shape": list(hb["inputs"]["bench"]["q"].shape),
             "ms": device_ms(torch, kern),
             "plain_ms": device_ms(torch, plain, reps=5),
             "bound_ms": bd, "bound_by": bby,
             "library_ms": (library_ms if kind == "fwd"
                            else library_bwd_ms)["bench"],
             "library_call": ("scaled_dot_product_attention on (q·2/τ, Jk, "
                              "v), D padded to 40, bool mask, + epilogue"
                              if kind == "fwd" else bwd_library),
             "mask": "uint8 [B, Nq, Nk] shared by the heads",
             "call_ms": timed_ms(torch, kern)}
        if kind != "fwd":        # the parts the wrapper cut each launch into
            which = 0 if kind == "dq" else 1
            qb = hb["inputs"]["bench"]["q"]
            e["blocks_per_sm"] = A._blocks_per_sm(qb.device.index, which,
                                                  qb.shape[2])
            e["blocks_per_sm_from"] = "hs_flash_bwd_blocks_per_sm"
            e["parts"] = {}
            for src, x in hb["inputs"].items():
                b_, nq_, d_ = x["q"].shape
                nk_ = x["k"].shape[1]
                e["parts"][src] = A._splits(
                    x["q"].device, which, b_, nq_ if kind == "dq" else nk_,
                    nk_ if kind == "dq" else nq_, d_)
        for src, reps in (("long", 5), ("cli", 20)):
            k2, _ = runs[src][kind]
            e[f"ms_{src}"] = device_ms(torch, k2, reps=reps)
            e[f"bound_ms_{src}"] = bound_ms(*flash_cost(hb["inputs"][src],
                                                        kind))[0]
            e[f"shape_{src}"] = list(hb["inputs"][src]["q"].shape)
            e[f"library_ms_{src}"] = (library_ms if kind == "fwd"
                                      else library_bwd_ms)[src]
        entries.append({**e, **card})
    gen = torch.Generator(device=dev).manual_seed(12)
    mlr_args = {}
    for src, (n, k, d) in (("bench", (256, 8, 128)), ("long", (2, 8, 64)),
                           ("cli", (64, 4, 128))):
        xb = torch.rand((n, d), generator=gen, device=dev) * 0.05
        p = torch.rand((k, d), generator=gen, device=dev) * 0.05
        a = torch.randn((k, d), generator=gen, device=dev) * 0.1
        mlr_args[src] = (xb, p, a, C)
    n, k, d = MLR_NC_SHAPE
    xn = torch.rand((n, d), generator=gen, device=dev) * (0.9 / np.sqrt(d))
    pn = torch.rand((k, d), generator=gen, device=dev) * (0.5 / np.sqrt(d))
    an = torch.randn((k, d), generator=gen, device=dev) * (1.0 / np.sqrt(d))
    mlr_args["nc"] = (xn, pn, an, C)
    mb_, mby = bound_ms(*mlr_cost(256, 8, 128))
    entries.append({
        "name": "hyp_mlr", "route": "cuda",
        "source": "hyperspace_torch/kernels/csrc/mlr.cu",
        "entry": "hs_hyp_mlr",
        "replaces": "hyperspace_tpu/kernels/mlr.py:125",
        "launches": hb["launches"]["hyp_mlr"], "launches_per_step": 1,
        "max_abs_err": hb["err"]["hyp_mlr"], "shape": [256, 8, 128],
        "ms": device_ms(torch, lambda: hyp_mlr(*mlr_args["bench"])),
        "plain_ms": device_ms(torch, lambda: hyp_mlr_plain(
            *mlr_args["bench"])),
        "bound_ms": mb_, "bound_by": mby, "library_ms": None,
        "call_ms": timed_ms(torch, lambda: hyp_mlr(*mlr_args["bench"])),
        "ms_long": device_ms(torch, lambda: hyp_mlr(*mlr_args["long"])),
        "ms_cli": device_ms(torch, lambda: hyp_mlr(*mlr_args["cli"])),
        "bound_ms_long": bound_ms(*mlr_cost(2, 8, 64))[0],
        "bound_ms_cli": bound_ms(*mlr_cost(64, 4, 128))[0],
        "ms_nc": device_ms(torch, lambda: hyp_mlr(*mlr_args["nc"])),
        "plain_ms_nc": device_ms(torch, lambda: hyp_mlr_plain(
            *mlr_args["nc"]), reps=5),
        "bound_ms_nc": bound_ms(*mlr_cost(*MLR_NC_SHAPE))[0],
        "bound_by_nc": bound_ms(*mlr_cost(*MLR_NC_SHAPE))[1],
        "shape_nc": list(MLR_NC_SHAPE), **card})
    return entries


# --- the approximate serving lanes: IVF probing and PQ codes -----------------

IVF_CLUSTERS = 512                 # bench.py's IVF-leg generator
NPROBES = (1, 2, 4, 8)
# PQ distances served against the f32 distance of the same id, both on
# the card: the same function on the same rows, reduced in another shape
PQ_F32_RTOL = PQ_F32_ATOL = 1e-6
LANE_RUNS = ([("f32", 0)] + [("f32", p) for p in NPROBES]
             + [("pq", 0), ("pq", 8)])


def lane_counts() -> dict:
    from hyperspace_torch.kernels import scan_topk as S
    from hyperspace_torch.kernels.distmat import pdist

    return {"pdist": pdist.launches, "scan_topk": S.scan_topk.launches,
            "scan_topk_cand": S.scan_topk_cand.launches,
            "scan_topk_pq": S.scan_topk_pq.launches}


def lane_reset() -> None:
    from hyperspace_torch.kernels import scan_topk as S
    from hyperspace_torch.kernels.distmat import pdist

    pdist.launches = S.scan_topk.launches = 0
    S.scan_topk_cand.launches = S.scan_topk_pq.launches = 0


def expected_lane_launches(prec: str, nprobe: int, mode: str,
                           batches: int) -> dict:
    """Exact launches of the new kernels (and of pdist and scan_topk
    where the lane fixes them) for ``batches`` top-k batches."""
    fused = mode == "fused"
    want = {"scan_topk_cand": batches if fused and nprobe and prec == "f32"
            else 0,
            "scan_topk_pq": batches if fused and prec == "pq" and not nprobe
            else 0}
    if nprobe:                     # the centroid pass; no slab scan
        want.update(pdist=batches, scan_topk=0)
    elif prec == "pq":             # the coded scan replaces both
        want.update(pdist=0, scan_topk=0)
    elif fused:
        want.update(scan_topk=batches)
    return want


def clustered_table(torch, rng) -> np.ndarray:
    """82,115 rows in the 10-dim ball (c = 1): 512 clusters at moderate
    radii, as bench.py's IVF leg makes them — an isotropic blob admits
    no sub-linear index."""
    from hyperspace_torch.manifolds import PoincareBall

    centers = rng.standard_normal((IVF_CLUSTERS, DIM)) * 0.25
    vv = (centers[rng.integers(0, IVF_CLUSTERS, size=ROWS)]
          + rng.standard_normal((ROWS, DIM)) * 0.05)
    return PoincareBall(C).expmap0(
        torch.as_tensor(vv, dtype=torch.float32)).numpy()


def cand_cost(b: int, n: int, d: int, cand: int, valid: int,
              k: int) -> tuple[float, float]:
    """(bytes, operations) of a candidate top-k: the table, the candidate
    ids, the queries and their ids read once, the [b, k] answer written
    once; the distances to the ``valid`` candidates (id >= 0) only."""
    return (4.0 * (n * d + b * cand + b * d + b) + 8.0 * b * k,
            float(valid) * (2 * d + _CLOSED_FORM_FLOPS))


def pq_cost(b: int, m_rows: int, n: int, m: int,
            k: int) -> tuple[float, float]:
    """(bytes, operations) of an ADC top-k: the codes, the lookup tables
    and the query ids read once, the answer written once; m adds and the
    closing transform for each real row."""
    return (float(m_rows * m) + 4.0 * (b * m * 256 + b) + 8.0 * b * k,
            float(b) * min(n, m_rows) * (m + _CLOSED_FORM_FLOPS))


def check_topk(torch, kernel, label, got, again, want, *, lorentz_rows=None):
    """Kernel against plain: ids equal outside near-ties (distances within
    rtol/atol; for hyperboloid rows, arcosh arguments within twice the
    Gram form's forward-error bound (D + 2)·2^-24·c·Σ|x_i y_i|, taken at
    the largest Σ|x_i|), and a second launch bitwise equal to the
    first."""
    from hyperspace_torch.kernels import _support

    (gd, gi), (ad, ai), (wd, wi) = got, again, want
    torch.cuda.synchronize()
    fin = torch.isfinite(wd)
    worst = float((gd - wd).abs()[fin].max()) if bool(fin.any()) else 0.0
    if lorentz_rows is None:
        a, b, rt, at = gd, wd, RTOL, ATOL
    else:
        x0 = float(lorentz_rows.abs().sum(dim=1).max())
        # the arcosh arguments u = cosh(√c·d) − 1, in float64 (c = 1)
        a, b = (2.0 * torch.sinh(t.double() / 2.0) ** 2 for t in (gd, wd))
        rt = RTOL
        at = 2.0 * (lorentz_rows.shape[1] + 2) * 2.0 ** -24 * x0 * x0
    bad = _support.topk_disagreements(
        gi.cpu().numpy(), a.cpu().numpy(), wi.cpu().numpy(),
        b.cpu().numpy(), rtol=rt, atol=at)
    same = bool(torch.equal(gd, ad) and torch.equal(gi, ai))
    emit({"phase": "check", "kernel": kernel, "case": label,
          "max_abs_err": worst, "rows_disagreeing": bad,
          "ids_equal": bool(torch.equal(gi, wi)), "repeat_bitwise": same})
    if bad or not same:
        raise AssertionError(f"{kernel} {label}: {bad} rows disagree, "
                             f"repeat bitwise {same}")
    return worst


def storm_and_tie_checks(torch, table, qi, k_scan) -> dict:
    """Phase 17's cases for the two slab scans at the serving path's
    shapes (83,968 slab rows, 82,115 of them real, 1,024 queries; k 10
    dense, k_scan PQ m = 3): an insertion storm, where every row is
    nearer than all before it, and a slab of identical rows, whose
    answer must be exactly the plain version's ids, the lowest k columns
    but the query's own.  Returns the largest distance errors."""
    from hyperspace_torch.kernels import scan_topk as S

    dev = table.device
    padded = -(-ROWS // 2048) * 2048
    spec = ("poincare", C)
    # storm rows along one axis, their radius falling with the index
    storm = torch.zeros((padded, DIM), device=dev)
    storm[:, 0] = torch.tanh(torch.linspace(0.9, 0.01, padded,
                                            device=dev))
    # one point off the table, so no query sits on it (at d = 0 the two
    # versions' Gram forms round apart)
    tied = storm[:1].expand(padded, DIM).contiguous()
    origin = torch.zeros((BATCH, DIM), device=dev)
    # ADC sums −1 − v·2^-12, v = 256·code0 + code1 (exact), v falling
    v = torch.arange(padded - 1, -1, -1, device=dev) % 65536
    pq_storm = torch.stack([v // 256, v % 256, v * 0], 1).to(torch.uint8)
    j = torch.arange(256, dtype=torch.float32, device=dev)
    lut = torch.zeros((BATCH, 768), device=dev)
    lut[:, :256] = -1.0 - j * 256 * 2.0 ** -12
    lut[:, 256:512] = -j * 2.0 ** -12
    pq_tied = torch.full((padded, 3), 77, dtype=torch.uint8, device=dev)
    lut_t = lut.flip(1).contiguous()
    dense = (("dense storm, k 10", storm, origin, K),
             ("dense identical rows, k 10", tied, table[:BATCH], K))
    pq = (("pq storm, k 170", pq_storm, lut, k_scan),
          ("pq identical codes, k 170", pq_tied, lut_t, k_scan))
    err = {"scan_topk": 0.0, "scan_topk_pq": 0.0}
    for name, cases in (("scan_topk", dense), ("scan_topk_pq", pq)):
        for label, slab, x, k in cases:
            kw = dict(k=k, n=ROWS, exclude_self=True)
            if name == "scan_topk":
                run = lambda: S.scan_topk(slab, x, qi, 0,  # noqa: E731
                                          spec=spec, **kw)
                want = S.scan_topk_plain(slab, x, qi, 0, kind="poincare",
                                         c=C, **kw)
            else:
                run = lambda: S.scan_topk_pq(slab, x, qi, 0,  # noqa: E731
                                             spec=spec, **kw)
                want = S.scan_topk_pq_plain(slab, x, qi, 0, kind="poincare",
                                            c=C, **kw)
            got, again = run(), run()
            err[name] = max(err[name], check_topk(torch, name, label, got,
                                                  again, want))
            if "identical" in label:
                cols = torch.arange(k, device=dev)[None, :]
                lowest = cols + (cols >= qi.long()[:, None]).long()
                if not (torch.equal(got[1], want[1])
                        and torch.equal(got[1].long(), lowest)):
                    raise AssertionError(f"{name} {label}: ids are not the "
                                         "lowest k columns")
    return err


def ivf_pq_path(torch, args, card: dict, table_l, fresh) -> dict:
    from hyperspace_torch.cli import serve as cli
    from hyperspace_torch.kernels import _support
    from hyperspace_torch.kernels import scan_topk as S
    from hyperspace_torch.kernels.distmat import pdist
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.serve import (QueryEngine, RequestBatcher,
                                        export_artifact, load_artifact)
    from hyperspace_torch.serve.artifact import build_quant_payload
    from hyperspace_torch.serve.index import (_lift, auto_ncells,
                                              build_index)

    dev = table_l.device
    rng = np.random.default_rng([args.seed, 16])
    spec = ("poincare", C)

    # --- phase 16: the clustered table, its index and PQ payload -----------
    table = clustered_table(torch, rng)
    t0 = time.perf_counter()
    index = build_index(table, spec, auto_ncells(ROWS), iters=8, seed=0,
                        balance=2.0)
    index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    quant = build_quant_payload(table, spec, "pq")
    pq_s = time.perf_counter() - t0
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=work)
    path = os.path.join(tmp, "ivf_pq")
    written = export_artifact(path, table, spec, index=index, quant=quant)
    art = load_artifact(path)
    if art.fingerprint != written.fingerprint:
        raise AssertionError("the IVF/PQ artifact did not load back")
    emit({"phase": "ivf_pq_setup", "rows": ROWS, "dim": DIM,
          "clusters": IVF_CLUSTERS, "ncells": index.ncells,
          "max_cell": index.max_cell, "min_cell": int(index.counts.min()),
          "index_build_s": index_s, "pq_build_s": pq_s,
          "pq_m": quant.params["m"], **card})

    # --- phase 17: both kernels against their plain versions ---------------
    t0 = time.perf_counter()
    err = {"scan_topk_cand": 0.0, "scan_topk_pq": 0.0}
    ids = rng.choice(ROWS, BATCH, replace=False)
    eng = QueryEngine.from_artifact(art, nprobe=8, scan_mode="fused",
                                    precision="pq")
    qi = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    q = eng.table[qi.long()]
    dc = pdist(q, eng._centroids, C, manifold="poincare")
    order = torch.sort(dc, dim=1, stable=True)[1]
    cands = {p: eng._cells[order[:, :p]].reshape(BATCH, -1).contiguous()
             for p in NPROBES}

    def cand_case(label, table_, cand, qq, qid, k, ex, kind="poincare"):
        run = lambda: S.scan_topk_cand(table_, cand, qq, qid,  # noqa: E731
                                       spec=(kind, C), k=k, exclude_self=ex)
        got, again = run(), run()
        want = S.scan_topk_cand_plain(table_, cand, qq, qid, kind=kind, c=C,
                                      k=k, exclude_self=ex)
        err["scan_topk_cand"] = max(err["scan_topk_cand"], check_topk(
            torch, "scan_topk_cand", label, got, again, want,
            lorentz_rows=table_ if kind == "lorentz" else None))
        return got

    for p in (1, 8):
        for k in (10, 256):
            cand_case(f"nprobe {p}, C {cands[p].shape[1]}, k {k}",
                      eng.table, cands[p], q, qi, k, True)
    odd = cands[1][:, :37].clone()               # C not a multiple of 32
    odd[:, 5:9] = -1                             # pads in mid-list
    odd[7] = -1                                  # a query with no candidate
    cand_case("C 37, mid-list pads, an empty query, k 64 > reachable",
              eng.table, odd, q, qi, 64, True)
    # queries off the table: at d = 0 the two sides' Gram noise differs
    cand_case("C 37, k 10, exclude_self off, queries off the table",
              eng.table, odd, fresh, qi, 10, False)
    # two ids at one distance, the lower at the later position, in
    # different splits of a batch of 8: the earlier position comes first
    # (a (distance, id) key would put the lower id first)
    tied = eng.table.clone()
    tied[100] = tied[50000]
    tc = cands[8][:8].clone()
    tc[:, 0], tc[:, -1] = 50000, 100
    tq = (tied[50000] * 0.99)[None].expand(8, DIM).contiguous()
    if S._cand_splits(8, tc.shape[1], K, dev) < 2:
        raise AssertionError("scan_topk_cand: the tie case is not split")
    got = cand_case(f"ids 50000 and 100 tied at positions 0 and "
                    f"{tc.shape[1] - 1}, 8 queries", tied, tc, tq, qi[:8], K,
                    False)
    if not all(row.index(50000) < row.index(100)
               for row in got[1].tolist()):
        raise AssertionError("scan_topk_cand: a tie did not go to the "
                             "earlier position")
    lq = table_l[qi.long()]
    lcand = torch.as_tensor(rng.integers(0, ROWS, (BATCH, 600)),
                            dtype=torch.int32, device=dev)
    cand_case("lorentz, C 600, k 10", table_l, lcand, lq, qi, 10, True,
              kind="lorentz")

    q_lift = _lift(spec, q).float()
    lut3 = S.pq_lut(q_lift, eng.pq_codebooks, kind="poincare")
    k_scan = eng._k_scan(K, ROWS)
    # m = 8 codebooks from lifted table rows (2 lanes a subspace, 5 pad)
    lifted = torch.nn.functional.pad(_lift(spec, eng.table[:ROWS]), (0, 5))
    pick = torch.as_tensor(rng.integers(0, ROWS, (8, 256)), device=dev)
    cb8 = torch.stack([lifted[pick[s], 2 * s:2 * s + 2] for s in range(8)])
    codes8 = torch.as_tensor(rng.integers(0, 256, (ROWS, 8)),
                             dtype=torch.uint8, device=dev)
    lut8 = S.pq_lut(q_lift, cb8, kind="poincare")
    cases = (("m 3, k 170 (the path)", eng.scan_table, lut3, 0, ROWS,
              k_scan),
             ("m 8, k 256", codes8, lut8, 0, ROWS, 256),
             ("m 3, col0 5000, n < M, k 170", eng.scan_table, lut3, 5000,
              5000 + ROWS - 115, k_scan))
    for label, codes, lut, col0, n, k in cases:
        qid = qi + col0 if col0 else qi
        run = lambda: S.scan_topk_pq(codes, lut, qid, col0,  # noqa: E731
                                     spec=spec, k=k, n=n, exclude_self=True)
        got, again = run(), run()
        want = S.scan_topk_pq_plain(codes, lut, qid, col0, kind="poincare",
                                    c=C, k=k, n=n, exclude_self=True)
        err["scan_topk_pq"] = max(err["scan_topk_pq"], check_topk(
            torch, "scan_topk_pq", label, got, again, want))
    err.update(storm_and_tie_checks(torch, eng.table[:ROWS], qi, k_scan))
    emit({"phase": "ivf_pq_checks", "seconds": time.perf_counter() - t0})

    # --- phase 18: the lanes through the serve loop ------------------------
    ids8 = rng.choice(np.setdiff1d(np.arange(ROWS), ids), 8,
                      replace=False).tolist()
    lines = "\n".join(json.dumps(r) for r in (
        {"op": "topk", "ids": ids.tolist(), "k": K},
        {"op": "topk", "ids": ids8, "k": K},
        {"op": "stats"})) + "\n"
    answers, launches = {}, {}
    for prec, npb in LANE_RUNS:
        for mode in ("two_stage", "fused"):
            lane_reset()
            out = io.StringIO()
            closing = cli.run_serve(cli.ServeConfig(
                artifact=path, scan_mode=mode, precision=prec, nprobe=npb),
                stdin=io.StringIO(lines), stdout=out)
            got = lane_counts()
            resp = [json.loads(s) for s in out.getvalue().splitlines()]
            if len(resp) != 3 or any("error" in r for r in resp):
                raise AssertionError(f"{prec}/{npb}/{mode}: {resp}")
            want = expected_lane_launches(prec, npb, mode, 2)
            if any(got[name] != c for name, c in want.items()):
                raise AssertionError(f"{prec}/{npb}/{mode}: launches {got}, "
                                     f"want {want}")
            st = resp[2]
            if (st["scan_strategy"] != ("ivf" if npb else "exact")
                    or st["precision"] != prec):
                raise AssertionError(f"{prec}/{npb}/{mode}: stats {st}")
            answers[prec, npb, mode] = resp[0]
            launches[prec, npb, mode] = got
            emit({"phase": "lane_serve", "precision": prec, "nprobe": npb,
                  "scan_mode": mode, "launches": got,
                  "served": closing["served"]})
    exact_ids = np.asarray(answers["f32", 0, "two_stage"]["neighbors"])
    recall, tab = {}, torch.as_tensor(table, device=dev)
    for prec, npb in LANE_RUNS:
        ts, fu = answers[prec, npb, "two_stage"], answers[prec, npb, "fused"]
        nb = np.asarray(ts["neighbors"])
        ds = np.asarray(ts["dists"], np.float64)
        if nb.shape != (BATCH, K) or not np.all(np.isfinite(ds)) \
                or np.any(np.diff(ds, axis=1) < 0):
            raise AssertionError(f"{prec}/{npb}: bad answers")
        bad = _support.topk_disagreements(
            nb, ds, np.asarray(fu["neighbors"]),
            np.asarray(fu["dists"], np.float64), rtol=RTOL, atol=ATOL)
        if bad:
            raise AssertionError(f"{prec}/{npb}: two_stage and fused "
                                 f"disagree on {bad} rows")
        recall[f"{prec}_nprobe{npb}"] = float(np.mean(
            [len(set(a) & set(b)) / K for a, b in zip(nb, exact_ids)]))
        if prec == "pq":           # served distances are f32 distances
            for ans in (ts, fu):
                nbt = torch.as_tensor(ans["neighbors"], device=dev).long()
                want = PoincareBall(C).dist(tab[torch.as_tensor(
                    ids, device=dev).long()][:, None, :], tab[nbt])
                got = torch.as_tensor(ans["dists"], dtype=torch.float32,
                                      device=dev)
                over = int(((got - want).abs()
                            > PQ_F32_ATOL + PQ_F32_RTOL * want.abs()).sum())
                if over:
                    raise AssertionError(f"pq/{npb}: {over} served distances "
                                         "differ from their f32 distance")
    emit({"phase": "lane_recall", "k": K, "reference": "f32 exact",
          "recall_at_10": recall})

    # --- phase 19: queries/s at bucket 1024 --------------------------------
    cold = rng.permutation(ROWS)[:40 * BATCH].reshape(40, BATCH)
    throughput = {}
    for prec, npb in LANE_RUNS[:-1]:
        for mode in ("two_stage", "fused"):
            e = QueryEngine.from_artifact(art, scan_mode=mode,
                                          precision=prec, nprobe=npb)
            throughput[f"{prec}_nprobe{npb}_{mode}"] = batch_throughput(
                torch, e, RequestBatcher(e), cold)
    emit({"phase": "lane_throughput", "bucket": BATCH, "k": K, "rows": ROWS,
          **throughput, **card})
    shutil.rmtree(tmp, ignore_errors=True)
    fused = {name: sum(launches[prec, npb, "fused"][name]
                       for prec, npb in LANE_RUNS)
             for name in ("scan_topk_cand", "scan_topk_pq")}
    return {"err": err, "launches": fused, "table": eng.table, "q": q,
            "qi": qi, "cands": cands, "lut3": lut3, "codes": eng.scan_table,
            "k_scan": k_scan, "index_build_s": index_s, "pq_build_s": pq_s}


def batch_throughput(torch, eng, batcher, cold) -> dict:
    """Batches of distinct cold ids through ``batcher`` at bucket 1024,
    and the engine call alone on the same ids, taken in turns; host
    clock, each ending in the copy of the answer to the host; medians
    after one warm-up, then the card's busy time and idle share."""
    walls = {"engine": [], "batcher": []}
    for j, ids in enumerate(cold[:21]):
        t0 = time.perf_counter()
        i, d = eng.topk_neighbors(ids.astype(np.int32), K)
        i.cpu(), d.cpu()
        t1 = time.perf_counter()
        batcher.topk(ids.tolist(), K)
        t2 = time.perf_counter()
        if j:                                          # after a warm-up
            walls["engine"].append(t1 - t0)
            walls["batcher"].append(t2 - t1)
    if batcher.stats()["cache_hit"]:
        raise AssertionError("a throughput batch hit the cache")
    med = float(np.median(walls["batcher"])) * 1e3
    more = iter(cold[21:])
    return {"batch_ms": med, "batches_per_s": 1e3 / med,
            "queries_per_s": BATCH * 1e3 / med,
            "engine_ms": float(np.median(walls["engine"])) * 1e3,
            **device_share(torch, lambda: batcher.topk(next(more).tolist(),
                                                       K), med)}


def ivf_pq_kernel_entries(torch, ip: dict, card: dict) -> list:
    """Device times of the two approximate-lane kernels and their plain
    versions at the path's shapes: the candidate scan at nprobe 8 (and
    1), the ADC scan at m = 3, k = 170."""
    from hyperspace_torch.kernels import scan_topk as S

    tab, q, qi = ip["table"], ip["q"], ip["qi"]
    spec = ("poincare", C)

    def cand(p):
        return lambda: S.scan_topk_cand(tab, ip["cands"][p], q, qi,
                                        spec=spec, k=K, exclude_self=True)

    c8 = ip["cands"][8]
    ok = c8 >= 0
    valid = int(ok.sum())
    # the same valid candidate rows, each read once and written out by
    # one PyTorch call: the time a plain gather of these rows takes
    g_ids = c8[ok]
    cb, cby = bound_ms(*cand_cost(BATCH, ROWS, DIM, c8.shape[1], valid, K))
    codes, lut, ks = ip["codes"], ip["lut3"], ip["k_scan"]

    def pq():
        return S.scan_topk_pq(codes, lut, qi, 0, spec=spec, k=ks, n=ROWS,
                              exclude_self=True)

    pb, pby = bound_ms(*pq_cost(BATCH, codes.shape[0], ROWS,
                                codes.shape[1], ks))
    return [
        {"name": "scan_topk_cand", "route": "cuda",
         "source": "hyperspace_torch/kernels/csrc/scan_topk.cu",
         "entry": "hs_scan_topk_cand",
         "replaces": "hyperspace_tpu/kernels/scan_topk.py:1087",
         "launches": ip["launches"]["scan_topk_cand"],
         "launches_per_batch": "1 under IVF fused (f32)",
         "max_abs_err": ip["err"]["scan_topk_cand"],
         "shape": [BATCH, c8.shape[1], DIM, K], "valid_candidates": valid,
         "ms": device_ms(torch, cand(8)),
         "plain_ms": device_ms(torch, lambda: S.scan_topk_cand_plain(
             tab, c8, q, qi, kind="poincare", c=C, k=K, exclude_self=True),
             reps=3),
         "bound_ms": cb, "bound_by": cby, "library_ms": None,
         "splits": S._cand_splits(BATCH, c8.shape[1], K, tab.device),
         "gather_ms": device_ms(torch, lambda: tab.index_select(0, g_ids)),
         "call_ms": timed_ms(torch, cand(8)),
         "ms_nprobe1": device_ms(torch, cand(1)),
         "shape_nprobe1": list(ip["cands"][1].shape),
         "splits_nprobe1": S._cand_splits(BATCH, ip["cands"][1].shape[1], K,
                                          tab.device), **card},
        {"name": "scan_topk_pq", "route": "cuda",
         "source": "hyperspace_torch/kernels/csrc/scan_topk.cu",
         "entry": "hs_scan_topk_pq",
         "replaces": "hyperspace_tpu/kernels/scan_topk.py:872",
         "launches": ip["launches"]["scan_topk_pq"],
         "launches_per_batch": "1 under PQ fused",
         "max_abs_err": ip["err"]["scan_topk_pq"],
         "shape": [BATCH, codes.shape[0], codes.shape[1], ks],
         **scan_parts(torch, pq),
         "plain_ms": device_ms(torch, lambda: S.scan_topk_pq_plain(
             codes, lut, qi, 0, kind="poincare", c=C, k=ks, n=ROWS,
             exclude_self=True), reps=3),
         "bound_ms": pb, "bound_by": pby, "library_ms": None,
         "call_ms": timed_ms(torch, pq), **card},
    ]


# --- the Poincaré ball's primitive ops and the gyro-linear layer -----------

# the row-wise ops' path shapes: the WordNet-noun table (BASELINE.json
# configs[0], the RSGD/RAdam update's shape), arxiv nodes at HGCN's
# feature width (configs[1]), the TPU smoke's own (B 256, D 48), and the
# WordNet rows at the HVAE latent's width (configs/hvae_mnist.yaml, d 8)
ROW_SHAPES = {"wordnet": (ROWS, DIM), "arxiv": (169343, 128),
              "smoke": (256, 48), "d8": (ROWS, 8)}
# hyp_linear's: arxiv rows through 128 → 128 and HGCN's hidden 128 → 32,
# and the TPU smoke's 48 → 32
LINEAR_SHAPES = {"arxiv_128": (169343, 128, 128),
                 "arxiv_32": (169343, 128, 32), "smoke": (256, 48, 32)}
ROW_OPS = ("mobius_add", "mobius_scalar_mul", "expmap", "logmap", "expmap0",
           "logmap0", "ptransp")
ROW_ENTRY = {"mobius_add": "hs_mobius_add",
             "mobius_scalar_mul": "hs_mobius_scalar_mul",
             "expmap": "hs_expmap", "logmap": "hs_logmap",
             "expmap0": "hs_expmap0", "logmap0": "hs_logmap0",
             "ptransp": "hs_ptransp"}
# how many [n, d] tensors each op reads (the output adds one write)
ROW_TENSORS = {"mobius_add": 2, "mobius_scalar_mul": 1, "expmap": 2,
               "logmap": 2, "expmap0": 1, "logmap0": 1, "ptransp": 3}
# float32 operations an element: the dot products (2 each) and the
# combinations of each sweep (the transcendentals are per row)
ROW_FLOPS = {"mobius_add": 10, "mobius_scalar_mul": 4, "expmap": 20,
             "logmap": 18, "expmap0": 8, "logmap0": 3, "ptransp": 16}
# kernel against plain version (f32): the JAX package's tier for these
# kernels (tests/kernels/test_pointwise.py:25, test_hyplinear.py:29)
ROW_RTOL, ROW_ATOL, LIN_ATOL = 2e-4, 2e-5, 2e-4
GYRO_STEPS = 10
GYRO_CARD_CPU_ROWS = 20_000
GYRO_CARD_CPU_RTOL = 1e-4          # all f32: loss and gradients


def row_cost(op: str, n: int, d: int) -> tuple[float, float]:
    """(bytes, operations) of a row-wise op on [n, d] float32 rows: each
    input read once, the output written once."""
    return (4.0 * n * d * (ROW_TENSORS[op] + 1),
            float(ROW_FLOPS[op]) * n * d)


def linear_cost(n: int, d_in: int,
                d_out: int) -> tuple[float, float, float]:
    """(bytes, f32 operations, TF32 operations) of hyp_linear on f32 x:
    x, M and b read once, the output written once; ‖x‖² and about 8
    operations an output for the rescale, ⊕ b and proj in f32, and the
    product's 2·n·d_in·d_out as a 3×TF32 product on the tensor cores."""
    return (4.0 * (n * d_in + d_in * d_out + d_out + n * d_out),
            2.0 * n * d_in + 8.0 * n * d_out,
            TF32_PASSES * 2.0 * n * d_in * d_out)


def gyro_counts() -> dict:
    from hyperspace_torch import kernels as K

    return {op: getattr(K, op).launches for op in ROW_OPS + ("hyp_linear",)}


def gyro_reset() -> None:
    from hyperspace_torch import kernels as K

    for op in ROW_OPS + ("hyp_linear",):
        getattr(K, op).launches = 0


def ball_tensor(torch, gen, shape, c, dev, radius=0.5):
    """Ball points from the seed: expmap0 (the port's plain method) of an
    origin tangent of norm about ``radius``/√c."""
    from hyperspace_torch.manifolds import PoincareBall

    v = torch.randn(shape, generator=gen, device=dev) * (
        radius / np.sqrt(shape[-1] * c))
    return PoincareBall(c).expmap0(v).contiguous()


def row_inputs(torch, gen, op, shape, c, dev):
    x = ball_tensor(torch, gen, shape, c, dev, 0.8)
    y = ball_tensor(torch, gen, shape, c, dev, 0.5)
    v = torch.randn(shape, generator=gen, device=dev) * (0.6 / np.sqrt(
        shape[-1]))
    return {"mobius_add": (x, y), "mobius_scalar_mul": (x,),
            "expmap": (x, v), "logmap": (x, y), "expmap0": (v,),
            "logmap0": (y,), "ptransp": (x, y, v)}[op]


def row_call(op, tensors, c, r=0.7, plain=False):
    from hyperspace_torch.kernels import pointwise as PW

    fn = getattr(PW, op + "_plain" if plain else op)
    return fn(r, *tensors, c) if op == "mobius_scalar_mul" else fn(*tensors,
                                                                   c)


def check_gyro(torch, kernel, label, got, again, want, rtol, atol) -> float:
    """Hold a kernel's output against its plain version's: f32 within
    ``atol + rtol·|want|``; a bf16 output within one bf16 ulp of the f32
    plain result on the same inputs plus that (the output rounds once, a
    flip moves it one ulp).  The repeat must give the same bits."""
    if got.shape != want.shape:
        raise AssertionError(f"{kernel} {label}: {got.shape} vs "
                             f"{want.shape}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = atol + rtol * w.abs()
    if got.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(torch, w)
    over = int((diff > tol).sum()) + int(not bool(torch.isfinite(g).all()))
    same = bool(torch.equal(got, again))
    worst = float(diff.max()) if diff.numel() else 0.0
    emit({"phase": "check", "kernel": kernel, "case": label,
          "shape": list(got.shape), "dtype": str(got.dtype),
          "max_abs_err": worst, "over_tolerance": over, "repeat_equal": same})
    if over or not same:
        raise AssertionError(f"{kernel} {label}: {over} entries beyond "
                             f"tolerance, repeat equal {same}")
    return worst


def check_grads(torch, kernel, label, got, want) -> float:
    """Gradients through a Function against autograd of its plain version
    (the backward recomputes the plain version: the same arithmetic, so
    within rtol 1e-6 of the largest entry)."""
    worst = 0.0
    for a, b in zip(got, want):
        if b is None:
            continue
        d = float((a - b).abs().max())
        worst = max(worst, d)
        if not d <= 1e-6 * float(b.abs().max()) + 1e-12:
            raise AssertionError(f"{kernel} {label}: gradient off by {d}")
    emit({"phase": "check", "kernel": kernel, "case": label,
          "grad_max_abs_diff": worst})
    return worst


def gyro_stack(torch, gen, d_in, width, out, dev):
    """The slice's layer stack: HypLinear(width) on the ball c = 1 →
    HypAct(ball c = 1 → ball c = 0.5, relu) → HypLinear(out) on c = 0.5;
    glorot kernels and small origin-tangent biases from ``gen``."""
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.nn import HypAct, HypLinear

    b1, b2 = PoincareBall(1.0), PoincareBall(0.5)
    stack = torch.nn.Sequential(HypLinear(d_in, width, b1, generator=gen),
                                HypAct(b1, b2, torch.relu),
                                HypLinear(width, out, b2, generator=gen))
    with torch.no_grad():
        for layer in (stack[0], stack[2]):
            layer.bias.copy_(torch.randn(layer.bias.shape, generator=gen)
                             * 0.05)
    return stack.to(dev)


def gyro_path(torch, args, card: dict) -> dict:
    """Phases 20–22; returns what the kernels line needs."""
    from hyperspace_torch import kernels as K
    from hyperspace_torch.kernels.hyplinear import hyp_linear_plain
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.optim.adamw import AdamW

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 20)
    err = {op: 0.0 for op in ROW_OPS + ("hyp_linear",)}

    # --- phase 20: the kernels against their plain versions -------------
    t0 = time.perf_counter()
    cases = [(f"{name} c={c}", shape, c) for name, shape in
             ROW_SHAPES.items() for c in (1.0, 0.5, 2.3)]
    cases += [(f"d={d}", (1000, d), 1.0) for d in (7, 130, 200)]
    cases += [("lead [3, 8, 48]", (3, 8, 48), 0.7)]
    for op in ROW_OPS:
        for label, shape, c in cases:
            ts = row_inputs(torch, gen, op, shape, c, dev)
            got, again = row_call(op, ts, c), row_call(op, ts, c)
            err[op] = max(err[op], check_gyro(
                torch, op, label, got, again, row_call(op, ts, c, plain=True),
                ROW_RTOL, ROW_ATOL))
        for name in ("arxiv", "wordnet"):       # the G-lane and packed paths
            ts = [t.to(torch.bfloat16) for t in row_inputs(
                torch, gen, op, ROW_SHAPES[name], 1.0, dev)]
            check_gyro(torch, op, f"bf16 {name}", row_call(op, ts, 1.0),
                       row_call(op, ts, 1.0),
                       row_call(op, [t.float() for t in ts], 1.0, plain=True),
                       ROW_RTOL, ROW_ATOL)
        # gradients to every tensor and to device tensors c and r
        ts = [t.requires_grad_() for t in row_inputs(
            torch, gen, op, ROW_SHAPES["smoke"], 0.8, dev)]
        cc = torch.tensor(0.8, device=dev, requires_grad=True)
        rr = torch.tensor(1.3, device=dev, requires_grad=True)
        w = torch.randn(ROW_SHAPES["smoke"], generator=gen, device=dev)
        wrt = ts + [cc, rr]
        check_grads(torch, op, "grads c=tensor", torch.autograd.grad(
            (row_call(op, ts, cc, rr) * w).sum(), wrt, allow_unused=True),
            torch.autograd.grad((row_call(op, ts, cc, rr, plain=True)
                                 * w).sum(), wrt, allow_unused=True))
    x = ball_tensor(torch, gen, ROW_SHAPES["arxiv"], 1.0, dev, 0.8)
    for r in (-1.5, 0.0, 0.5, 3.0):
        err["mobius_scalar_mul"] = max(err["mobius_scalar_mul"], check_gyro(
            torch, "mobius_scalar_mul", f"r={r}",
            row_call("mobius_scalar_mul", (x,), 1.0, r),
            row_call("mobius_scalar_mul", (x,), 1.0, r),
            row_call("mobius_scalar_mul", (x,), 1.0, r, plain=True),
            ROW_RTOL, ROW_ATOL))
    # the proj margin (tangents of norm about 40), zero rows, a bias [d]
    # broadcast against [n, d]
    big = torch.randn(ROW_SHAPES["arxiv"], generator=gen, device=dev) * (
        40.0 / np.sqrt(128))
    xz = x.clone()
    xz[::7] = 0.0
    big[::11] = 0.0
    bias = ball_tensor(torch, gen, (128,), 1.0, dev, 0.3)
    for op, ts, label in (("expmap", (xz, big), "margin, zero rows"),
                          ("expmap0", (big,), "margin, zero rows"),
                          ("logmap0", (xz,), "zero rows"),
                          ("logmap", (xz, xz), "x = y, zero rows"),
                          ("ptransp", (xz, x, big), "zero rows"),
                          ("mobius_add", (xz, bias), "bias [d], zero rows"),
                          ("mobius_add", (bias, xz), "[d] first"),
                          ("expmap", (xz, bias), "tangent [d]")):
        err[op] = max(err[op], check_gyro(
            torch, op, label, row_call(op, ts, 1.3), row_call(op, ts, 1.3),
            row_call(op, ts, 1.3, plain=True), ROW_RTOL, ROW_ATOL))
    lin_cases = [(f"{name} c={c}", shp, c) for name, shp in
                 LINEAR_SHAPES.items() for c in (1.0, 0.5, 2.3)]
    lin_cases += [("7→130", (1000, 7, 130), 1.0),
                  ("130→200", (1000, 130, 200), 1.0),
                  ("200→7", (1000, 200, 7), 1.0),
                  ("tiles 1000→700", (2000, 1000, 700), 1.0)]
    for label, (n, di, do), c in lin_cases:
        xl = ball_tensor(torch, gen, (n, di), c, dev, 0.8)
        xl[::5] = 0.0                                   # M x = 0 rows
        m = torch.randn((di, do), generator=gen, device=dev) / np.sqrt(di)
        b = ball_tensor(torch, gen, (do,), c, dev, 0.3)
        for bl, bb in (("", b), (" b=0", torch.zeros_like(b))):
            err["hyp_linear"] = max(err["hyp_linear"], check_gyro(
                torch, "hyp_linear", label + bl, K.hyp_linear(xl, m, bb, c),
                K.hyp_linear(xl, m, bb, c), hyp_linear_plain(xl, m, bb, c),
                ROW_RTOL, LIN_ATOL))
    n, di, do = LINEAR_SHAPES["arxiv_128"]
    xl = ball_tensor(torch, gen, (n, di), 1.0, dev, 0.8)
    m = torch.randn((di, do), generator=gen, device=dev) / np.sqrt(di)
    b = ball_tensor(torch, gen, (do,), 1.0, dev, 0.3)
    xb = xl.to(torch.bfloat16)
    check_gyro(torch, "hyp_linear", "bf16 arxiv_128",
               K.hyp_linear(xb, m, b, 1.0), K.hyp_linear(xb, m, b, 1.0),
               hyp_linear_plain(xb.float(), m, b, 1.0), ROW_RTOL, LIN_ATOL)
    for label, mm in (("margin (30·M)", 30.0 * m),
                      ("Mx = 0 everywhere", torch.zeros_like(m))):
        check_gyro(torch, "hyp_linear", label, K.hyp_linear(xl, mm, b, 1.0),
                   K.hyp_linear(xl, mm, b, 1.0),
                   hyp_linear_plain(xl, mm, b, 1.0), ROW_RTOL, LIN_ATOL)
    x3 = xl[:24].reshape(3, 8, di)
    check_gyro(torch, "hyp_linear", "lead [3, 8, 128]",
               K.hyp_linear(x3, m, b, 1.0), K.hyp_linear(x3, m, b, 1.0),
               hyp_linear_plain(x3, m, b, 1.0), ROW_RTOL, LIN_ATOL)
    ins = [xl[:256].clone().requires_grad_(), m.clone().requires_grad_(),
           b.clone().requires_grad_()]
    cc = torch.tensor(0.9, device=dev, requires_grad=True)
    w = torch.randn((256, do), generator=gen, device=dev)
    check_grads(torch, "hyp_linear", "grads c=tensor", torch.autograd.grad(
        (K.hyp_linear(*ins, cc) * w).sum(), ins + [cc]),
        torch.autograd.grad((hyp_linear_plain(*ins, cc) * w).sum(),
                            ins + [cc]))
    emit({"phase": "gyro_checks", "seconds": time.perf_counter() - t0,
          **card})

    # --- phase 21: the op path: a Riemannian update through the public
    # ops at each path shape ----------------------------------------------
    t0 = time.perf_counter()
    inputs = {}
    for name, shape in ROW_SHAPES.items():
        inputs[name] = {
            "x": ball_tensor(torch, gen, shape, 1.0, dev, 0.8),
            "y": ball_tensor(torch, gen, shape, 1.0, dev, 0.5),
            "g": torch.randn(shape, generator=gen, device=dev) * (
                0.3 / np.sqrt(shape[-1]))}
    gyro_reset()
    outs = {}
    for name, z in inputs.items():
        x, y, g = z["x"], z["y"], z["g"]
        u = K.logmap(x, y, 1.0)                 # the direction to y
        x1 = K.expmap(x, 0.5 * u + g, 1.0)      # a step
        m1 = K.ptransp(x, x1, g, 1.0)           # a moment carried along
        h = K.mobius_scalar_mul(0.5, K.expmap0(m1, 1.0), 1.0)
        x2 = K.mobius_add(x1, h, 1.0)
        outs[name] = (x1, m1, x2, K.logmap0(x2, 1.0))
    torch.cuda.synchronize()
    counts = gyro_counts()
    emit({"phase": "gyro_op_path", "shapes": ROW_SHAPES, "launches": counts,
          "seconds": time.perf_counter() - t0, **card})
    for op in ROW_OPS:
        if counts[op] != len(ROW_SHAPES):
            raise AssertionError(f"op path: {op} launched {counts[op]} "
                                 f"times, want {len(ROW_SHAPES)}")
    if counts["hyp_linear"]:
        raise AssertionError("op path: hyp_linear launched")
    ball = PoincareBall(1.0)
    for name, (x1, m1, x2, v2) in outs.items():
        z = inputs[name]
        for t in (x1, m1, x2, v2):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"op path {name}: non-finite values")
        for t in (x1, x2):
            if not float(torch.linalg.norm(t, dim=-1).max()) < 1.0:
                raise AssertionError(f"op path {name}: a point left the "
                                     "ball")
        # the same chain by the plain versions on the CPU, first 2,000 rows
        xs, ys, gs = (z[k][:2000].cpu() for k in ("x", "y", "g"))
        u = ball.logmap(xs, ys)
        p1 = ball.expmap(xs, 0.5 * u + gs)
        q1 = ball.ptransp(xs, p1, gs)
        p2 = ball.mobius_add(p1, ball.mobius_scalar_mul(0.5,
                                                        ball.expmap0(q1)))
        gap = max(float((a[:2000].cpu() - b).abs().max()) for a, b in
                  ((x1, p1), (m1, q1), (x2, p2), (v2, ball.logmap0(p2))))
        emit({"phase": "gyro_op_path_vs_cpu", "shape": list(x1.shape),
              "rows": 2000, "max_abs_diff": gap})
        if not gap <= 1e-4:
            raise AssertionError(f"op path {name}: card and CPU differ by "
                                 f"{gap}")
    row_launches = {op: counts[op] for op in ROW_OPS}

    # --- phase 22: the layer path at arxiv width -------------------------
    t0 = time.perf_counter()
    n, di, _ = LINEAR_SHAPES["arxiv_128"]
    xs = ball_tensor(torch, gen, (n, di), 1.0, dev, 0.8)
    tgt = ball_tensor(torch, gen, (n, 32), 0.5, dev, 0.5)
    stack = gyro_stack(torch, torch.Generator().manual_seed(args.seed),
                       di, 128, 32, dev)
    init = {k: v.detach().clone() for k, v in stack.state_dict().items()}
    b2 = PoincareBall(0.5)

    def loss_of(model, x, t):
        return torch.mean(b2.sqdist(model(x), t))

    # card against the CPU from the same parameters, 20,000 rows
    rows = GYRO_CARD_CPU_ROWS
    res = {}
    for where in ("cuda", "cpu"):
        model = gyro_stack(torch, torch.Generator().manual_seed(0), di, 128,
                           32, where)
        model.load_state_dict({k: v.to(where) for k, v in init.items()})
        loss = loss_of(model, xs[:rows].to(where), tgt[:rows].to(where))
        loss.backward()
        res[where] = (float(loss.detach()), {
            k: p.grad.detach().cpu() for k, p in model.named_parameters()})
    rel_loss = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    rel_grad = max(float((res["cuda"][1][k] - g).abs().max())
                   / float(g.abs().max()) for k, g in res["cpu"][1].items())
    emit({"phase": "gyro_card_vs_cpu", "rows": rows,
          "loss_cuda": res["cuda"][0], "loss_cpu": res["cpu"][0],
          "rel_loss_diff": rel_loss, "max_rel_grad_diff": rel_grad})
    if not (rel_loss <= GYRO_CARD_CPU_RTOL
            and rel_grad <= GYRO_CARD_CPU_RTOL):
        raise AssertionError(f"layer path: card and CPU differ (loss "
                             f"{rel_loss}, gradients {rel_grad})")

    opt = AdamW(dict(stack.named_parameters()), lr=1e-2, weight_decay=1e-4)

    def step():
        for p in stack.parameters():
            p.grad = None
        loss = loss_of(stack, xs, tgt)
        loss.backward()
        opt.step()
        return loss.detach()

    gyro_reset()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step())]                   # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    timed = [step() for _ in range(GYRO_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1e3 / GYRO_STEPS
    losses += [float(v) for v in timed]
    counts = gyro_counts()
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "gyro_layers", "rows": n, "stack": "HypLinear(128) → "
          "HypAct(c 1 → 0.5, relu) → HypLinear(32)", "steps": GYRO_STEPS,
          "warmup": 1, "losses": losses, "step_ms": step_ms,
          "rows_per_s": n / step_ms * 1e3, "launches": counts,
          "peak_device_memory_bytes": peak,
          "seconds": time.perf_counter() - t0, **card})
    if counts["hyp_linear"] != 2 * (GYRO_STEPS + 1):
        raise AssertionError(f"layer path: hyp_linear launched "
                             f"{counts['hyp_linear']} times in "
                             f"{GYRO_STEPS + 1} forwards, want 2 each")
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"layer path: the loss did not fall: {losses}")
    share = device_share(torch, step, step_ms, reps=3, top_n=8)
    emit({"phase": "gyro_layers_profile", "step_ms": step_ms, **share,
          **card})
    return {"err": err, "row_launches": row_launches,
            "lin_launches": counts["hyp_linear"]}


def side_ms(torch, e: dict, key: str, fn) -> None:
    """``e[key]``: the device time of ``fn`` at a path's other shape, or
    None where the profiler recorded nothing; then ``e["call_" + key]``
    holds the time on the card's clock (CUDA events, launch gaps
    included) instead."""
    items = device_items(torch, fn, 20)
    e[key] = sum(items.values()) if items else None
    if not items:
        e["call_" + key] = timed_ms(torch, fn)


def gyro_kernel_entries(torch, gp: dict, card: dict) -> list:
    """The eight launchers' entries of the kernels line: device times at
    each path shape (the arxiv shape first), the plain version's at the
    arxiv shape."""
    from hyperspace_torch import kernels as K
    from hyperspace_torch.kernels.hyplinear import hyp_linear_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    entries = []
    for op in ROW_OPS:
        runs = {}
        for name, shape in ROW_SHAPES.items():
            ts = row_inputs(torch, gen, op, shape, 1.0, dev)
            runs[name] = ((lambda ts=ts: row_call(op, ts, 1.0)),
                          (lambda ts=ts: row_call(op, ts, 1.0, plain=True)))
        n, d = ROW_SHAPES["arxiv"]
        bd, bby = bound_ms(*row_cost(op, n, d))
        e = {"name": op, "route": "cuda",
             "source": "hyperspace_torch/kernels/csrc/pointwise.cu",
             "entry": ROW_ENTRY[op],
             "replaces": "hyperspace_tpu/kernels/pointwise.py:50",
             "launches": gp["row_launches"][op], "launches_per_shape": 1,
             "max_abs_err": gp["err"][op], "shape": [n, d],
             "ms": device_ms(torch, runs["arxiv"][0]),
             "plain_ms": device_ms(torch, runs["arxiv"][1], reps=5),
             "bound_ms": bd, "bound_by": bby, "library_ms": None,
             "call_ms": timed_ms(torch, runs["arxiv"][0])}
        for name in ("wordnet", "smoke", "d8"):
            side_ms(torch, e, f"ms_{name}", runs[name][0])
            e[f"bound_ms_{name}"] = bound_ms(*row_cost(op,
                                                       *ROW_SHAPES[name]))[0]
            e[f"shape_{name}"] = list(ROW_SHAPES[name])
        entries.append({**e, **card})
    runs = {}
    for name, (n, di, do) in LINEAR_SHAPES.items():
        x = ball_tensor(torch, gen, (n, di), 1.0, dev, 0.8)
        m = torch.randn((di, do), generator=gen, device=dev) / np.sqrt(di)
        b = ball_tensor(torch, gen, (do,), 1.0, dev, 0.3)
        runs[name] = ((lambda a=(x, m, b): K.hyp_linear(*a, 1.0)),
                      (lambda a=(x, m, b): hyp_linear_plain(*a, 1.0)),
                      (lambda a=(x, m): torch.matmul(*a)))
    bd, bby = bound_ms(*linear_cost(*LINEAR_SHAPES["arxiv_128"]))
    # the product alone (torch.matmul of x and M in f32; main() keeps TF32
    # off) is a reference, not the same function: no library call computes
    # the layer
    e = {"name": "hyp_linear", "route": "cuda",
         "source": "hyperspace_torch/kernels/csrc/hyplinear.cu",
         "entry": "hs_hyp_linear",
         "replaces": "hyperspace_tpu/kernels/hyplinear.py:69",
         "launches": gp["lin_launches"], "launches_per_step": 2,
         "max_abs_err": gp["err"]["hyp_linear"],
         "shape": list(LINEAR_SHAPES["arxiv_128"]),
         "ms": device_ms(torch, runs["arxiv_128"][0]),
         "plain_ms": device_ms(torch, runs["arxiv_128"][1], reps=5),
         "bound_ms": bd, "bound_by": bby, "library_ms": None,
         "bytes_bound_ms": linear_cost(*LINEAR_SHAPES["arxiv_128"])[0]
         / HBM_BYTES_PER_S * 1e3,
         "product_alone_ms": device_ms(torch, runs["arxiv_128"][2]),
         "product_alone": "torch.matmul(x, M) in f32: the product alone, "
                          "not the same function",
         "product_alone_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
         "call_ms": timed_ms(torch, runs["arxiv_128"][0])}
    for name in ("arxiv_32", "smoke"):
        side_ms(torch, e, f"ms_{name}", runs[name][0])
        side_ms(torch, e, f"plain_ms_{name}", runs[name][1])
        side_ms(torch, e, f"product_alone_ms_{name}", runs[name][2])
        cost = linear_cost(*LINEAR_SHAPES[name])
        e[f"bound_ms_{name}"] = bound_ms(*cost)[0]
        e[f"bytes_bound_ms_{name}"] = cost[0] / HBM_BYTES_PER_S * 1e3
        e[f"shape_{name}"] = list(LINEAR_SHAPES[name])
    entries.append({**e, **card})
    return entries


# --- phases 24-29: Poincaré embeddings with RSGD and RAdam ------------------

PE_DEPTH, PE_BRANCH = 5, 9            # bench.py's WordNet-noun stand-in
PE_ROWS, PE_PAIRS = 66_430, 323_847
PE_BIG_ROWS = 597_871                 # the large table, depth 6
PE_BATCH, PE_NEG, PE_POOL = 1024, 10, 64
PE_SLOTS = PE_BATCH * (2 + PE_NEG)    # 12,288 flat slots of a planned step
PE_EVAL_CHUNKS = -(-PE_PAIRS // 1024)  # 317 pdist launches an evaluation
PE_CLI_YAML = "configs/poincare_wordnet.yaml"
PE_CARD_CPU_RTOL = 1e-4
PE_PROFILE_STEPS = 20
# kernels launched a step by each strategy (all others 0, pdist included)
PE_PER_STEP = {"dense": ("expmap",), "sparse": ("expmap",),
               "planned": ("expmap", "csr_segment_sum"),
               "dense_scan": ("expmap",),
               "planned_scan": ("expmap", "csr_segment_sum"),
               "mined": ("expmap", "scan_topk"),
               "mined_scan": ("expmap", "scan_topk")}


def pe_counts() -> dict:
    from hyperspace_torch.models import poincare_embed as pe

    return {f.__name__: f.launches for f in pe.path_counters()}


def pe_reset() -> None:
    from hyperspace_torch.models import poincare_embed as pe

    for f in pe.path_counters():
        f.launches = 0


def pe_clone(torch, state):
    """A copy of a trainer state: tensors cloned, the generator a new one
    at the same position."""
    import torch.utils._pytree as pytree

    def one(x):
        if isinstance(x, torch.Generator):
            g = torch.Generator(device=x.device)
            g.set_state(x.get_state())
            return g
        return x.clone() if isinstance(x, torch.Tensor) else x

    return pytree.tree_map(one, state)


def pe_start(torch, pe, cfg, rng, device, radam: bool):
    """A JAX-``TrainState``-shaped start from numpy (table spread over the
    ball, Adam moments mid-run), read by ``state_from_jax``."""
    import collections

    n, d = cfg.num_nodes, cfg.dim
    v = rng.standard_normal((n, d))
    table = (v / np.linalg.norm(v, axis=1, keepdims=True)
             * rng.uniform(0.05, 0.6, (n, 1))).astype(np.float32)
    if radam:
        Opt = collections.namedtuple("RAdamState", "count mu nu")
        opt = Opt(np.int32(7), (rng.standard_normal((n, d)) * 1e-3).astype(
            np.float32), (rng.uniform(0, 1e-4, (n, 1))).astype(np.float32))
    else:
        opt = collections.namedtuple("RSGDState", "count")(np.int32(7))
    js = collections.namedtuple("TrainState", "table opt_state key step")(
        table, opt, None, np.int32(7))
    return pe.state_from_jax(cfg, js, device=device)


def pe_card_vs_cpu(torch, args) -> dict:
    """Phase 24: five explicit-batch steps of every path, both
    optimizers, on the card and on the CPU from one start."""
    from hyperspace_torch.data.wordnet import synthetic_tree
    from hyperspace_torch.models import poincare_embed as pe

    ds = synthetic_tree(3, 3)
    out = {}
    for optimizer in ("rsgd", "radam"):
        for path in ("dense", "mined", "sparse", "planned", "packed"):
            cfg = pe.PoincareEmbedConfig(
                num_nodes=ds.num_nodes, dim=5, batch_size=48, neg_samples=6,
                burnin_steps=3, optimizer=optimizer,
                neg_mode="mined" if path == "mined" else "uniform")
            rng = np.random.default_rng(args.seed + 24)
            u = ds.pairs[rng.integers(0, ds.num_pairs, (5, 48))]
            neg = rng.integers(0, ds.num_nodes, (5, 48, 6))
            pools = rng.integers(0, ds.num_nodes, (5, pe.mine_pool_size(cfg)))
            tables = {}
            for where in ("cuda", "cpu"):
                st = pe_start(torch, pe, cfg, np.random.default_rng(
                    args.seed), where, optimizer == "radam")
                opt = pe.make_optimizer(cfg)
                plan = pe.plan_from_indices(cfg, u[..., 0], u[..., 1], neg,
                                            device=where)
                if path == "packed":
                    st = pe.pack_state(cfg, st)
                for i in range(5):
                    ids = [torch.as_tensor(a, device=where) for a in (
                        u[i, :, 0], u[i, :, 1], neg[i])]
                    if path == "dense":
                        st, _ = pe.step_on_batch(cfg, opt, st, *ids)
                    elif path == "mined":
                        st, _ = pe.step_on_batch(
                            cfg, opt, st, ids[0], ids[1], pool_idx=torch.
                            as_tensor(pools[i], device=where))
                    elif path == "sparse":
                        st, _ = pe.sparse_step_on_batch(cfg, opt, st, *ids)
                    elif path == "planned":
                        st, _ = pe.train_step_sparse_planned(cfg, opt, st,
                                                             plan)
                    else:
                        st, _ = pe.train_step_planned_packed(cfg, opt, st,
                                                             plan)
                tables[where] = (st.packed if path == "packed"
                                 else st.table).cpu().double()
            ref = tables["cpu"]
            rel = float((tables["cuda"] - ref).abs().max()
                        / ref.abs().max())
            out[f"{optimizer}_{path}"] = rel
            if not rel <= PE_CARD_CPU_RTOL:
                raise AssertionError(f"poincare {optimizer} {path}: card and "
                                     f"CPU tables differ by rel {rel}")
    return out


def pe_kernel_checks(torch, args, plan_row) -> dict:
    """Phase 25: the four kernels at this path's shapes against their
    plain versions on the card, each launched twice for the same bits."""
    from hyperspace_torch.kernels.distmat import pdist, pdist_plain
    from hyperspace_torch.kernels.scan_topk import scan_topk, scan_topk_plain
    from hyperspace_torch.kernels import _support

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 25)
    rng = np.random.default_rng(args.seed + 25)
    err = {}
    table = ball_tensor(torch, gen, (PE_ROWS, DIM), C, dev, 0.8)
    u = torch.as_tensor(rng.integers(0, PE_ROWS, PE_BATCH), device=dev)
    q = table[u].contiguous()
    got = pdist(q, table, C, manifold="poincare")
    again = pdist(q, table, C, manifold="poincare")
    want = pdist_plain(q, table, C, manifold="poincare")
    # the queries are table rows, as in evaluate: at d(u, u) = 0 the Gram
    # form's rounding noise differs between the two (evaluate never ranks
    # that column), so it is held apart, within 1e-2
    diff = (got - want).abs()
    self_err = float(diff[torch.arange(PE_BATCH, device=dev), u].max())
    diff[torch.arange(PE_BATCH, device=dev), u] = 0.0
    err["pdist"] = float(diff.max())
    over = int((diff > ATOL + RTOL * want.abs()).sum())
    same = bool(torch.equal(got, again))
    emit({"phase": "check", "kernel": "pdist", "case": "pe_eval",
          "shape": [PE_BATCH, PE_ROWS, DIM], "max_abs_err": err["pdist"],
          "self_column_max_abs_err": self_err, "over_tolerance": over,
          "repeat_equal": same})
    if over or not same or not self_err <= 1e-2:
        raise AssertionError(f"pdist pe_eval: {over} over, repeat {same}")
    # a mining pool drawn with replacement, with forced duplicates: their
    # rows tie exactly, and the lower pool slot must come first
    pool_ids = rng.integers(0, PE_ROWS, PE_POOL)
    pool_ids[40:48] = pool_ids[0:8]
    pool = table[torch.as_tensor(pool_ids, device=dev)].contiguous()
    qi = torch.zeros(PE_BATCH, dtype=torch.int32, device=dev)
    d1, i1 = scan_topk(pool, q, qi, 0, spec=("poincare", C), k=PE_NEG,
                       n=PE_POOL, exclude_self=False)
    d1b, i1b = scan_topk(pool, q, qi, 0, spec=("poincare", C), k=PE_NEG,
                         n=PE_POOL, exclude_self=False)
    d2, i2 = scan_topk_plain(pool, q, qi, 0, kind="poincare", c=C, k=PE_NEG,
                             n=PE_POOL, exclude_self=False)
    bad = _support.topk_disagreements(
        i1.cpu().numpy(), d1.cpu().numpy(), i2.cpu().numpy(),
        d2.cpu().numpy(), rtol=RTOL, atol=ATOL)
    ids = i1.cpu().numpy()
    tie_order_bad = 0
    for a in range(8):                 # slot a and slot 40 + a are one row
        for row in ids:
            pa, pb = np.flatnonzero(row == a), np.flatnonzero(row == 40 + a)
            if len(pb) and (not len(pa) or pa[0] > pb[0]):
                tie_order_bad += 1
    same = bool(torch.equal(d1, d1b) and torch.equal(i1, i1b))
    err["scan_topk"] = float((d1 - d2).abs().max())
    emit({"phase": "check", "kernel": "scan_topk", "case": "pe_mine",
          "shape": [PE_BATCH, PE_POOL, DIM, PE_NEG],
          "max_abs_err": err["scan_topk"], "rows_disagreeing": bad,
          "tie_order_wrong": tie_order_bad, "repeat_equal": same})
    if bad or tie_order_bad or not same:
        raise AssertionError(f"scan_topk pe_mine: {bad} rows disagree, "
                             f"{tie_order_bad} ties out of order, repeat "
                             f"{same}")
    for op, shapes in (("expmap", ((PE_ROWS, DIM), (PE_SLOTS, DIM))),
                       ("ptransp", ((PE_BIG_ROWS, DIM), (PE_SLOTS, DIM)))):
        for shape in shapes:
            ts = row_inputs(torch, gen, op, shape, C, dev)
            got, again = row_call(op, ts, C), row_call(op, ts, C)
            want = row_call(op, ts, C, plain=True)
            err[op] = max(err.get(op, 0.0), check_gyro(
                torch, op, f"pe_{shape[0]}", got, again, want, 2e-4, 2e-5))
    err["csr_segment_sum"] = check_segsum(
        torch, gen, "pe_planned", plan_row.seg_sorted, PE_SLOTS, DIM,
        torch.float32)
    return err, table


def pe_epochs(torch, pe, run, pairs, epochs: int = 2):
    """``epochs`` epochs of a bench runner: the counts set to 0 before
    the last epoch and read after it (the first captures a graph, where
    the strategy has one); returns (losses of all epochs, counts)."""
    losses = []
    for e in range(epochs):
        if e == epochs - 1:
            torch.cuda.synchronize()
            pe_reset()
        losses.append(run.epoch())
    torch.cuda.synchronize()
    return torch.cat(losses).cpu().numpy(), pe_counts()


def pe_bitwise(torch, pe, name, cfg, pairs, plan, steps, seed):
    """A graphed epoch against the same steps run eagerly from the same
    state and generator: tables and losses bitwise equal."""
    from hyperspace_torch.benchmarks import poincare_bench as PB

    run = PB.make_runner(name, cfg, pairs, plan, steps, seed)
    eager = pe_clone(torch, run.state)
    graphed = run.epoch()
    cfg_r = run.cfg
    losses = []
    for _ in range(steps):
        if name == "planned_scan":
            eager, loss = pe.train_step_planned_packed(cfg_r, run.opt, eager,
                                                       plan)
        else:
            eager, loss = pe.train_step(cfg_r, run.opt, eager, pairs)
        losses.append(loss)
    a = run.state[0]
    same_t = bool(torch.equal(a, eager[0]))
    same_l = bool(torch.equal(graphed, torch.stack(losses)))
    return {"table_bitwise": same_t, "losses_bitwise": same_l,
            "max_abs_diff": float((a - eager[0]).abs().max())}


def poincare_path(torch, args, card: dict) -> dict:
    """Phases 24-29; returns what the kernels line needs."""
    import contextlib
    import dataclasses

    from hyperspace_torch.benchmarks import poincare_bench as PB
    from hyperspace_torch.cli import train as cli_train
    from hyperspace_torch.data.wordnet import synthetic_tree
    from hyperspace_torch.kernels.distmat import pdist_plain
    from hyperspace_torch.models import poincare_embed as pe

    dev = torch.device("cuda")
    # --- phase 24: card against CPU ---------------------------------------
    t0 = time.perf_counter()
    rel = pe_card_vs_cpu(torch, args)
    emit({"phase": "pe_card_vs_cpu", "max_rel_table_diff": rel,
          "rtol": PE_CARD_CPU_RTOL, "seconds": time.perf_counter() - t0})

    # --- phase 25: the kernels at this path's shapes ----------------------
    t0 = time.perf_counter()
    ds = synthetic_tree(PE_DEPTH, PE_BRANCH)
    assert (ds.num_nodes, ds.num_pairs) == (PE_ROWS, PE_PAIRS)
    cfg = PB.bench_config(ds.num_nodes)
    steps = ds.num_pairs // cfg.batch_size
    pairs = torch.as_tensor(ds.pairs, dtype=torch.int64, device=dev)
    plan = pe.plan_sparse_steps(cfg, ds.pairs, steps, seed=args.seed,
                                device=dev)
    row0 = pe._plan_row(plan, torch.zeros((), dtype=torch.int64,
                                          device=dev))
    err, table = pe_kernel_checks(torch, args, row0)
    times = pe_kernel_times(torch, table, row0)
    emit({"phase": "pe_checks", "max_abs_err": err,
          "seconds": time.perf_counter() - t0})

    # --- phase 26: every strategy, both optimizers -------------------------
    # one epoch of each stepwise strategy, two of each graphed one (the
    # first captures the graph), the counts read over the last.  RAdam's
    # loss falls within the first
    # epoch at this scale; RSGD's (lr 0.3 on a mean loss, 66,430 rows)
    # rises through burn-in and then falls by ~4e-4 an epoch, so its fall
    # is held over twelve graphed dense epochs
    t0 = time.perf_counter()
    launches = {k: 0 for k in pe_counts()}
    trained = None
    for optimizer in ("radam", "rsgd"):
        cfg_o = dataclasses.replace(cfg, optimizer=optimizer)
        for name in PB.STRATEGIES:
            run = PB.make_runner(name, cfg_o, pairs, plan, steps, args.seed)
            if name == "dense_scan" and optimizer == "radam":
                before = pe.evaluate(run.state.table, ds.pairs, C)
            epochs = 12 if (name, optimizer) == ("dense_scan", "rsgd") \
                else 2 if name.endswith("_scan") else 1
            losses, counts = pe_epochs(torch, pe, run, pairs, epochs)
            per = PE_PER_STEP[name] + (("ptransp",) if optimizer == "radam"
                                       else ())
            want = {k: steps if k in per else 0 for k in counts}
            first, last = float(losses[:50].mean()), float(
                losses[-50:].mean())
            falls = optimizer == "radam" or epochs == 12
            emit({"phase": "pe_train", "strategy": name,
                  "optimizer": optimizer, "steps": len(losses),
                  "launches_last_epoch": counts, "loss_first50": first,
                  "loss_last50": last, "fall_held": falls,
                  "seconds": time.perf_counter() - t0})
            if counts != want:
                raise AssertionError(f"poincare {optimizer} {name}: launches "
                                     f"{counts}, want {want}")
            if not np.all(np.isfinite(losses)) or (falls and not
                                                   last < first):
                raise AssertionError(
                    f"poincare {optimizer} {name}: losses not finite or not "
                    f"falling ({first} -> {last})")
            for k, n in counts.items():
                launches[k] += n
            if name == "dense_scan" and optimizer == "radam":
                trained = run.state.table
    radam = dataclasses.replace(cfg, optimizer="radam")
    bitwise = {}
    for name, c in (("dense_scan", cfg), ("mined_scan_radam", radam),
                    ("planned_scan_radam", radam)):
        base = name.removesuffix("_radam")
        pe_reset()
        bitwise[name] = pe_bitwise(torch, pe, base, c, pairs, plan, steps,
                                   args.seed + 1)
        if c is radam:
            n_pt = pe_counts()["ptransp"]
            bitwise[name]["ptransp_launches"] = n_pt
            if n_pt < steps:
                raise AssertionError(f"{name}: ptransp launched {n_pt} "
                                     f"times in {steps} Adam steps")
        if not (bitwise[name]["table_bitwise"]
                and bitwise[name]["losses_bitwise"]):
            raise AssertionError(f"poincare {name}: the graphed epoch "
                                 f"differs from eager: {bitwise[name]}")
    emit({"phase": "pe_graphed_vs_eager", "steps": steps, **bitwise,
          "seconds": time.perf_counter() - t0})

    # --- phase 27: evaluation ----------------------------------------------
    t0 = time.perf_counter()
    pe_reset()
    after = pe.evaluate(trained, ds.pairs, C)
    n_pdist = pe_counts()["pdist"]
    plain = pe.evaluate(trained, ds.pairs, C, dist_fn=pdist_plain)
    emit({"phase": "pe_eval", "before": before, "after": after,
          "plain_after": plain, "pdist_launches": n_pdist,
          "seconds": time.perf_counter() - t0, **card})
    if n_pdist != PE_EVAL_CHUNKS:
        raise AssertionError(f"evaluate launched pdist {n_pdist} times, "
                             f"want {PE_EVAL_CHUNKS}")
    launches["pdist"] += n_pdist
    if not after["map"] > before["map"]:
        raise AssertionError(f"MAP did not rise: {before} -> {after}")
    if not (abs(after["map"] - plain["map"]) <= 1e-3 and abs(
            after["mean_rank"] - plain["mean_rank"])
            <= 1e-3 * plain["mean_rank"]):
        raise AssertionError(f"kernel and plain evaluations differ: "
                             f"{after} vs {plain}")

    # --- phase 28: the bench leg and the large table ------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    bench = PB.run_poincare_bench(repeats=2, device="cuda", seed=args.seed)
    peak = torch.cuda.max_memory_allocated()
    # device busy time and idle share of 20 steps of each strategy (a
    # window of an epoch's ~20,000 device events is more than the
    # profiler keeps reliably), against the same 20 steps unprofiled
    busy = {}
    plan20 = pe.SparsePlan(*(a[:PE_PROFILE_STEPS] for a in plan))
    for name in PB.STRATEGIES:
        run = PB.make_runner(name, cfg, pairs, plan20, PE_PROFILE_STEPS,
                             args.seed)
        run.epoch()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run.epoch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
        busy[name] = {"wall_ms_20_steps": wall, **device_share(
            torch, run.epoch, wall, reps=1)}
    emit({"phase": "pe_bench", **{k: v for k, v in bench.items()
                                  if k != "epochs"},
          "epoch_spread": {n: e["spread"] for n, e in
                           bench["epochs"].items()},
          "step_ms": {n: e["s"] / steps * 1e3 for n, e in
                      bench["epochs"].items()},
          "device": busy, "peak_device_memory_bytes": peak,
          "seconds": time.perf_counter() - t0, **card})

    # --- phase 29: the CLI --------------------------------------------------
    t0 = time.perf_counter()
    pe_reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_train.main(["poincare", "--yaml", os.path.join(REPO, PE_CLI_YAML),
                        "steps=300"])
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    counts = pe_counts()
    emit({"phase": "pe_cli", "config": PE_CLI_YAML, **res,
          "launches": counts, "seconds": time.perf_counter() - t0, **card})
    if res["steps"] != 300 or not 0.0 < res["map"] <= 1.0:
        raise AssertionError(f"poincare CLI: {res}")
    return {"err": err, "launches": launches, "times": times}


def pe_kernel_times(torch, table, row) -> dict:
    """Device ms and bounds of the four kernels at this path's shapes
    (taken before the path's CUDA graphs and long profiler windows), keyed
    by kernel, under names ending in ``_pe_<shape>``."""
    from hyperspace_torch.kernels.distmat import pdist, pdist_plain
    from hyperspace_torch.kernels.scan_topk import scan_topk, scan_topk_plain
    from hyperspace_torch.kernels.segment import (csr_segment_sum,
                                                  csr_segment_sum_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    q = table[:PE_BATCH].contiguous()
    pool = table[torch.randint(0, PE_ROWS, (PE_POOL,), generator=gen,
                               device=dev)].contiguous()
    qi = torch.zeros(PE_BATCH, dtype=torch.int32, device=dev)
    vals = torch.randn(PE_SLOTS, DIM, generator=gen, device=dev)
    recv = row.seg_sorted
    r64 = recv.long()

    def lib():
        out = torch.zeros(PE_SLOTS, DIM, device=dev)
        return out.index_add_(0, r64, vals)

    t = {"pdist": {
        "ms_pe_eval": device_ms(torch, lambda: pdist(
            q, table, C, manifold="poincare")),
        "plain_ms_pe_eval": device_ms(torch, lambda: pdist_plain(
            q, table, C, manifold="poincare"), reps=5),
        "bound_ms_pe_eval": bound_ms(*pdist_cost(PE_BATCH, PE_ROWS, DIM))[0],
        "shape_pe_eval": [PE_BATCH, PE_ROWS, DIM]},
        "scan_topk": {
        "ms_pe_mine": device_ms(torch, lambda: scan_topk(
            pool, q, qi, 0, spec=("poincare", C), k=PE_NEG, n=PE_POOL)),
        "plain_ms_pe_mine": device_ms(torch, lambda: scan_topk_plain(
            pool, q, qi, 0, kind="poincare", c=C, k=PE_NEG, n=PE_POOL,
            exclude_self=False)),
        "bound_ms_pe_mine": bound_ms(*scan_cost(
            PE_BATCH, PE_POOL, PE_POOL, DIM, PE_NEG))[0],
        "shape_pe_mine": [PE_BATCH, PE_POOL, DIM, PE_NEG]},
        "csr_segment_sum": {
        "ms_pe_planned": device_ms(torch, lambda: csr_segment_sum(
            vals, recv, None, PE_SLOTS)),
        "plain_ms_pe_planned": device_ms(
            torch, lambda: csr_segment_sum_plain(vals, recv, PE_SLOTS)),
        "library_ms_pe_planned": device_ms(torch, lib),
        "bound_ms_pe_planned": bound_ms(*segment_cost(
            PE_SLOTS, DIM, PE_SLOTS, 4))[0],
        "shape_pe_planned": [PE_SLOTS, DIM]}}
    for op, shapes in (("expmap", {"dense": (PE_ROWS, DIM),
                                   "planned": (PE_SLOTS, DIM)}),
                       ("ptransp", {"large": (PE_BIG_ROWS, DIM),
                                    "planned": (PE_SLOTS, DIM)})):
        t[op] = {}
        for tag, shape in shapes.items():
            ts = row_inputs(torch, gen, op, shape, C, dev)
            t[op][f"ms_pe_{tag}"] = device_ms(
                torch, lambda ts=ts: row_call(op, ts, C))
            t[op][f"plain_ms_pe_{tag}"] = device_ms(
                torch, lambda ts=ts: row_call(op, ts, C, plain=True), reps=5)
            t[op][f"bound_ms_pe_{tag}"] = bound_ms(*row_cost(op, *shape))[0]
            t[op][f"shape_pe_{tag}"] = list(shape)
    return t


def pe_kernel_fields(pp: dict, kernels: list) -> None:
    """Add the Poincaré path's shapes to the kernels line: each kernel's
    times there (:func:`pe_kernel_times`), its launches on the path
    (``launches_pe``) and a step, and its largest error there."""
    per_step = {"pdist": ("launches_per_eval_pe", PE_EVAL_CHUNKS),
                "scan_topk": ("launches_per_mined_step_pe", 1),
                "csr_segment_sum": ("launches_per_planned_step_pe", 1),
                "expmap": ("launches_per_step_pe", 1),
                "ptransp": ("launches_per_radam_step_pe", 1)}
    for e in kernels:
        name = e["name"]
        if name in pp["times"]:
            key, n = per_step[name]
            e.update(pp["times"][name])
            e.update({"launches_pe": pp["launches"][name], key: n,
                      "max_abs_err_pe": pp["err"][name]})


# --- HGCN node classification: the first path to launch hyp_mlr at its head --

NC_STEPS = 10
# a step: 2 layers × (the clustered pairs' aggregation and the straggler
# scatter) forward and again in the backward; the head's forward (its
# gradient is the plain version's VJP, as JAX's)
NC_PER_STEP = {"csr_segment_sum": 4, "cluster_aggregate": 4, "hyp_mlr": 1}
NC_PER_EVAL = {"csr_segment_sum": 2, "cluster_aggregate": 2, "hyp_mlr": 1}
NC_CARD_CPU_NODES = 20_000


def nc_counts() -> dict:
    from hyperspace_torch.kernels import cluster as KC
    from hyperspace_torch.kernels.mlr import hyp_mlr
    from hyperspace_torch.kernels.segment import csr_segment_sum

    return {"csr_segment_sum": csr_segment_sum.launches,
            "cluster_aggregate": KC.cluster_aggregate.launches,
            "hyp_mlr": hyp_mlr.launches,
            "row_plan_builds": KC.row_plan_builds}


def nc_reset() -> None:
    from hyperspace_torch.kernels import cluster as KC
    from hyperspace_torch.kernels.mlr import hyp_mlr
    from hyperspace_torch.kernels.segment import csr_segment_sum

    csr_segment_sum.launches = KC.cluster_aggregate.launches = 0
    hyp_mlr.launches = KC.row_plan_builds = 0


def nc_setup(torch, g, device, seed: int):
    """The NC model on ``device``: Lorentz, hidden (128, 32), the LP
    bench's bf16 edge messages, the graph's 40 classes."""
    from hyperspace_torch.data import graphs as G
    from hyperspace_torch.models import hgcn

    cfg = hgcn.HGCNConfig(feat_dim=g.x.shape[1], hidden_dims=(128, 32),
                          kind="lorentz", num_classes=g.num_classes,
                          agg_dtype=torch.bfloat16)
    model, opt, state = hgcn.init_nc(cfg, g, seed=seed, device=device)
    ga = G.to_device(g, device)
    labels, train = hgcn.nc_targets(g, device)

    def step():
        nonlocal state
        state, loss = hgcn.train_step_nc(model, opt, state, ga, labels, train)
        return loss

    return model, ga, step


def check_counts(got: dict, per: dict, times: int, what: str) -> None:
    for name, n in per.items():
        if got[name] != n * times:
            raise AssertionError(f"{what}: {got[name]} {name} launches, "
                                 f"want {n} × {times}")
    if got.get("row_plan_builds"):
        raise AssertionError(f"{what}: {got['row_plan_builds']} row plans "
                             "built; the split's should serve them all")


def nc_path(torch, args, card: dict, tr: dict) -> dict:
    """Phases 30–32; returns the head's inputs and launches for the
    kernels line."""
    from hyperspace_torch.benchmarks import hgcn_bench as B
    from hyperspace_torch.models import hgcn

    dev = torch.device("cuda")
    # --- phase 30: the whole arxiv-scale graph with its classes ------------
    t0 = time.perf_counter()
    g = B.arxiv_scale_nc_graph(seed=args.seed, graph=tr["graph"])
    prep_s = time.perf_counter() - t0
    cs = g.cluster_split
    if cs is None:
        raise AssertionError("no cluster split on the NC graph")
    model, ga, step = nc_setup(torch, g, dev, args.seed)
    emit({"phase": "nc_setup", "host_prep_s": prep_s,
          "seconds": time.perf_counter() - t0, "nodes": g.num_nodes,
          "edges_real": g.num_edges, "classes": g.num_classes,
          "frac_clustered": cs.frac_clustered,
          "train_val_test": [int(g.train_mask.sum()), int(g.val_mask.sum()),
                             int(g.test_mask.sum())]})

    # --- phase 31: the NC path: a warm-up and 10 timed steps, an evaluation
    t0 = time.perf_counter()
    first_input = nc_head_input(torch, model, ga)      # the first step's
    torch.cuda.synchronize()
    nc_reset()
    torch.cuda.reset_peak_memory_stats()
    warm = float(step())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = [step() for _ in range(NC_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / NC_STEPS * 1e3
    launches = nc_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    check_counts(launches, NC_PER_STEP, NC_STEPS + 1, "NC steps")
    nc_reset()
    ev = hgcn.evaluate_nc(model, g, ga=ga)
    eval_launches = nc_counts()
    check_counts(eval_launches, NC_PER_EVAL, 1, "NC evaluation")
    emit({"phase": "nc_train", "steps": NC_STEPS, "warmup_loss": warm,
          "losses": losses, "step_ms": step_ms,
          "nodes_per_s": g.num_nodes / step_ms * 1e3,
          "launches": launches, "launches_eval": eval_launches,
          "peak_device_memory_bytes": peak, **ev,
          "seconds": time.perf_counter() - t0, **card})
    # held against the first step's loss (the warm-up): at lr 1e-2 the
    # first update takes most of the fall, and the next ten wander
    if not np.all(np.isfinite(losses + [warm])):
        raise AssertionError(f"non-finite NC loss: {losses}")
    if not losses[-1] < warm:
        raise AssertionError(f"the NC loss did not fall: {warm}, {losses}")
    t1 = time.perf_counter()
    share = device_share(torch, step, step_ms, reps=3, top_n=8)
    emit({"phase": "nc_profile", "step_ms": step_ms, **share,
          "seconds": time.perf_counter() - t1, **card})

    # the scatter kernels on this graph's own edge sets, as its steps call
    # them: the straggler receivers and the clustered pairs with their row
    # plan, bf16 at both layers' widths
    t1 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    agg, n, bf16 = ga.cluster, g.num_nodes, torch.bfloat16
    n_strag = int(cs.s_mask.sum())
    scatter_err = {
        "csr_segment_sum": max(check_segsum(
            torch, gen, "NC stragglers", agg.s_recv, n, f, bf16, n_strag)
            for f in (128, 32)),
        "cluster_aggregate": max(check_cluster(
            torch, gen, "NC clustered", agg, n, f, bf16) for f in (128, 32))}
    emit({"phase": "nc_scatter_checks", "straggler_edges": n_strag,
          "clustered_edges": int(agg.c_recv.shape[0]),
          "max_abs_err": scatter_err, "seconds": time.perf_counter() - t1})

    # the head's own inputs: at the first step, against the plain version
    # at the tier of phase 12's head check; after the steps, where the
    # encoder has carried every point to the ball's rim in f32 (ROADMAP
    # §C), against float64 no worse than the plain version
    err = check_nc_head(torch, "first_step", first_input)
    after = nc_head_input(torch, model, ga)
    check_nc_head(torch, "after_steps", after)

    # --- phase 32: two steps on the card against two on the CPU -----------
    t0 = time.perf_counter()
    g20 = B.arxiv_scale_nc_graph(NC_CARD_CPU_NODES, seed=args.seed)
    if g20.cluster_split is None or not len(g20.cluster_split.c_recv):
        raise AssertionError("the 20,000-node NC graph clusters no edge")
    runs = {}
    for where in ("cuda", "cpu"):
        _m20, _g20, step20 = nc_setup(torch, g20, torch.device(where),
                                      args.seed)
        runs[where] = [float(step20()) for _ in range(2)]
    rel = max(abs(a_ - b_) / abs(b_) for a_, b_ in zip(runs["cuda"],
                                                       runs["cpu"]))
    emit({"phase": "nc_card_vs_cpu", "nodes": NC_CARD_CPU_NODES,
          "frac_clustered": g20.cluster_split.frac_clustered,
          "losses_cuda": runs["cuda"], "losses_cpu": runs["cpu"],
          "max_rel_loss_diff": rel, "seconds": time.perf_counter() - t0})
    if not rel <= CARD_CPU_RTOL:
        raise AssertionError(f"NC card and CPU losses differ by {rel}")
    return {"head": after, "launches": launches, "err": err,
            "scatter_err": scatter_err}


def nc_head_input(torch, model, ga):
    """(x, p, a, c) as the NC head hands them to ``hyp_mlr``: the ball
    image of the encoder's output, the hyperplane points and normals."""
    from hyperspace_torch.manifolds.maps import lorentz_to_ball

    with torch.no_grad():
        z, _m = model.encoder(ga)
        head = model.head
        c = head.manifold.c
        return (lorentz_to_ball(z, c).contiguous(),
                head.manifold.expmap0(head.p_tangent).contiguous(),
                head.a.detach().contiguous(), c)


NC_RIM_SLACK = 1.1


def check_nc_head(torch, which: str, head, tag: str = "") -> float:
    """``hyp_mlr`` on an NC head input, launched twice for the same bits.
    Where the rows keep clear of the ball's rim (``first_step``) the
    logits are held against the plain version at phase 12's tier; where
    1 − ‖x‖² is below f32's resolution (``after_steps``) no f32 order of
    operations is within that tier of another, so the kernel's largest
    error against float64 is held to at most ``NC_RIM_SLACK`` times the
    f32 plain version's.  Returns the largest gap to the plain version."""
    from hyperspace_torch.kernels.mlr import hyp_mlr, hyp_mlr_plain

    x, p, a, c = head
    got = hyp_mlr(x, p, a, c)
    again = hyp_mlr(x, p, a, c)
    torch.cuda.synchronize()
    want = hyp_mlr_plain(x, p, a, c)
    f64 = hyp_mlr_plain(x.double(), p.double(), a.double(), c)
    tier = MLR_ATOL + MLR_RTOL * f64.abs()
    err_k = (got.double() - f64).abs()
    err_p = (want.double() - f64).abs()
    rim = 1.0 - torch.sum(x.double() ** 2, dim=-1)
    diff = (got - want).abs()
    over = int((diff > MLR_ATOL + MLR_RTOL * want.abs()).sum())
    same = bool(torch.equal(got, again))
    out = {"phase": "check", "kernel": "hyp_mlr",
           "input": f"nc_head_{which}{tag}",
           "shape": [x.shape[0], p.shape[0], x.shape[1]],
           "max_abs_err": float(diff.max()), "over_tolerance": over,
           "repeat_equal": same, "kernel_f64_over_tier": float(
               (err_k / tier).max()),
           "plain_f64_over_tier": float((err_p / tier).max()),
           "kernel_f64_max": float(err_k.max()),
           "plain_f64_max": float(err_p.max()),
           "rim_gap_min_median_max": [float(rim.min()), float(rim.median()),
                                      float(rim.max())],
           "logit_abs_max": float(f64.abs().max())}
    emit(out)
    if not same:
        raise AssertionError(f"hyp_mlr at the NC head ({which}): repeats "
                             "differ")
    if which == "first_step" and over:
        raise AssertionError(f"hyp_mlr at the NC head ({which}): {over} "
                             "logits beyond tolerance")
    if which != "first_step" and not (out["kernel_f64_max"]
                                      <= NC_RIM_SLACK * out["plain_f64_max"]):
        raise AssertionError(f"hyp_mlr at the NC head ({which}): further "
                             "from float64 than the plain version")
    return float(diff.max())


def nc_kernel_fields(torch, nc: dict, kernels: list) -> None:
    """Add the NC path to the kernels line: ``hyp_mlr`` at the head's own
    input (device ms, plain ms, bound, launches on the path, a step and an
    evaluation; no library call computes the MLR logits), and the scatter
    kernels' launches there."""
    from hyperspace_torch.kernels.mlr import hyp_mlr, hyp_mlr_plain

    xb, p, a, c = nc["head"]
    shape = (xb.shape[0], p.shape[0], xb.shape[1])
    bound, by = bound_ms(*mlr_cost(*shape))
    for e in kernels:
        name = e["name"]
        if name in NC_PER_STEP:
            e.update({"launches_nc": nc["launches"][name],
                      "launches_per_step_nc": NC_PER_STEP[name],
                      "launches_per_eval_nc": NC_PER_EVAL[name]})
        if name in nc["scatter_err"]:
            e["max_abs_err_nc"] = nc["scatter_err"][name]
        if name == "hyp_mlr":
            e.update({
                "ms_nc_head": device_ms(torch, lambda: hyp_mlr(xb, p, a, c)),
                "plain_ms_nc_head": device_ms(
                    torch, lambda: hyp_mlr_plain(xb, p, a, c), reps=5),
                "bound_ms_nc_head": bound, "bound_by_nc_head": by,
                "library_ms_nc_head": None, "shape_nc_head": list(shape),
                "max_abs_err_nc_head_first_step": nc["err"]})


# --- the hyperbolic VAE (BASELINE.json configs[3]) -------------------------

HVAE_KINDS = ("poincare", "lorentz")
HVAE_IMAGES = 4096
HVAE_STEPS = 50
HVAE_CARD_CPU_STEPS = 3
HVAE_CARD_CPU_RTOL = 1e-4       # all f32, cuDNN's TF32 off
HVAE_IWAE_K, HVAE_IWAE_IMAGES = 16, 256
HVAE_CLI_YAML = os.path.join("configs", "hvae_mnist.yaml")
HVAE_CHUNK = 8                  # the graphed chunk held against eager
# graphed against eager without cuDNN's determinism, as the path runs: its
# weight gradients sum in another order each run (with determinism the two
# are bitwise equal, so the graph adds no gap of its own); after 8 steps the
# gap was up to 1.3e-6 (parameters, norm-wise) and 2.6e-6 (metrics) on the
# H100 (PERF.md §6)
HVAE_GRAPH_RTOL = 1e-5
HVAE_CLI_CHUNK = 100            # the CLI's 800 steps in 8 graphed chunks


def hvae_cfg(kind: str):
    """``configs/hvae_mnist.yaml``'s width: hidden 256, conv (32, 64),
    latent 8, batch 128, c = 1."""
    from hyperspace_torch.models import hvae

    return hvae.HVAEConfig(latent_dim=8, batch_size=128, hidden=256,
                           conv_features=(32, 64), kind=kind, c=1.0)


def hvae_card_vs_cpu(torch, args, images) -> dict:
    """3 steps on the card and on the CPU from the same parameters with
    the same injected ids and ε: the largest relative gap of loss, recon
    and kl, and of each parameter norm-wise (‖card − CPU‖ / ‖CPU‖: Adam
    divides each gradient by its own root mean square, so an entry whose
    gradient cancels to rounding noise moves by up to lr·|noise| /
    (|noise| + eps) on either device); the largest entry gap beside."""
    from hyperspace_torch.models import hvae

    out = {}
    for kind in HVAE_KINDS:
        cfg = hvae_cfg(kind)
        gen = torch.Generator().manual_seed(args.seed + 31)
        p0 = hvae.init_params(cfg, gen)
        draws = [(torch.randint(0, len(images), (cfg.batch_size,),
                                generator=gen),
                  torch.randn((cfg.batch_size, cfg.latent_dim),
                              generator=gen))
                 for _ in range(HVAE_CARD_CPU_STEPS)]
        runs = {}
        for where in ("cuda", "cpu"):
            model, opt, st = hvae.init_model(cfg, args.seed, where,
                                             params=p0)
            x = torch.as_tensor(images, device=where)
            metrics = []
            for idx, eps in draws:
                st, *m = hvae.train_step_sampled(
                    model, opt, st, x, idx=idx.to(where), eps=eps.to(where))
                metrics.append([float(v) for v in m])
            runs[where] = (np.asarray(metrics), {
                f"{a}/{b}/{c}": t.cpu() for a, la in st.params.items()
                for b, lb in la.items() for c, t in lb.items()})
        mc, mp = runs["cuda"]
        cc, cp = runs["cpu"]
        rel_m = float(np.max(np.abs(mc - cc) / np.abs(cc)))
        norm = torch.linalg.vector_norm
        rel_p = max(float(norm(mp[k] - v) / norm(v)) for k, v in cp.items())
        out[kind] = {"metrics_cuda": mc.tolist(), "metrics_cpu": cc.tolist(),
                     "max_rel_metric_diff": rel_m,
                     "max_rel_param_diff": rel_p,
                     "max_abs_param_diff": max(float((mp[k] - v).abs().max())
                                               for k, v in cp.items())}
        if not (rel_m <= HVAE_CARD_CPU_RTOL and rel_p <= HVAE_CARD_CPU_RTOL):
            raise AssertionError(f"HVAE {kind}: card and CPU differ "
                                 f"(metrics {rel_m}, parameters {rel_p})")
    return out


def hvae_path(torch, args, card: dict) -> dict:
    """Phases 33–35 (no CUDA graph); returns the bench leg for phase 36."""
    from hyperspace_torch.benchmarks import workloads_bench as W
    from hyperspace_torch.data.mnist import synthetic_mnist
    from hyperspace_torch.models import hvae

    dev = torch.device("cuda")
    # --- phase 33: card against CPU, both latent geometries ---------------
    t0 = time.perf_counter()
    images = synthetic_mnist(num_samples=HVAE_IMAGES, seed=args.seed).images
    data_s = time.perf_counter() - t0
    cvc = hvae_card_vs_cpu(torch, args, images)
    emit({"phase": "hvae_card_vs_cpu", "images": HVAE_IMAGES,
          "data_s": data_s, "steps": HVAE_CARD_CPU_STEPS, **cvc,
          "seconds": time.perf_counter() - t0})

    # --- phase 34: sampled steps on the card, then the IWAE bound ---------
    x_all = torch.as_tensor(images, device=dev)
    for kind in HVAE_KINDS:
        t0 = time.perf_counter()
        cfg = hvae_cfg(kind)
        model, opt, st = hvae.init_model(cfg, args.seed, dev)
        losses = []
        for _ in range(HVAE_STEPS):
            st, loss, recon, kl = hvae.train_step_sampled(model, opt, st,
                                                          x_all)
            losses.append(loss)
        losses = torch.stack(losses).cpu().numpy()
        first, last = float(losses[:10].mean()), float(losses[-10:].mean())
        x = x_all[:HVAE_IWAE_IMAGES]
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        eps = torch.randn((HVAE_IWAE_K, HVAE_IWAE_IMAGES, cfg.latent_dim),
                          generator=gen, device=dev)
        iwae = float(hvae.iwae_bound(model, st.params, x, k=HVAE_IWAE_K,
                                     eps=eps))
        with torch.no_grad(), hvae.f32_convolutions():   # the same K draws
            prior = model.prior(x.dtype, dev)
            elbo = float(torch.stack([torch.mean(torch.sub(*hvae.elbo_terms(
                model(st.params, x, eps=e), prior, x))) for e in eps]).mean())
        emit({"phase": "hvae_train", "kind": kind, "steps": HVAE_STEPS,
              "losses_first_10_mean": first, "losses_last_10_mean": last,
              "last_recon": float(recon), "last_kl": float(kl),
              "iwae_k16_256": iwae, "elbo_same_draws": elbo,
              "seconds": time.perf_counter() - t0, **card})
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"HVAE {kind}: non-finite loss")
        if not last < first:
            raise AssertionError(f"HVAE {kind}: the loss did not fall "
                                 f"({first} -> {last})")
        if not (np.isfinite(iwae) and iwae >= elbo):
            raise AssertionError(f"HVAE {kind}: IWAE {iwae} below the ELBO "
                                 f"{elbo} of the same draws")

    # --- phase 35: the bench leg, stepwise ---------------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    leg = W.setup_hvae_leg(device=dev, seed=args.seed)
    res = W.run_hvae_leg(leg, steps=10, repeats=3, chunk=0)
    share = device_share(torch, leg.step, res["step_ms"], reps=5, top_n=8)
    emit({"phase": "hvae_bench", **{k: v for k, v in res.items()
                                    if k != "losses"},
          "loss_first": res["losses"][0], "loss_last": res["losses"][-1],
          **share,
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t0, **card})
    return {"leg": leg, "images": x_all, "seed": args.seed}


def cudnn_flags(torch, deterministic: bool):
    """cuDNN as the HVAE runs it (TF32 off, no autotuning), its
    deterministic algorithms on or off, for the span of the block."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=deterministic,
                                      allow_tf32=False)


def hvae_graph_vs_eager(torch, hv: dict, kind: str,
                        deterministic: bool) -> dict:
    """A graphed chunk of ``HVAE_CHUNK`` sampled steps against the same
    steps run eagerly from the same state and generator, captured and run
    with cuDNN's determinism on or off: bitwise equality, and the largest
    relative gaps (parameters norm-wise, metrics entry-wise)."""
    from hyperspace_torch.models import hvae
    from hyperspace_torch.train import loop

    with cudnn_flags(torch, deterministic):
        model, opt, st = hvae.init_model(hvae_cfg(kind), 7, "cuda")
        eager = pe_clone(torch, st)
        rows = []
        for _ in range(HVAE_CHUNK):
            eager, *m = hvae.train_step_sampled(model, opt, eager,
                                                hv["images"])
            rows.append(torch.stack(m))
        chunk = loop.make_chunked_stepper(hvae.chunk_step(model, opt),
                                          HVAE_CHUNK)
        st, graphed = chunk(st, hv["images"])
        torch.cuda.synchronize()
    rows = torch.stack(rows)
    leaves = list(zip(torch.utils._pytree.tree_leaves(st.params),
                      torch.utils._pytree.tree_leaves(eager.params)))
    out = {"params_bitwise": all(bool(torch.equal(a, b)) for a, b in leaves),
           "metrics_bitwise": bool(torch.equal(graphed, rows)),
           "max_param_rel": max(float(torch.linalg.vector_norm(a - b)
                                      / torch.linalg.vector_norm(b))
                                for a, b in leaves),
           "max_metric_rel": float(((graphed - rows).abs()
                                    / rows.abs()).max())}
    _st, again = chunk(st, hv["images"])          # a replay, no capture
    out["replay_finite"] = bool(torch.isfinite(again).all())
    return out


def hvae_graphs(torch, hv: dict, card: dict) -> None:
    """Phases 36–37 (after every profiled time): the bench leg's graphed
    chunks with cuDNN's determinism off (the path) and on, a graphed chunk
    against the same steps run eagerly from the same state and generator
    on both geometries (bitwise under determinism, within
    ``HVAE_GRAPH_RTOL`` without), and the CLI's config in graphed
    chunks."""
    from hyperspace_torch.benchmarks import workloads_bench as W
    from hyperspace_torch.cli import train as train_cli

    # --- phase 36: graphed chunks -----------------------------------------
    # the path runs without cuDNN's determinism; with it on, a graphed
    # chunk is the eager steps bit for bit, and the leg is timed both ways
    t0 = time.perf_counter()
    leg = hv["leg"]
    chunks = W.run_hvae_chunks(leg, W.SCAN_CHUNK_K, repeats=3)
    chunk_losses = chunks.pop("losses")
    with cudnn_flags(torch, True):
        det_leg = W.setup_hvae_leg(device="cuda", seed=hv["seed"])
        det = W.run_hvae_chunks(det_leg, W.SCAN_CHUNK_K, repeats=3)
    del det_leg
    agree = {}
    for kind in HVAE_KINDS:
        agree[kind] = {"deterministic": hvae_graph_vs_eager(torch, hv, kind,
                                                            True)}
        agree[kind]["path"] = hvae_graph_vs_eager(torch, hv, kind, False)
    emit({"phase": "hvae_graphs", **chunks,
          "scan_chunk_step_ms_cudnn_deterministic":
              det["scan_chunk_step_ms"],
          "scan_chunk_repeat_ms_cudnn_deterministic":
              det["scan_chunk_repeat_ms"],
          "chunk_loss_first_last": [chunk_losses[0], chunk_losses[-1]],
          "chunk": HVAE_CHUNK, "graphed_vs_eager": agree,
          "path_rtol": HVAE_GRAPH_RTOL,
          "seconds": time.perf_counter() - t0, **card})
    for kind, a in agree.items():
        d, p = a["deterministic"], a["path"]
        if not (d["params_bitwise"] and d["metrics_bitwise"]
                and d["replay_finite"] and p["replay_finite"]):
            raise AssertionError(f"HVAE {kind}: under cuDNN's determinism "
                                 "the graphed chunk is not the eager steps "
                                 f"bit for bit: {a}")
        if not (p["max_param_rel"] <= HVAE_GRAPH_RTOL
                and p["max_metric_rel"] <= HVAE_GRAPH_RTOL):
            raise AssertionError(f"HVAE {kind}: the graphed chunk is beyond "
                                 f"rel {HVAE_GRAPH_RTOL} of the eager steps: "
                                 f"{a}")

    # --- phase 37: the CLI at configs/hvae_mnist.yaml, graphed chunks -----
    # (its 800 steps eagerly are host-bound: 47 ms a step on this path's
    # stepwise bench leg on the H100, PERF.md §6)
    t0 = time.perf_counter()
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        train_cli.main(["hvae", "--yaml", HVAE_CLI_YAML,
                        f"scan_chunk={HVAE_CLI_CHUNK}"])
    finally:
        sys.stdout = old
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    emit({"phase": "hvae_cli", "config": HVAE_CLI_YAML,
          "scan_chunk": HVAE_CLI_CHUNK, **res,
          "seconds": time.perf_counter() - t0, **card})
    if not all(np.isfinite(res[k]) for k in ("loss", "recon", "kl", "iwae")):
        raise AssertionError(f"the HVAE CLI's metrics are not finite: {res}")


# --- phases 38-43: HGCN as its users launch it, through the CLI ------------

# the arxiv layout: community_power_law_graph at its defaults (ogbn-arxiv's
# statistics: 169,343 nodes, 1,166,243 edges, 128 features, 40 classes)
# written by data.graphs.write_ogb_csv_layout; the Cora layout: a graph of
# Cora's size (2,708 papers, 5,429 citations, 1,433 binary words, 7
# classes) in the Planetoid format
CORA_SHAPE = dict(num_nodes=2708, num_edges=5429, num_classes=7,
                  feat_dim=1433)
CLI_LP_YAML = os.path.join("configs", "hgcn_arxiv_lp.yaml")
CLI_STEPS = 12
CLI_NC_STEPS = CLI_ATT_STEPS = 5
PLANNED_STEPS = 10
# launches a step of the CLI's train_step_lp: 2 layers × (the clustered
# pairs' aggregation and the straggler scatter) forward and again in the
# backward; the decoder's pairs are plain gathers (their backward is
# PyTorch's index_put_); an evaluation scores the test positives and the
# test negatives, one encoder forward each
CLI_LP_PER_STEP = {"csr_segment_sum": 4, "cluster_aggregate": 4}
CLI_LP_PER_EVAL = {"csr_segment_sum": 4, "cluster_aggregate": 4}
# train_step_lp_planned: the encoder's, graph_edge_sqdist's one [E, 33]
# scatter for both endpoints, and the negatives' sorted u side
PLANNED_PER_STEP = {"csr_segment_sum": 6, "cluster_aggregate": 4}
# the attention arm on a graph under 200,000 edges (no cluster split): a
# layer's planned partial (csr_segment_sum over [E, F + 1]) forward, its
# dh scatter, edge pass and α_s reduction backward; an evaluation the two
# forwards
CLI_ATT_PER_STEP = {"csr_segment_sum": 4, "csr_att_bwd_edges": 2,
                    "csr_segment_reduce_1d": 2}
CLI_ATT_PER_EVAL = {"csr_segment_sum": 4}
LEARN_C_NODES = 20_000
LEARN_C_STEPS = 2


def run_cli(argv: list) -> dict:
    """``cli.train.main(argv)`` in this process; its JSON line."""
    from contextlib import redirect_stdout

    from hyperspace_torch.cli import train as cli_train

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli_train.main(argv)
    if rc != 0:
        raise AssertionError(f"cli.train {argv[0]} exited {rc}")
    return json.loads(buf.getvalue().splitlines()[-1])


def read_log(path: str) -> list:
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


def check_cli_counts(got: dict, per_step: dict, per_eval: dict, steps: int,
                     what: str) -> None:
    """Launches of a CLI run: ``steps`` steps and one evaluation."""
    for name in set(per_step) | set(per_eval):
        want = steps * per_step.get(name, 0) + per_eval.get(name, 0)
        if got[name] != want:
            raise AssertionError(f"{what}: {got[name]} {name} launches, want "
                                 f"{steps} × {per_step.get(name, 0)} + "
                                 f"{per_eval.get(name, 0)}")
    if got.get("row_plan_builds"):
        raise AssertionError(f"{what}: {got['row_plan_builds']} row plans "
                             "built; the split's should serve them all")


def check_losses(losses: list, what: str, first=None) -> None:
    first = losses[0] if first is None else first
    if not np.all(np.isfinite(losses + [first])):
        raise AssertionError(f"{what}: non-finite loss {losses}")
    if not losses[-1] < first:
        raise AssertionError(f"{what}: the loss did not fall: {losses}")


def layouts_equal(a, b) -> bool:
    """Two prepared graphs' edge layouts, cluster split included, bit
    for bit."""
    def arrays(g):
        out = [g.senders, g.receivers, g.edge_mask, g.rev_perm, g.deg,
               *g.csr_plan]
        cs = g.cluster_split
        if cs is not None:
            out += [v for v in cs if isinstance(v, np.ndarray)]
            out += [v for part in (cs.c_plan, cs.s_plan, cs.c_rows)
                    if part is not None for v in part
                    if isinstance(v, np.ndarray)]
        return out

    xa, xb = arrays(a), arrays(b)
    return len(xa) == len(xb) and all(
        u.dtype == v.dtype and np.array_equal(u, v) for u, v in zip(xa, xb))


def cli_path(torch, args, card: dict) -> dict:
    """Phases 38–43; returns what the kernels line takes from them."""
    from hyperspace_torch.data import graphs as G
    from hyperspace_torch.data import native
    from hyperspace_torch.data import prep_cache
    from hyperspace_torch.models import hgcn

    dev = torch.device("cuda")
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=work)
    try:
        return _cli_phases(torch, args, card, dev, tmp, G, native,
                           prep_cache, hgcn)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _cli_phases(torch, args, card, dev, tmp, G, native, prep_cache, hgcn):
    arxiv_dir, cora_dir = (os.path.join(tmp, d) for d in ("arxiv", "cora"))
    # --- phase 38: the disk layouts --------------------------------------
    t0 = time.perf_counter()
    edges, x, labels, k = G.community_power_law_graph(seed=args.seed)
    gen_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    G.write_ogb_csv_layout(arxiv_dir, edges, x, labels)
    write_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    e_l, x_l, lab_l, k_l = G.load_ogbn_arxiv(arxiv_dir)
    load_s = time.perf_counter() - t1
    if not (np.array_equal(e_l, edges) and np.array_equal(lab_l, labels)
            and k_l == k == len(np.unique(labels)) == 40):
        raise AssertionError("the arxiv layout did not load back")
    x_err = float(np.max(np.abs(x_l - x) / np.maximum(np.abs(x), 1e-30)))
    if not x_err <= 5e-6 + 2.0 ** -23:      # %.6g, then an f32 rounding
        raise AssertionError(f"features loaded {x_err} off")
    size = sum(os.path.getsize(os.path.join(arxiv_dir, "raw", f))
               for f in os.listdir(os.path.join(arxiv_dir, "raw")))
    t1 = time.perf_counter()
    ce, cx, cl, ck = G.community_power_law_graph(seed=args.seed,
                                                 **CORA_SHAPE)
    cx = (cx > 1.5).astype(np.float32)             # binary words
    G.write_cora_layout(cora_dir, ce, cx, cl)
    cora_write_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    cora = G.load_cora(cora_dir)
    cora_load_s = time.perf_counter() - t1
    if not (np.array_equal(cora[0], ce) and np.array_equal(cora[1], cx)):
        raise AssertionError("the Cora layout did not load back")
    emit({"phase": "cli_layouts", "nodes": len(x), "edges": len(edges),
          "classes": k, "feat_dim": x.shape[1], "generate_s": gen_s,
          "write_s": write_s, "load_s": load_s, "bytes": size,
          "feature_max_rel_err": x_err, "cora_nodes": len(cx),
          "cora_edges": len(ce), "cora_write_s": cora_write_s,
          "cora_load_s": cora_load_s,
          "seconds": time.perf_counter() - t0})

    # --- phase 39: host prep, native against numpy; the prep cache -------
    t0 = time.perf_counter()
    n = len(x_l)
    times = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        times[name] = time.perf_counter() - t
        return out

    if not native.available():
        raise AssertionError("the native host prep did not build")
    order_n = timed("bfs_native_s", lambda: native.locality_order(e_l, n))
    order_p = timed("bfs_python_s", lambda: G._locality_order_python(e_l, n))
    if not np.array_equal(order_n, order_p):
        raise AssertionError("native and Python BFS orders differ")
    er, xr, lr, _ = G.apply_locality_order(e_l, x_l, lab_l, cache=False)
    lay_n = timed("layout_native_s", lambda: native.prepare_edges(er, n))
    lay_p = timed("layout_numpy_s", lambda: G._prepare_edges_numpy(er, n))
    if not all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(lay_n, lay_p)):
        raise AssertionError("native and numpy edge layouts differ")
    pc = prep_cache.PrepCache(os.path.join(tmp, "cache"))
    g_miss = timed("cache_miss_s", lambda: G.prepare(er, n, xr, cache=pc))
    g_hit = timed("cache_hit_s", lambda: G.prepare(er, n, xr, cache=pc))
    if (pc.misses, pc.hits) != (1, 1) or not layouts_equal(g_miss, g_hit):
        raise AssertionError(f"prep cache: {pc.misses} misses, {pc.hits} "
                             "hits, or the layouts differ")
    if not times["cache_hit_s"] < times["cache_miss_s"]:
        raise AssertionError(f"the cache hit was not faster: {times}")
    emit({"phase": "cli_host_prep", **times, "edges_real": g_miss.num_edges,
          "frac_clustered": g_miss.cluster_split.frac_clustered,
          "prep": g_miss.prep, "seconds": time.perf_counter() - t0})
    del g_hit, lay_n, lay_p

    # --- phase 40: cli.train hgcn --yaml configs/hgcn_arxiv_lp.yaml -------
    t0 = time.perf_counter()
    log = os.path.join(tmp, "lp.jsonl")
    nc_reset()
    torch.cuda.reset_peak_memory_stats()
    out = run_cli(["hgcn", "--yaml", CLI_LP_YAML, f"data_root={arxiv_dir}",
                   f"steps={CLI_STEPS}", "graph_cache=false", f"log={log}",
                   "eval_every=1"])
    launches = nc_counts()
    cli_peak = torch.cuda.max_memory_allocated()
    losses = read_log(log)
    emit({"phase": "cli_lp", "result": out, "losses": losses,
          "launches": launches, "peak_device_memory_bytes": cli_peak,
          "seconds": time.perf_counter() - t0, **card})
    if out["prep"] != "native" or out["source"] != "disk":
        raise AssertionError(f"cli lp: prep {out['prep']}, {out['source']}")
    check_losses(losses, "cli lp")
    check_cli_counts(launches, CLI_LP_PER_STEP, CLI_LP_PER_EVAL, CLI_STEPS,
                     "cli lp")
    # the CLI's step timed and profiled on the identical split, built as
    # the CLI builds it (the yaml's BFS relabeling, split_edges' defaults)
    t1 = time.perf_counter()
    split = G.split_edges(er, n, xr, seed=0, cache=False,
                          cluster_min_pair=G.cluster_min_pair_for(False))
    split_s = time.perf_counter() - t1
    cfg = hgcn.HGCNConfig(feat_dim=xr.shape[1], hidden_dims=(128, 32),
                          kind="lorentz", agg_dtype=torch.bfloat16,
                          decoder_dtype=torch.bfloat16)
    model, opt, state = hgcn.init_lp(cfg, split.graph, seed=0, device=dev)
    ga = G.to_device(split.graph, dev)
    train_pos = G.index_tensor(split.train_pos, dev)

    def lp_step():
        nonlocal state
        state, loss = hgcn.train_step_lp(model, opt, n, state, ga, train_pos)
        return loss

    torch.cuda.reset_peak_memory_stats()
    float(lp_step())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        lp_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / TRAIN_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    share = device_share(torch, lp_step, step_ms, reps=3, top_n=8)
    cs = split.graph.cluster_split
    clustered_in = np.bincount(cs.c_recv, minlength=n)
    emit({"phase": "cli_lp_profile", "split_s": split_s, "step_ms": step_ms,
          "samples_per_s": n / step_ms * 1e3, "nodes": n,
          "edges_real": split.graph.num_edges,
          "max_in_degree": int(split.graph.deg.max()),
          "rows_with_clustered_edges": int((clustered_in > 0).sum()),
          "max_clustered_in_degree": int(clustered_in.max()),
          "frac_clustered": cs.frac_clustered,
          "train_pairs": len(split.train_pos),
          "peak_device_memory_bytes": peak,
          "test_roc_auc_cli": out["roc_auc"], **share, **card})

    # --- phase 41: train_step_lp_planned on the same split ---------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 41)
    e_real = split.graph.num_edges
    bf16 = torch.bfloat16
    edge_err = max(check_segsum(torch, gen, "graph edges", ga.receivers, n,
                                33, bf16, e_real),
                   check_segsum(torch, gen, "graph edges, unaligned view",
                                ga.receivers, n, 33, bf16, -e_real))
    # the encoder's scatters on this graph's own edge sets, as in phase 31
    n_strag = int(cs.s_mask.sum())
    scatter_err = {
        "csr_segment_sum": max(check_segsum(
            torch, gen, "CLI stragglers", ga.cluster.s_recv, n, f, bf16,
            n_strag) for f in (128, 32)),
        "cluster_aggregate": max(check_cluster(
            torch, gen, "CLI clustered", ga.cluster, n, f, bf16)
            for f in (128, 32))}
    neg_u, neg_plan = hgcn.make_static_negatives(n, len(split.train_pos),
                                                 seed=0, device=dev)
    model_p, opt_p, state_p = hgcn.init_lp(cfg, split.graph, seed=0,
                                           device=dev)

    def planned_step():
        nonlocal state_p
        state_p, loss = hgcn.train_step_lp_planned(
            model_p, opt_p, n, state_p, ga, neg_u, neg_plan)
        return loss

    nc_reset()
    warm = float(planned_step())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    p_losses = [planned_step() for _ in range(PLANNED_STEPS)]
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t1) / PLANNED_STEPS * 1e3
    p_launches = nc_counts()
    p_losses = [float(v) for v in p_losses]
    check_counts(p_launches, PLANNED_PER_STEP, PLANNED_STEPS + 1,
                 "planned steps")
    check_losses(p_losses, "planned steps", first=warm)
    p_share = device_share(torch, planned_step, p_ms, reps=3, top_n=8)
    emit({"phase": "cli_planned", "warmup_loss": warm, "losses": p_losses,
          "step_ms": p_ms, "samples_per_s": n / p_ms * 1e3,
          "launches": p_launches, "edges_padded": int(ga.receivers.shape[0]),
          "graph_edge_scatter_max_abs_err": edge_err,
          "encoder_scatter_max_abs_err": scatter_err, **p_share,
          "seconds": time.perf_counter() - t0, **card})

    # --- phase 42: learn_c on the card against the CPU -------------------
    t0 = time.perf_counter()
    lc = learn_c_card_vs_cpu(torch, args, G, hgcn)
    emit({"phase": "cli_learn_c_card_vs_cpu", **lc["report"],
          "seconds": time.perf_counter() - t0})

    # --- phase 43: task=nc on the arxiv layout, attention on Cora --------
    t0 = time.perf_counter()
    nc_log = os.path.join(tmp, "nc.jsonl")
    nc_reset()
    nc_out = run_cli(["hgcn", "task=nc", "dataset=ogbn-arxiv",
                      f"data_root={arxiv_dir}", "reorder=true",
                      "hidden_dims=[128, 32]", "agg_dtype=bfloat16",
                      f"steps={CLI_NC_STEPS}", "graph_cache=false",
                      f"log={nc_log}", "eval_every=1"])
    nc_launches = nc_counts()
    nc_losses = read_log(nc_log)
    check_cli_counts(nc_launches, NC_PER_STEP, NC_PER_EVAL, CLI_NC_STEPS,
                     "cli nc")
    if not np.all(np.isfinite(nc_losses)) or nc_out["prep"] != "native":
        raise AssertionError(f"cli nc: {nc_losses}, prep {nc_out['prep']}")
    att_log = os.path.join(tmp, "att.jsonl")
    att_reset()
    nc_reset()
    att_out = run_cli(["hgcn", "dataset=cora", f"data_root={cora_dir}",
                       "use_att=true", "agg_dtype=bfloat16",
                       f"steps={CLI_ATT_STEPS}", "graph_cache=false",
                       f"log={att_log}", "eval_every=1"])
    att_launches = {**att_counts(), **nc_counts()}
    att_losses = read_log(att_log)
    check_cli_counts(att_launches, CLI_ATT_PER_STEP, CLI_ATT_PER_EVAL,
                     CLI_ATT_STEPS, "cli attention on Cora")
    for name in ("cluster_att_fwd", "cluster_att_bwd", "cluster_aggregate"):
        if att_launches[name]:
            raise AssertionError(f"cli attention on Cora: {name} launched "
                                 "on a graph without a cluster split")
    if not np.all(np.isfinite(att_losses)):
        raise AssertionError(f"cli attention on Cora: {att_losses}")
    emit({"phase": "cli_nc_and_att", "nc_result": nc_out,
          "nc_losses": nc_losses, "nc_launches": nc_launches,
          "att_result": att_out, "att_losses": att_losses,
          "att_launches": att_launches,
          "seconds": time.perf_counter() - t0, **card})
    return {"launches_lp": launches, "launches_planned": p_launches,
            "launches_nc": nc_launches, "launches_att": att_launches,
            "ga": ga, "n": n, "e_real": e_real, "n_strag": n_strag,
            "edge_err": edge_err, "scatter_err": scatter_err,
            "mlr": lc["mlr"]}


def learn_c_card_vs_cpu(torch, args, G, hgcn) -> dict:
    """Phase 42: two steps each of LP (pairs and plain) and NC with
    learned curvature on a 20,000-node graph of the arxiv layout's kind,
    on the card and on the CPU from the same parameters and negatives:
    losses and the last layer's learned curvature within rel 2e-2 (the
    bf16 lanes), that curvature moved off its start.  The first layer's
    curvature has a gradient of rounding noise (the next layer's logmap0
    at c undoes its expmap0 at c), which AdamW turns into steps of about
    ±lr either way: it is reported, not held.  Then ``hyp_mlr`` with the
    NC head's learned (device) curvature against its plain version,
    ``dc`` included, launched twice for the same bits."""
    from hyperspace_torch.benchmarks import hgcn_bench as B
    from hyperspace_torch.kernels.mlr import hyp_mlr, hyp_mlr_plain
    from hyperspace_torch.manifolds.maps import lorentz_to_ball

    m = round(B.ARXIV_EDGES * LEARN_C_NODES / B.ARXIV_NODES)
    edges, x, labels, k = G.community_power_law_graph(
        LEARN_C_NODES, m, seed=args.seed)
    edges, x, labels, _ = G.apply_locality_order(edges, x, labels,
                                                 cache=False)
    split = G.split_edges(edges, LEARN_C_NODES, x, seed=0, cache=False)
    tr, va, te = G.node_split_masks(LEARN_C_NODES, seed=0)
    g_nc = G.prepare(edges, LEARN_C_NODES, x, labels=labels, num_classes=k,
                     train_mask=tr, val_mask=va, test_mask=te, cache=False)
    if split.graph.cluster_split is None or g_nc.cluster_split is None:
        raise AssertionError("the 20,000-node graphs have no cluster split")
    base = dict(feat_dim=x.shape[1], hidden_dims=(128, 32), learn_c=True,
                agg_dtype=torch.bfloat16)
    cfg_lp = hgcn.HGCNConfig(decoder_dtype=torch.bfloat16, **base)
    cfg_nc = hgcn.HGCNConfig(num_classes=k, **base)
    n, p = LEARN_C_NODES, len(split.train_pos)
    gen = torch.Generator().manual_seed(args.seed + 42)
    negs = [torch.randint(0, n, (p, 2), generator=gen, dtype=torch.int32)
            for _ in range(LEARN_C_STEPS)]
    runs, heads = {}, {}
    for where in ("cuda", "cpu"):
        dev = torch.device(where)
        ga = G.to_device(split.graph, dev)
        tp = G.index_tensor(split.train_pos, dev)
        pos = hgcn.make_planned_pairs(split.train_pos, n, dev)
        neg_u, neg_plan = hgcn.make_static_negatives(n, p, seed=0, device=dev)
        out = {}
        for kind in ("pairs", "lp"):
            model, opt, state = hgcn.init_lp(cfg_lp, split.graph, seed=0,
                                             device=dev)
            losses = []
            for neg in negs:
                if kind == "lp":
                    state, loss = hgcn.train_step_lp(model, opt, n, state, ga,
                                                     tp, neg=neg.to(dev))
                else:
                    state, loss = hgcn.train_step_lp_pairs(
                        model, opt, n, state, ga, pos, neg_u, neg_plan,
                        neg_v=neg[:, 1].contiguous().to(dev))
                losses.append(float(loss))
            out[kind] = (losses, curvatures(model))
        model, opt, state = hgcn.init_nc(cfg_nc, g_nc, seed=0, device=dev)
        gn = G.to_device(g_nc, dev)
        lab, trm = hgcn.nc_targets(g_nc, dev)
        if where == "cuda":
            heads["first_step"] = learned_head_input(torch, model, gn)
        losses = []
        for _ in range(LEARN_C_STEPS):
            state, loss = hgcn.train_step_nc(model, opt, state, gn, lab, trm)
            losses.append(float(loss))
        out["nc"] = (losses, curvatures(model))
        runs[where] = out
        if where == "cuda":
            heads["after_steps"] = learned_head_input(torch, model, gn)
    report, worst = {}, 0.0
    for kind in ("pairs", "lp", "nc"):
        (lc, cc), (lp_, cp_) = runs["cuda"][kind], runs["cpu"][kind]
        rel_l = max(abs(a - b) / abs(b) for a, b in zip(lc, lp_))
        rel_c = abs(cc[-1] - cp_[-1]) / abs(cp_[-1])
        worst = max(worst, rel_l, rel_c)
        report[kind] = {"losses_cuda": lc, "losses_cpu": lp_,
                        "c_cuda": cc, "c_cpu": cp_, "max_rel_loss_diff":
                        rel_l, "rel_c_diff_last_layer": rel_c}
        if not abs(cc[-1] - 1.0) > 1e-4:
            raise AssertionError(f"learn_c {kind}: the last layer's "
                                 f"curvature did not move: {cc}")
    if not worst <= CARD_CPU_RTOL:
        raise AssertionError(f"learn_c: card and CPU differ by {worst}")
    # hyp_mlr with the learned curvature, a device tensor: at the first
    # step's input at phase 12's tier, after the steps (rows at the
    # ball's rim) no further from float64 than the plain version, as
    # phase 31 holds it; dc through the kernel against the plain version
    err = max(check_nc_head(torch, which, heads[which], "_learned_c")
              for which in ("first_step", "after_steps"))
    xb, pb, a, c = heads["first_step"]
    c = c.clone().requires_grad_()
    got = hyp_mlr(xb, pb, a, c)
    gout = torch.randn(got.shape, generator=torch.Generator(
        device=got.device).manual_seed(args.seed + 43), device=got.device)
    (dc_k,) = torch.autograd.grad(got, c, gout)
    c2 = c.detach().clone().requires_grad_()
    (dc_p,) = torch.autograd.grad(hyp_mlr_plain(xb, pb, a, c2), c2, gout)
    dc_rel = float((dc_k - dc_p).abs() / dc_p.abs().clamp_min(1e-30))
    mlr = {"shape": list(got.shape) + [xb.shape[1]], "max_abs_err": err,
           "dc_kernel": float(dc_k), "dc_plain": float(dc_p),
           "dc_rel_diff": dc_rel, "c": float(c.detach())}
    emit({"phase": "check", "kernel": "hyp_mlr", "input": "learned_c_dc",
          **mlr})
    if not dc_rel <= MLR_RTOL:
        raise AssertionError(f"hyp_mlr with a device c: {mlr}")
    report["learned_c_first_layer_note"] = (
        "gradient of rounding noise; reported, not held")
    return {"report": report, "mlr": mlr}


def learned_head_input(torch, model, ga):
    """(x, p, a, c) as the NC head hands them to ``hyp_mlr`` with learned
    curvature: c the last layer's, a device tensor."""
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.manifolds.maps import lorentz_to_ball

    with torch.no_grad():
        z, m = model.encoder(ga)
        c = m.c.detach()
        return (lorentz_to_ball(z, c).contiguous(),
                PoincareBall(c).expmap0(model.head.p_tangent).contiguous(),
                model.head.a.detach().contiguous(), c)


def curvatures(model) -> list:
    """Every layer's learned curvature, first to last."""
    enc = model.encoder
    return [float(getattr(enc, f"conv{i}").out_curvature().detach())
            for i in range(len(enc.cfg.hidden_dims))]


def cli_kernel_fields(torch, cp: dict, kernels: list) -> None:
    """Add the CLI paths to the kernels line (``*_hgcn_cli*`` keys): the
    launches of B1 and B2 in the LP run, the planned steps and the NC run
    (per step and per evaluation), the attention kernels' on Cora; B1 at
    the arxiv layout's straggler scatter (F 128) and at graph_edge_sqdist's
    [E, 33] bf16 scatter, B2 at its clustered pairs (F 128), each with its
    bound, the library call's time (``index_add_``, ``torch.sparse.mm``)
    and its largest error on these edge sets; and ``hyp_mlr`` at the NC
    head's shape with the curvature as a device tensor and as a number."""
    from hyperspace_torch.kernels.cluster import cluster_aggregate
    from hyperspace_torch.kernels.mlr import hyp_mlr, hyp_mlr_plain
    from hyperspace_torch.kernels.segment import csr_segment_sum

    ga, n, e_real = cp["ga"], cp["n"], cp["e_real"]
    dev = ga.receivers.device
    gen = torch.Generator(device=dev).manual_seed(38)
    r = ga.receivers
    vals = torch.randn(r.shape[0], 33, generator=gen, device=dev)
    vals[e_real:] = 0
    v16 = vals.to(torch.bfloat16)
    r64 = r.long()
    agg, n_strag = ga.cluster, cp["n_strag"]
    s_vals = torch.randn(agg.s_recv.shape[0], 128, generator=gen, device=dev)
    s_vals[n_strag:] = 0
    s16, s64 = s_vals.to(torch.bfloat16), agg.s_recv.long()
    e_c = agg.c_recv.shape[0]
    h16 = torch.randn(n, 128, generator=gen, device=dev).to(torch.bfloat16)
    h32 = h16.float()
    w_csr = torch.sparse_coo_tensor(
        torch.stack([agg.c_recv.long(), agg.c_send.long()]), agg.c_wf,
        (n, n)).coalesce().to_sparse_csr()
    rng = np.random.default_rng(38)
    nn_, kk, dd = MLR_NC_SHAPE
    xb = torch.as_tensor(rng.standard_normal((nn_, dd)), dtype=torch.float32,
                         device=dev)
    xb *= 0.9 / xb.norm(dim=1, keepdim=True).clamp_min(1.0)
    p = torch.as_tensor(rng.standard_normal((kk, dd)) * 0.05,
                        dtype=torch.float32, device=dev)
    a = torch.as_tensor(rng.standard_normal((kk, dd)) * 0.1,
                        dtype=torch.float32, device=dev)
    c_dev = torch.tensor(C, device=dev)
    for e in kernels:
        name = e["name"]
        for run, per_step, per_eval, key in (
                ("launches_lp", CLI_LP_PER_STEP, CLI_LP_PER_EVAL, "hgcn_cli"),
                ("launches_planned", PLANNED_PER_STEP, {}, "planned"),
                ("launches_nc", NC_PER_STEP, NC_PER_EVAL, "hgcn_cli_nc"),
                ("launches_att", CLI_ATT_PER_STEP, CLI_ATT_PER_EVAL,
                 "hgcn_cli_att_cora")):
            if name in cp[run]:
                e.update({f"launches_{key}": cp[run][name],
                          f"launches_per_step_{key}": per_step.get(name, 0),
                          f"launches_per_eval_{key}": per_eval.get(name, 0)})
        if name == "cluster_aggregate":
            e.update({
                "shape_hgcn_cli": [n, 128, e_c],
                "ms_hgcn_cli": device_ms(torch, lambda: cluster_aggregate(
                    h16, agg.c_wf, agg.c_recv, agg.c_send, None, n,
                    rows=agg.c_rows)),
                "bound_ms_hgcn_cli": bound_ms(*cluster_cost(e_c, 128, n, 2))[0],
                "library_ms_hgcn_cli": device_ms(
                    torch, lambda: torch.sparse.mm(w_csr, h32)),
                "max_abs_err_hgcn_cli": cp["scatter_err"]["cluster_aggregate"]})
        if name == "csr_segment_sum":
            e.update({
                "shape_hgcn_cli": [int(agg.s_recv.shape[0]), 128, n],
                "ms_hgcn_cli": device_ms(
                    torch, lambda: csr_segment_sum(s16, agg.s_recv, None, n)),
                "bound_ms_hgcn_cli": bound_ms(*segment_cost(n_strag, 128, n,
                                                       2))[0],
                "library_ms_hgcn_cli": device_ms(
                    torch, lambda: torch.zeros((n, 128), device=dev
                                               ).index_add_(0, s64, s_vals)),
                "max_abs_err_hgcn_cli": cp["scatter_err"]["csr_segment_sum"],
                "shape_graph_edges_hgcn_cli": [int(r.shape[0]), 33, n],
                "ms_graph_edges_hgcn_cli": device_ms(
                    torch, lambda: csr_segment_sum(v16, r, None, n)),
                "bound_ms_graph_edges_hgcn_cli": bound_ms(*segment_cost(
                    e_real, 33, n, 2))[0],
                "library_ms_graph_edges_hgcn_cli": device_ms(
                    torch, lambda: torch.zeros((n, 33), device=dev
                                               ).index_add_(0, r64, vals)),
                "max_abs_err_graph_edges_hgcn_cli": cp["edge_err"]})
        if name == "hyp_mlr":
            e.update({
                "ms_nc_device_c": device_ms(
                    torch, lambda: hyp_mlr(xb, p, a, c_dev)),
                "ms_nc_number_c": device_ms(
                    torch, lambda: hyp_mlr(xb, p, a, C)),
                "plain_ms_nc_device_c": device_ms(
                    torch, lambda: hyp_mlr_plain(xb, p, a, c_dev), reps=5),
                "bound_ms_nc_device_c": bound_ms(*mlr_cost(
                    nn_, kk, dd))[0],
                "shape_nc_device_c": [nn_, kk, dd],
                "max_abs_err_learned_c": cp["mlr"]["max_abs_err"],
                "dc_rel_diff_learned_c": cp["mlr"]["dc_rel_diff"]})


# --- phases 44-49: product embeddings and the train runtime ----------------

PRODUCT_TREE = (5, 9)              # 66,430 nodes, 323,847 closure pairs
PRODUCT_CHUNK = 32                 # the graphed chunk (workloads_bench)
PRODUCT_CARD_CPU_RTOL = 1e-4       # all float32
PRODUCT_CLI_YAML = os.path.join("configs", "product_multihost.yaml")
PRODUCT_CLI_BIG_STEPS = 1024       # 32 graphed chunks on the big closure
RESUME_STEPS = 16                  # N: straight twice, N/2 + resume to N
RESUME_CHUNK = 8
RESUME_RUNS = {
    "poincare": ["poincare", f"scan_chunk={RESUME_CHUNK}"],
    "hvae": ["hvae", "--yaml", HVAE_CLI_YAML, f"scan_chunk={RESUME_CHUNK}"],
    "product": ["product", f"scan_chunk={RESUME_CHUNK}"],
    "hybonet": ["hybonet", "--yaml", HB_CLI_YAML],
    "hgcn": ["hgcn", "hidden_dims=[32, 16]", "graph_cache=false"],
}
ACCUM_STEPS = 8
ACCUM_CARD_CPU_RTOL = 1e-4


def tree_gap(torch, a, b, path="") -> float:
    """The largest absolute difference between two checkpoint trees'
    float tensors; integer tensors and numbers (step counts, generator
    states) must be equal."""
    if isinstance(a, torch.Tensor):
        if a.is_floating_point():
            return float((a.double() - b.double()).abs().max()) \
                if a.numel() else 0.0
        if not torch.equal(a, b):
            raise AssertionError(f"{path}: integer state differs")
        return 0.0
    if isinstance(a, dict):
        return max([tree_gap(torch, a[k], b[k], f"{path}.{k}") for k in a]
                   or [0.0])
    if isinstance(a, list):
        return max([tree_gap(torch, x, y, f"{path}[{i}]")
                    for i, (x, y) in enumerate(zip(a, b))] or [0.0])
    if a != b:
        raise AssertionError(f"{path}: {a} != {b}")
    return 0.0


def product_bench(torch, card: dict) -> dict:
    """Phase 44: the ``workloads_bench`` product leg at 66,430 nodes,
    the graphed chunk's busy and idle share, and the chunk against the
    same steps run eagerly from the same state and generator."""
    from hyperspace_torch.benchmarks import workloads_bench as W
    from hyperspace_torch.models import product_embed as pme
    from hyperspace_torch.train import loop

    t0 = time.perf_counter()
    leg = W.setup_product_leg(device="cuda", seed=0, tree=PRODUCT_TREE)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    res = W.run_product_leg(leg, steps=20, repeats=3, chunk=PRODUCT_CHUNK)
    peak = torch.cuda.max_memory_allocated()
    losses = res.pop("losses")
    share = device_share(torch, leg.step, res["step_ms"], reps=5, top_n=5)
    cfg, opt, pairs = leg.cfg, leg.opt, leg.pairs
    chunk = loop.make_chunked_stepper(
        lambda st, p: pme.train_step(cfg, opt, st, p), PRODUCT_CHUNK)
    state = {"st": leg.state}

    def run_chunk():
        state["st"], _ = chunk(state["st"], pairs)

    run_chunk()                                     # captures
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(3):
        run_chunk()
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t1) / 3 * 1e3
    chunk_share = device_share(torch, run_chunk, chunk_ms, reps=3, top_n=5)
    # the chunk against its steps run eagerly, from one state
    eager, graphed = pe_clone(torch, state["st"]), pe_clone(torch,
                                                           state["st"])
    eager_losses = []
    for _ in range(PRODUCT_CHUNK):
        eager, loss = pme.train_step(cfg, opt, eager, pairs)
        eager_losses.append(loss)
    graphed, g_losses = chunk(graphed, pairs)
    e_losses = torch.stack(eager_losses)
    te, tg = eager.params.table, graphed.params.table
    agree = {
        "table_bitwise": bool(torch.equal(te, tg)),
        "c_raw_bitwise": bool(torch.equal(eager.params.c_raw,
                                          graphed.params.c_raw)),
        "losses_bitwise": bool(torch.equal(e_losses, g_losses)),
        "table_rel": float(torch.linalg.vector_norm(te - tg)
                           / torch.linalg.vector_norm(te)),
        "c_raw_rel": float(((eager.params.c_raw - graphed.params.c_raw).abs()
                            / eager.params.c_raw.abs()).max()),
        "loss_rel": float(((e_losses - g_losses).abs()
                           / e_losses.abs()).max())}
    out = {**res, **share, "chunk_ms": chunk_ms,
           "chunk_device_busy_ms": chunk_share["device_busy_ms"],
           "chunk_device_idle_share": chunk_share["device_idle_share"],
           "chunk_top_device_ms": chunk_share["top_device_ms"],
           "graphed_vs_eager": agree, "setup_s": setup_s,
           "first_loss": losses[0], "last_loss": losses[-1],
           "peak_device_memory_bytes": peak}
    emit({"phase": "product_bench", **out,
          "seconds": time.perf_counter() - t0, **card})
    if not np.all(np.isfinite(losses)) or not all(
            np.isfinite(v) for k, v in agree.items() if k.endswith("rel")):
        raise AssertionError(f"product bench: non-finite values {agree}")
    if agree["table_rel"] > PRODUCT_CARD_CPU_RTOL:
        raise AssertionError(f"product: the graphed chunk is beyond rel "
                             f"{PRODUCT_CARD_CPU_RTOL} of its eager steps: "
                             f"{agree}")
    return out


def product_card_vs_cpu(torch, args) -> dict:
    """Phase 45: three steps on given ids (collisions included) from one
    state at 66,430 nodes, batch 1,024, on the card and on the CPU."""
    from hyperspace_torch.data.wordnet import synthetic_tree
    from hyperspace_torch.models import product_embed as pme

    t0 = time.perf_counter()
    ds = synthetic_tree(*PRODUCT_TREE)
    cfg = pme.ProductEmbedConfig(num_nodes=ds.num_nodes, batch_size=1024,
                                 burnin_steps=1)
    rng = np.random.default_rng(args.seed + 44)
    ids = []
    for _ in range(3):
        rows = rng.integers(0, len(ds.pairs), cfg.batch_size)
        u, v = ds.pairs[rows, 0], ds.pairs[rows, 1]
        neg = rng.integers(0, cfg.num_nodes, (cfg.batch_size,
                                              cfg.neg_samples))
        neg[:8, 0] = u[:8]                          # collisions with u
        ids.append((u, v, neg))
    runs = {}
    for where in ("cuda", "cpu"):
        st, opt = pme.init_state(cfg, args.seed, device="cpu")
        st = pme.TrainState(
            pme.Params(*(t.to(where) for t in st.params)),
            type(st.curv_opt_state)(*(t.to(where)
                                      for t in st.curv_opt_state)),
            torch.Generator(device=where), st.step.to(where))
        losses = []
        for u, v, neg in ids:
            st, loss = pme.step_on_batch(cfg, opt, st, *(
                torch.as_tensor(a, device=where) for a in (u, v, neg)))
            losses.append(float(loss))
        runs[where] = (st.params.table.cpu(), st.params.c_raw.cpu(), losses)
    (tg, cg, lg), (tc, cc, lc) = runs["cuda"], runs["cpu"]
    rep = {"table_rel": float(torch.linalg.vector_norm(tg - tc)
                              / torch.linalg.vector_norm(tc)),
           "c_raw_rel": float(((cg - cc).abs() / cc.abs()).max()),
           "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(lg, lc)),
           "losses_cuda": lg, "losses_cpu": lc,
           "c_raw_cuda": cg.tolist(), "c_raw_cpu": cc.tolist()}
    emit({"phase": "product_card_vs_cpu", **rep,
          "seconds": time.perf_counter() - t0})
    if not max(rep["table_rel"], rep["c_raw_rel"],
               rep["loss_rel"]) <= PRODUCT_CARD_CPU_RTOL:
        raise AssertionError(f"product: card and CPU differ: {rep}")
    return rep


def product_cli(torch, tmp: str, card: dict) -> dict:
    """Phase 46: ``cli.train product`` at its config, then graphed chunks
    on a 66,430-node closure TSV written here."""
    from hyperspace_torch.data.wordnet import synthetic_tree

    out = {}
    for name, argv in (
            ("config", ["product", "--yaml", PRODUCT_CLI_YAML,
                        "eval_every=100"]),
            ("big", ["product", "scan_chunk=32", "batch_size=1024",
                     f"steps={PRODUCT_CLI_BIG_STEPS}", "eval_every=256"])):
        t0 = time.perf_counter()
        if name == "big":
            ds = synthetic_tree(*PRODUCT_TREE)
            tsv = os.path.join(tmp, "closure.tsv")
            with open(tsv, "w") as f:
                f.writelines(f"n{u}\tn{v}\n" for u, v in ds.pairs)
            argv = argv + [f"data_root={tsv}"]
        log = os.path.join(tmp, f"product_{name}.jsonl")
        res = run_cli(argv + [f"log={log}"])
        losses = read_log(log)
        out[name] = {**res, "logged_losses": losses,
                     "seconds": time.perf_counter() - t0}
        emit({"phase": "product_cli", "run": name, "argv": argv,
              **out[name], **card})
        check_losses(losses, f"product CLI {name}")
        if not max(abs(c - 1.0) for c in res["curvatures"]) > 1e-4:
            raise AssertionError(f"product CLI {name}: the curvatures did "
                                 f"not move: {res['curvatures']}")
        if not 0.0 < res["map"] <= 1.0:
            raise AssertionError(f"product CLI {name}: {res}")
    return out


def resume_runs(torch, tmp: str, card: dict) -> dict:
    """Phase 47: each CLI workload N steps straight twice, and N/2 with
    ``ckpt_dir`` then resumed to N; the resumed run's final checkpoint
    must be as close to the straight one's as the two straight runs are
    to each other (bitwise where they are).  Saves are timed."""
    from hyperspace_torch.train import checkpoint as ck

    saves = []
    real_save = ck.CheckpointManager.save

    def timed_save(self, step, state, *, force=False):
        t = time.perf_counter()
        started = real_save(self, step, state, force=force)
        if started:
            saves.append(time.perf_counter() - t)
        return started

    ck.CheckpointManager.save = timed_save
    out = {}
    try:
        for name, argv in RESUME_RUNS.items():
            t0 = time.perf_counter()
            saves.clear()
            base = argv + ["ckpt_every=4", "eval_every=1"]

            def run(tag, steps, *extra):
                d = os.path.join(tmp, f"resume_{name}_{tag}")
                res = run_cli(base + [f"steps={steps}", f"ckpt_dir={d}",
                                      *extra])
                res.pop("seconds", None)
                return res, d

            flags = cudnn_flags(torch, True) if name == "hvae" else \
                contextlib.nullcontext()
            with flags:
                (r1, d1), (r2, d2) = (run(t, RESUME_STEPS)
                                      for t in ("a1", "a2"))
                run("b", RESUME_STEPS // 2)
                rb, db = run("b", RESUME_STEPS, "resume=true")
            t1, s1 = ck.restore_params_only(d1)
            t2, _ = ck.restore_params_only(d2)
            tb, sb = ck.restore_params_only(db)
            spread, gap = tree_gap(torch, t1, t2), tree_gap(torch, t1, tb)
            out[name] = {
                "straight_gap": spread, "resumed_gap": gap,
                "bitwise": gap == 0.0, "results_equal": rb == r1,
                "result": rb, "step": sb,
                "save_s": sorted(saves), "ckpt_bytes": ck.dir_bytes(
                    os.path.join(db, str(sb))),
                "cudnn_deterministic": name == "hvae",
                "seconds": time.perf_counter() - t0}
            emit({"phase": "resume", "workload": name, **out[name], **card})
            if sb != s1 or not gap <= spread:
                raise AssertionError(
                    f"resume {name}: the resumed run is {gap} from the "
                    f"straight one, two straight runs {spread} apart "
                    f"(steps {s1}, {sb})")
    finally:
        ck.CheckpointManager.save = real_save
    return out


def accum_card_vs_cpu(torch, args) -> dict:
    """Phase 48, second half: four microsteps of accum=2 on given batches
    from one state, HyboNet (AdamW) and the HVAE (Adam), on the card and
    on the CPU."""
    from hyperspace_torch.data.text import synthetic_text
    from hyperspace_torch.models import hvae, hybonet
    from hyperspace_torch.optim.accum import with_grad_accumulation

    ds = synthetic_text(num_samples=64, vocab_size=512, num_classes=4,
                        max_len=32, seed=args.seed)
    hcfg = hybonet.HyboNetConfig(dim=64, num_heads=4, num_layers=2,
                                 batch_size=16)
    vcfg = hvae_cfg("poincare")
    rng = np.random.default_rng(args.seed + 48)
    images = rng.uniform(0, 1, (4, 16, 28, 28)).astype(np.float32)
    eps = rng.standard_normal((4, 16, vcfg.latent_dim)).astype(np.float32)
    runs = {}
    for where in ("cuda", "cpu"):
        model, opt, st = hybonet.init_model(hcfg, seed=args.seed,
                                            device=where)
        opt, _ = with_grad_accumulation(opt, None, 2)
        hl = []
        for i in range(4):
            t, m, y = (torch.as_tensor(a[16 * i:16 * i + 16], device=where)
                       for a in (ds.tokens, ds.mask, ds.labels))
            st, loss = hybonet.train_step(model, opt, st, t, m, y)
            hl.append(float(loss))
        hp = torch.cat([p.detach().reshape(-1).cpu()
                        for p in model.parameters()])
        vmodel, vopt, vst = hvae.init_model(vcfg, args.seed, where)
        vopt, vstate = with_grad_accumulation(vopt, vst.params, 2)
        vst = vst._replace(opt_state=vstate)
        vl = []
        with cudnn_flags(torch, False):
            for i in range(4):
                vst, loss, _r, _k = hvae.train_step(
                    vmodel, vopt, vst, torch.as_tensor(images[i],
                                                       device=where),
                    eps=torch.as_tensor(eps[i], device=where))
                vl.append(float(loss))
        vp = torch.cat([t.reshape(-1).cpu() for t in
                        torch.utils._pytree.tree_leaves(vst.params)])
        runs[where] = (hl, hp, opt.inner.count, vl, vp,
                       int(vst.opt_state.inner_opt_state.count))
    g, c = runs["cuda"], runs["cpu"]
    rep = {"hybonet_loss_rel": max(abs(a - b) / abs(b)
                                   for a, b in zip(g[0], c[0])),
           "hybonet_param_rel": float(torch.linalg.vector_norm(g[1] - c[1])
                                      / torch.linalg.vector_norm(c[1])),
           "hvae_loss_rel": max(abs(a - b) / abs(b)
                                for a, b in zip(g[3], c[3])),
           "hvae_param_rel": float(torch.linalg.vector_norm(g[4] - c[4])
                                   / torch.linalg.vector_norm(c[4])),
           "inner_counts": [g[2], g[5], c[2], c[5]]}
    if rep["inner_counts"] != [2, 2, 2, 2] or not max(
            v for k, v in rep.items() if k.endswith("rel")) \
            <= ACCUM_CARD_CPU_RTOL:
        raise AssertionError(f"accum: card and CPU differ: {rep}")
    return rep


def accum_runs(torch, args, tmp: str, card: dict) -> dict:
    """Phase 48: ``accum=2`` through the CLI for HyboNet and the HVAE
    (graphed chunks), the inner optimizer's count read back from the
    final checkpoint; then the card against the CPU."""
    from hyperspace_torch.train.checkpoint import restore_params_only

    t0 = time.perf_counter()
    out = {}
    for name, argv, count in (
            ("hybonet", ["hybonet", "--yaml", HB_CLI_YAML],
             ("opt", "inner", "count")),
            ("hvae", ["hvae", "--yaml", HVAE_CLI_YAML, "scan_chunk=4"],
             ("opt_state", "inner_opt_state", "count"))):
        d = os.path.join(tmp, f"accum_{name}")
        log = os.path.join(tmp, f"accum_{name}.jsonl")
        res = run_cli(argv + ["accum=2", f"steps={ACCUM_STEPS}",
                              f"ckpt_dir={d}", f"log={log}",
                              "eval_every=1"])
        tree, _ = restore_params_only(d)
        node = tree
        for key in count:
            node = node[key]
        losses = read_log(log)
        out[name] = {"result": res, "losses": losses,
                     "inner_count": int(node)}
        if int(node) != ACCUM_STEPS // 2 or not np.all(np.isfinite(losses)):
            raise AssertionError(f"accum {name}: {out[name]}")
    out["card_vs_cpu"] = accum_card_vs_cpu(torch, args)
    emit({"phase": "accum", **out, "seconds": time.perf_counter() - t0,
          **card})
    return out


def health_runs(torch, tmp: str, card: dict) -> dict:
    """Phase 49: ``health_every=1`` on ``product`` and ``poincare``: a
    healthy run logs ``health/*`` records, every one ok; a table pushed
    to the rim (a learning rate of 1,000 without burn-in) flags, and
    with ``health_abort=1`` the run raises."""
    t0 = time.perf_counter()
    out = {}
    for name, argv in (
            ("product", ["product", "scan_chunk=8", "steps=200"]),
            ("poincare", ["poincare", "scan_chunk=8", "steps=200"])):
        rim = [("lr_table" if name == "product" else "lr") + "=1000",
               "burnin_steps=0"]
        for mode, extra in (("healthy", []), ("rim", rim)):
            log = os.path.join(tmp, f"health_{name}_{mode}.jsonl")
            run_cli(argv + ["health_every=1", f"log={log}", *extra])
            with open(log) as f:
                recs = [json.loads(s) for s in f]
            health = [r for r in recs if "health/ok" in r]
            ok = [r["health/ok"] for r in health]
            out[f"{name}_{mode}"] = {
                "records": len(health), "ok": sum(ok),
                "margin_min": min(r["health/boundary_margin_min"]
                                  for r in health)}
            if len(health) != 25 or (mode == "healthy") != all(ok) or (
                    mode == "rim" and any(ok[-5:])):
                raise AssertionError(f"health {name} {mode}: "
                                     f"{out[f'{name}_{mode}']}")
        try:
            run_cli(argv + ["health_every=1", "health_abort=1", *rim])
        except FloatingPointError as e:
            out[f"{name}_abort"] = str(e)
        else:
            raise AssertionError(f"health {name}: health_abort=1 did not "
                                 "raise on the rim")
    emit({"phase": "health", **out, "seconds": time.perf_counter() - t0,
          **card})
    return out


def runtime_path(torch, args, card: dict) -> dict:
    """Phases 44-49 (after every profiled time of the earlier phases)."""
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=work)
    try:
        out = {"bench": product_bench(torch, card),
               "card_vs_cpu": product_card_vs_cpu(torch, args),
               "cli": product_cli(torch, tmp, card),
               "resume": resume_runs(torch, tmp, card),
               "accum": accum_runs(torch, args, tmp, card),
               "health": health_runs(torch, tmp, card)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # every host prep here is a build: no "auto" prep-cache entry is read
    # or written (phase 39 times a miss and a hit in a cache of its own)
    os.environ["HYPERSPACE_GRAPH_CACHE"] = "0"
    from hyperspace_torch.cli import serve as cli
    from hyperspace_torch.kernels import _support
    from hyperspace_torch.kernels.distmat import pdist, pdist_plain
    from hyperspace_torch.kernels.scan_topk import scan_topk, scan_topk_plain
    from hyperspace_torch.manifolds import Lorentz, PoincareBall
    from hyperspace_torch.manifolds.maps import ball_to_lorentz
    from hyperspace_torch.serve import (QueryEngine, RequestBatcher,
                                        export_artifact, load_artifact)
    from hyperspace_torch.serve.engine import auto_chunk_rows

    # --- phase 1: the card -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    card = {"card": smi}
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    dev = torch.device("cuda")
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # --- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    _support.build_all(["pdist", "scan_topk", "segment", "cluster",
                        "attention", "mlr", "pointwise", "hyplinear"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0, **card})

    # --- data from the seed ------------------------------------------------
    rng = np.random.default_rng(args.seed)
    ball = PoincareBall(C)

    def ball_rows(n):
        v = torch.as_tensor(rng.standard_normal((n, DIM)) * 0.5,
                            dtype=torch.float32, device=dev)
        return ball.expmap0(v).contiguous()

    table_b = ball_rows(ROWS)
    table_l = ball_to_lorentz(table_b, C).contiguous()
    fresh_b = ball_rows(BATCH)            # queries that are not table rows
    fresh_l = ball_to_lorentz(fresh_b, C).contiguous()
    chunk = auto_chunk_rows(ROWS)         # the engine's two-stage chunk
    padded = -(-ROWS // chunk) * chunk
    kinds = (("poincare", table_b, fresh_b), ("lorentz", table_l, fresh_l))

    # --- phase 3: kernels vs their plain versions --------------------------
    # the served buckets: 8 and 1024 query rows
    err = {"pdist": 0.0, "scan_topk": 0.0}
    for man, table, fresh in kinds:
        for b in (8, BATCH):
            q = fresh[:b]
            # a served chunk, the table, the IVF export's 287 centroids
            for rows in (table[:chunk], table, table[:287]):
                got = pdist(q, rows, C, manifold=man)
                again = pdist(q, rows, C, manifold=man)
                torch.cuda.synchronize()
                want = pdist_plain(q, rows, C, manifold=man)
                diff = (got - want).abs()
                worst = float(diff.max())
                err["pdist"] = max(err["pdist"], worst)
                over = int((diff > ATOL + RTOL * want.abs()).sum())
                same = bool(torch.equal(got, again))
                emit({"phase": "check", "kernel": "pdist", "manifold": man,
                      "shape": [b, rows.shape[0], rows.shape[1]],
                      "max_abs_err": worst, "over_tolerance": over,
                      "repeat_equal": same})
                if over or not same:
                    raise AssertionError(
                        f"pdist {man}: {over} entries beyond "
                        f"rtol={RTOL} atol={ATOL}, repeat equal {same}")
        slab = torch.zeros((padded, table.shape[1]), device=dev)
        slab[:ROWS] = table
        for b, k, ex, (col0, n) in itertools.product(
                (8, BATCH), (1, 10, 256), (False, True),
                ((0, ROWS), (5000, 5000 + ROWS - 115))):
            q = fresh[:b]
            qi = torch.as_tensor(rng.integers(col0, col0 + ROWS, b),
                                 dtype=torch.int32, device=dev)
            d1, i1 = scan_topk(slab, q, qi, col0, spec=(man, C), k=k, n=n,
                               exclude_self=ex)
            torch.cuda.synchronize()
            d2, i2 = scan_topk_plain(slab, q, qi, col0, kind=man, c=C, k=k,
                                     n=n, exclude_self=ex)
            fin = torch.isfinite(d2)
            worst = float((d1 - d2).abs()[fin].max())
            err["scan_topk"] = max(err["scan_topk"], worst)
            bad = _support.topk_disagreements(
                i1.cpu().numpy(), d1.cpu().numpy(), i2.cpu().numpy(),
                d2.cpu().numpy(), rtol=RTOL, atol=ATOL)
            emit({"phase": "check", "kernel": "scan_topk", "manifold": man,
                  "batch": b, "k": k, "exclude_self": ex, "col0": col0,
                  "n": n, "max_abs_err": worst, "rows_disagreeing": bad})
            if bad:
                raise AssertionError(
                    f"scan_topk {man} b={b} k={k} exclude_self={ex} "
                    f"col0={col0}: {bad} rows disagree")

    # --- phase 4: the main path --------------------------------------------
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=work)
    try:
        arts = {}
        for man, table, _q in kinds:
            path = os.path.join(tmp, man)
            export_artifact(path, table.cpu().numpy(), (man, C))
            arts[man] = load_artifact(path)
        ids8 = rng.choice(ROWS, 8, replace=False).tolist()
        ids1024 = rng.choice(ROWS, 1024, replace=False).tolist()
        u = rng.integers(0, ROWS, 8).tolist()
        v = rng.integers(0, ROWS, 8).tolist()
        lines = "\n".join(json.dumps(r) for r in (
            {"op": "topk", "ids": ids8, "k": K},
            {"op": "topk", "ids": ids1024, "k": K},
            {"op": "score", "u": u, "v": v, "prob": True},
            {"op": "stats"})) + "\n"
        pdist.launches = scan_topk.launches = 0
        answers = {}
        for man, _t, _q in kinds:
            for mode in ("two_stage", "fused"):
                out = io.StringIO()
                closing = cli.run_serve(
                    cli.ServeConfig(artifact=os.path.join(tmp, man),
                                    scan_mode=mode),
                    stdin=io.StringIO(lines), stdout=out)
                resp = [json.loads(s) for s in out.getvalue().splitlines()]
                if len(resp) != 4 or any("error" in r for r in resp):
                    raise AssertionError(f"{man}/{mode}: {resp}")
                answers[man, mode] = resp
                emit({"phase": "serve", "manifold": man, "scan_mode": mode,
                      "served": closing["served"],
                      "slots": closing["slots"],
                      "padded_waste": closing["padded_waste"],
                      "cache_hit": closing["cache_hit"]})
        launches = {"pdist": pdist.launches, "scan_topk": scan_topk.launches}
        emit({"phase": "launches", **launches})
        for name, count in launches.items():
            if count < 1:
                raise AssertionError(f"{name} never launched on the path")

        # the answers: shape, order, two_stage vs fused, float64 truth
        truth_man = {"poincare": PoincareBall(C), "lorentz": Lorentz(C)}
        for man, _t, _q in kinds:
            tab64 = torch.as_tensor(arts[man].table, dtype=torch.float64)
            ts, fu = answers[man, "two_stage"], answers[man, "fused"]
            for j, ids in ((0, ids8), (1, ids1024)):
                nb = np.asarray(ts[j]["neighbors"])
                ds = np.asarray(ts[j]["dists"], np.float64)
                if nb.shape != (len(ids), K) or not np.all(np.isfinite(ds)):
                    raise AssertionError(f"{man}: bad top-k shape/values")
                if np.any(np.diff(ds, axis=1) < 0):
                    raise AssertionError(f"{man}: dists not ascending")
                bad = _support.topk_disagreements(
                    nb, ds, np.asarray(fu[j]["neighbors"]),
                    np.asarray(fu[j]["dists"], np.float64),
                    rtol=RTOL, atol=ATOL)
                if bad:
                    raise AssertionError(
                        f"{man}: two_stage and fused disagree on {bad} rows")
            sample = ids1024[:16]
            d64 = truth_man[man].dist(tab64[sample][:, None, :],
                                      tab64[None, :, :])
            d64[torch.arange(16), torch.as_tensor(sample)] = float("inf")
            ref_d, ref_i = torch.sort(d64, dim=1, stable=True)
            bad = _support.topk_disagreements(
                np.asarray(ts[1]["neighbors"][:16]),
                np.asarray(ts[1]["dists"][:16], np.float64),
                ref_i[:, :K].numpy(), ref_d[:, :K].numpy(),
                rtol=TRUTH_RTOL, atol=TRUTH_ATOL)
            s64 = truth_man[man].dist(tab64[u], tab64[v])
            p64 = 1.0 / (torch.exp(torch.square(s64) - 2.0) + 1.0)
            serr = float(np.max(np.abs(np.asarray(ts[2]["scores"])
                                       - p64.numpy())))
            emit({"phase": "truth", "manifold": man,
                  "rows_disagreeing_with_f64": bad,
                  "score_max_abs_err_vs_f64": serr})
            if bad or serr > TRUTH_ATOL:
                raise AssertionError(f"{man}: served answers disagree with "
                                     "the float64 brute force")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # --- phases 16-19: the IVF and PQ serving lanes -------------------------
    ip = ivf_pq_path(torch, args, card, table_l, fresh_b)
    err["scan_topk"] = max(err["scan_topk"], ip["err"]["scan_topk"])

    # --- phases 5-8: the training path ----------------------------------
    tr = train_path(torch, args, card)

    # --- phases 9-11: the HGCN attention arm --------------------------------
    at = att_path(torch, args, card, tr)

    # --- phases 12-15: the HyboNet path -----------------------------------
    hb = hybonet_path(torch, args, card)

    # --- phases 20-22: the Poincaré ops and the gyro-linear layer ----------
    gp = gyro_path(torch, args, card)

    # --- phases 30-32: HGCN node classification at arxiv scale -------------
    nc = nc_path(torch, args, card, tr)

    # --- phases 33-35: the hyperbolic VAE (no CUDA graph yet) --------------
    hv = hvae_path(torch, args, card)

    # --- phase 23: times ---------------------------------------------------
    # kernel and plain times are device times from the profiler at the
    # main path's shapes; call_ms adds the host's launch path (CUDA
    # events around back-to-back calls)
    table, q = table_b, fresh_b
    slab = torch.zeros((padded, DIM), device=dev)
    slab[:ROWS] = table
    qi = torch.as_tensor(ids1024, dtype=torch.int32, device=dev)
    rows = table[:chunk]

    def run_pdist(b, y=rows):
        return lambda: pdist(q[:b], y, C, manifold="poincare")

    def run_scan(b):
        return lambda: scan_topk(slab, q[:b], qi[:b], 0, spec=("poincare", C),
                                 k=K, n=ROWS, exclude_self=True)

    pb, pby = bound_ms(*pdist_cost(BATCH, chunk, DIM))
    sb, sby = bound_ms(*scan_cost(BATCH, padded, ROWS, DIM, K))
    kernels = [
        {"name": "pdist", "route": "cuda",
         "source": "hyperspace_torch/kernels/csrc/pdist.cu",
         "entry": "hs_pdist",
         "replaces": "hyperspace_tpu/kernels/distmat.py:119",
         "launches": launches["pdist"], "max_abs_err": err["pdist"],
         "shape": [BATCH, chunk, DIM],
         "ms": device_ms(torch, run_pdist(BATCH)),
         "plain_ms": device_ms(torch, lambda: pdist_plain(
             q, rows, C, manifold="poincare")),
         "bound_ms": pb, "bound_by": pby, "library_ms": None,
         "call_ms": timed_ms(torch, run_pdist(BATCH)),
         "ms_bucket8": device_ms(torch, run_pdist(8)),
         "bound_ms_bucket8": bound_ms(*pdist_cost(8, chunk, DIM))[0],
         "full_table_ms": device_ms(torch, run_pdist(BATCH, table)),
         "bound_ms_full_table": bound_ms(*pdist_cost(BATCH, ROWS, DIM))[0],
         **card},
        {"name": "scan_topk", "route": "cuda",
         "source": "hyperspace_torch/kernels/csrc/scan_topk.cu",
         "entry": "hs_scan_topk",
         "replaces": "hyperspace_tpu/kernels/scan_topk.py:677",
         "launches": launches["scan_topk"],
         "max_abs_err": err["scan_topk"],
         "shape": [BATCH, padded, DIM, K],
         **scan_parts(torch, run_scan(BATCH)),
         "plain_ms": device_ms(torch, lambda: scan_topk_plain(
             slab, q, qi, 0, kind="poincare", c=C, k=K, n=ROWS,
             exclude_self=True), reps=3),
         "bound_ms": sb, "bound_by": sby, "library_ms": None,
         "call_ms": timed_ms(torch, run_scan(BATCH)),
         **{f"{key}_bucket8": v
            for key, v in scan_parts(torch, run_scan(8)).items()}, **card},
    ] + ivf_pq_kernel_entries(torch, ip, card) + train_kernel_entries(
        torch, tr, card) + att_kernel_entries(
        torch, at, card) + hybonet_kernel_entries(
        torch, hb, card) + gyro_kernel_entries(torch, gp, card)
    nc_kernel_fields(torch, nc, kernels)
    for entry in kernels:      # the mean path's kernels on the attention arm
        if entry["name"] in ("csr_segment_sum", "cluster_aggregate"):
            entry["launches_attention"] = at["launches"][entry["name"]]
        if entry["name"] == "csr_segment_sum":
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       at["err"]["csr_segment_sum"])
            entry.update(att_segsum_times(torch, at))
    # requests through the batcher at bucket 1024 with its default cache,
    # each batch of distinct ids never seen before (all cold, so every id
    # is computed), and the engine call alone on the same ids, the two
    # taken in turns; host clock, each ending in the copy of the answer
    # to the host
    cold = rng.permutation(ROWS)[:40 * BATCH].reshape(40, BATCH)
    throughput = {}
    for mode in ("two_stage", "fused"):
        eng = QueryEngine(table.cpu().numpy(), ("poincare", C),
                          scan_mode=mode)
        throughput[mode] = batch_throughput(torch, eng, RequestBatcher(eng),
                                            cold)
    emit({"phase": "throughput", "bucket": BATCH, "k": K,
          "manifold": "poincare", "rows": ROWS, **throughput, **card})
    # the launch floor: an empty kernel launched as the kernels are
    # (benchmarks/launch_floor.py), the least any launch here costs
    from hyperspace_torch.benchmarks.launch_floor import floor_ms
    floor = floor_ms()

    # --- phases 24-29: Poincaré embeddings, RSGD and RAdam ----------------
    # last: its CUDA graphs and epoch-long profiler windows come after
    # every other device time is taken (its own kernel times are taken
    # before its graphs)
    pp = poincare_path(torch, args, card)
    pe_kernel_fields(pp, kernels)

    # --- phases 36-37: the HVAE's graphed chunks and its CLI --------------
    hvae_graphs(torch, hv, card)

    # --- phases 38-43: HGCN through the CLI, from graphs on disk ----------
    cp = cli_path(torch, args, card)
    cli_kernel_fields(torch, cp, kernels)

    # --- phases 44-49: product embeddings and the train runtime ----------
    runtime_path(torch, args, card)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": kernels, "floor_ms": floor})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

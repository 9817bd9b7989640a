#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths and its
Poincaré ops on one GPU and check them.

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
   split, with its cluster split (host preparation, timed on its own);
6. hold each scatter kernel against its plain version on the card at the
   training path's shapes (the real straggler, clustered and decoder
   edge sets), plus an input with empty rows and padding edges, the
   straggler and decoder sets from an unaligned data_ptr, 3,000 edges
   over all 169,343 rows and no edge at all; ``csr_segment_sum``
   launched twice must give the same bits;
7. the training path: ``run_hgcn_bench`` (bf16 edge messages and decoder
   pass, hidden (128, 32), Lorentz) for one warm-up and 10 timed steps;
   every loss finite, the last timed loss below the first, and the
   launch counts must rise by steps × 7 (``csr_segment_sum``) and
   steps × 4 (``cluster_aggregate``); then the device busy time, idle
   share and top device items of a step, the peak device memory, and
   the test ROC-AUC after the steps;
8. the whole step on the card against the port on the CPU (the plain
   versions), 2 steps each on a 20,000-node split with its cluster
   split, from the same parameters and negatives: losses within rel 2e-2;
9. the attention arm's data: phase 5's split with its cluster split
   rebuilt at the attention threshold (128 edges a pair); the gate must
   be open; then ``csr_segment_reduce_1d`` (sum and max),
   ``csr_att_bwd_edges``, ``cluster_att_fwd`` and ``cluster_att_bwd``
   against their plain versions on the path's straggler and clustered
   edge sets at F = 128 and 32, bf16 and f32, plus inputs with empty rows
   and padding edges and with F = 8 and 130, ``csr_att_bwd_edges`` also
   on unaligned views of its rows and (d_num | d_den); and
   ``csr_segment_sum`` at the arm's widths (F + 1 = 129 and 33, bf16) on
   both edge sets; each kernel launched twice must give the same bits;
10. the attention training path: ``run_hgcn_bench`` with ``use_att`` (lr
   3e-3, clip 1.0) for one warm-up and 10 timed steps; losses finite and
   falling, and the launch counts exactly steps × 2 for each attention
   kernel, × 7 for ``csr_segment_sum`` and 0 for ``cluster_aggregate``;
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
   holds its own kernel; MLR logits;
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
   ``exclude_self``, hyperboloid rows; the ADC scan at the path's m = 3,
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
   ([82,115, 10], [169,343, 128], [256, 48]) with c 1, 0.5 and 2.3, at
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
   share), the ``nvidia-smi`` line, and finally
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
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
    # (PyTorch's in at::native::(anonymous namespace))
    hand = sum(ms for k, ms in items.items()
               if k.removeprefix("void ").startswith("(anonymous namespace)"))
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


def segment_cost(e: int, f: int, n: int, size: int) -> tuple[float, float]:
    """(bytes, operations) of a sorted segment sum: values and receivers
    read once, the [n, f] output written once; one add per value."""
    return (float(e) * f * size + 4.0 * e + float(n) * f * size,
            float(e) * f)


def cluster_cost(e: int, f: int, n: int, size: int) -> tuple[float, float]:
    """(bytes, operations) of the cluster aggregation: h read once, 12 B
    per edge (receiver, sender, weight), the output written once; one
    multiply-add per edge and column."""
    return (2.0 * n * f * size + 12.0 * e, 2.0 * e * f)


def train_path(torch, args, card: dict) -> dict:
    """Phases 5–8; returns what the kernels line needs."""
    from hyperspace_torch.benchmarks import hgcn_bench as B
    from hyperspace_torch.kernels.cluster import (build_cluster_split,
                                                  cluster_aggregate,
                                                  cluster_aggregate_plain)
    from hyperspace_torch.kernels.segment import csr_segment_sum
    from hyperspace_torch.models import hgcn

    dev = torch.device("cuda")
    # --- phase 5: the training data ------------------------------------
    t0 = time.perf_counter()
    setup = B.setup_lp(device=dev, seed=args.seed)
    agg, n = setup.ga.cluster, setup.num_nodes
    cs = setup.split.graph.cluster_split
    if cs is None:
        raise AssertionError("no cluster split at arxiv scale")
    n_strag = int(cs.s_mask.sum())
    emit({"phase": "train_setup", "host_prep_s": setup.prep_s,
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
        h = torch.randn(n, f, generator=gen, device=dev).to(dtype)
        got = cluster_aggregate(h, agg.c_wf, agg.c_recv, agg.c_send, None, n)
        torch.cuda.synchronize()
        want = cluster_aggregate_plain(h, agg.c_wf, agg.c_recv, agg.c_send,
                                       n)
        w_used = agg.c_wf.to(dtype).float()     # bf16 h: rounded weights
        k = torch.bincount(agg.c_recv.long(), minlength=n).float()[:, None]
        bound = 2.0 * k * F32_EPS * cluster_aggregate_plain(
            h.float().abs(), w_used.abs(), agg.c_recv, agg.c_send, n)
        err["cluster_aggregate"] = max(err["cluster_aggregate"],
                                       check_scatter(
            torch, "cluster_aggregate", f"clustered F={f}", got, want,
            bound))

    cl_case(128, bf16)
    cl_case(32, bf16)
    cl_case(128, f32)
    emit({"phase": "scatter_checks", "seconds": time.perf_counter() - t0})

    # --- phase 7: the training path --------------------------------------
    t0 = time.perf_counter()
    csr_segment_sum.launches = cluster_aggregate.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = B.run_hgcn_bench(steps=TRAIN_STEPS, warmup=1, setup=setup)
    launches = {"csr_segment_sum": csr_segment_sum.launches,
                "cluster_aggregate": cluster_aggregate.launches}
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
            "cpu_split": split}


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

    def clu(hh):
        return lambda: cluster_aggregate(hh, agg.c_wf, agg.c_recv,
                                         agg.c_send, None, n)

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
        "library_ms": device_ms(torch, lambda: torch.sparse.mm(w_csr, h32)),
        "library_call": "torch.sparse.mm of the f32 CSR weight matrix "
                        "and f32 h",
        "call_ms": timed_ms(torch, clu(h[128])),
        "ms_F32": device_ms(torch, clu(h[32])),
        "bound_ms_F32": bound_ms(*cluster_cost(e, 32, n, 2))[0],
        **card}
    return [seg_entry, cl_entry]


# --- the HGCN attention arm at ogbn-arxiv scale -------------------------------

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
    emit({"phase": "att_setup", "cluster_split_s": split_s,
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

    every3 = (agg.c_recv % 3) == 0           # rows 1, 2 of every 3 empty
    c_sets = {"clustered": (agg.c_recv, agg.c_send),
              "clustered, empty rows": (agg.c_recv[every3].contiguous(),
                                        agg.c_send[every3].contiguous())}
    a_s, a_r = rand(n, scale=0.7), rand(n, scale=0.7) + 0.3
    for label, (r, s_) in c_sets.items():
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
                h, a_s, a_r, r, s_, None, n, ATT_SLOPE, ATT_BOUND))
            want = KC.cluster_att_fwd_plain(h, a_s, a_r, r, s_, n, ATT_SLOPE,
                                            ATT_BOUND)
            sc = KC.cluster_att_fwd_plain(h.abs(), a_s, a_r, r, s_, n,
                                          ATT_SLOPE, ATT_BOUND)
            err["cluster_att_fwd"] = max(err["cluster_att_fwd"], check_att(
                torch, "cluster_att_fwd", tag, got, again, want, sc,
                k[:, None], wulp))
            got, again = twice(lambda: KC.cluster_att_bwd(
                gext, h, a_s, a_r, r, s_, None, n, ATT_SLOPE, ATT_BOUND))
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
    torch.cuda.reset_peak_memory_stats()
    res = B.run_hgcn_bench(steps=TRAIN_STEPS, warmup=1, setup=setup)
    launches = att_counts()
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

    def fwd_cost(f, size):
        return (ce * 8.0 + n * (f * size + 8.0) + n * 4.0 * (f + 1),
                ce * (2.0 * f + 20.0))

    def bwd_cost(f, size):
        return (ce * 8.0 + n * (4.0 * (f + 1) + f * size + 8.0)
                + n * 4.0 * (f + 2), ce * (6.0 * f + 40.0))

    def fwd(f):
        return lambda: KC.cluster_att_fwd(h[f], a_s, a_r, cr, csn, None, n,
                                          ATT_SLOPE, ATT_BOUND)

    def bwd(f):
        return lambda: KC.cluster_att_bwd(gx[f], h[f], a_s, a_r, cr, csn,
                                          None, n, ATT_SLOPE, ATT_BOUND)

    fb, fby = bound_ms(*fwd_cost(128, 2))
    entries.append({
        **base("cluster_att_fwd", "hs_cluster_att_fwd", "cluster.py:401",
               [n, 128, ce]),
        "source": cl_src, "dtype": "bfloat16",
        "ms": device_ms(torch, fwd(128)),
        "plain_ms": device_ms(torch, lambda: KC.cluster_att_fwd_plain(
            h[128], a_s, a_r, cr, csn, n, ATT_SLOPE, ATT_BOUND), reps=5),
        "bound_ms": fb, "bound_by": fby, "library_ms": None,
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
    torch.cuda.synchronize()
    want = hyp_mlr_plain(x, p, a, C)
    diff = (got - want).abs()
    over = int((diff > MLR_ATOL + MLR_RTOL * want.abs()).sum())
    emit({"phase": "check", "kernel": "hyp_mlr", "shape": [n, k, d],
          "max_abs_err": float(diff.max()), "over_tolerance": over})
    if over:
        raise AssertionError(f"hyp_mlr [{n}, {k}, {d}]: {over} entries "
                             "beyond tolerance")
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
    for n, k, d in ((256, 8, 128), (2, 8, 64), (64, 4, 128), (3, 300, 33)):
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
                        f"log={log}"])
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


def mlr_cost(n: int, k: int, d: int) -> tuple[float, float]:
    """(bytes, operations) of the MLR logits: x, p, a read and the [n, k]
    logits written once; the two products x·pᵀ, x·aᵀ, the row and class
    norms, and about 30 operations of closed form per logit."""
    return (4.0 * (n * d + 2 * k * d + n * k),
            4.0 * n * k * d + 2.0 * (n + 3 * k) * d + 30.0 * n * k)


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
        "bound_ms_cli": bound_ms(*mlr_cost(64, 4, 128))[0], **card})
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
    valid = int((c8 >= 0).sum())
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
         "call_ms": timed_ms(torch, cand(8)),
         "ms_nprobe1": device_ms(torch, cand(1)),
         "shape_nprobe1": list(ip["cands"][1].shape), **card},
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
# feature width (configs[1]), the TPU smoke's own (B 256, D 48)
ROW_SHAPES = {"wordnet": (ROWS, DIM), "arxiv": (169343, 128),
              "smoke": (256, 48)}
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
        ts = [t.to(torch.bfloat16) for t in row_inputs(
            torch, gen, op, ROW_SHAPES["arxiv"], 1.0, dev)]
        check_gyro(torch, op, "bf16 arxiv", row_call(op, ts, 1.0),
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
        for name in ("wordnet", "smoke"):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
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
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

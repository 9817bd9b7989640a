#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises and exits non-zero; nothing is caught):

1. require CUDA; print the card's name and power limit;
2. build every kernel of the path from ``hyperspace_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it and at the full table;
4. the main path: a Poincaré table of WordNet-noun size (82,115 × 10,
   c = 1, made from ``--seed``) and its hyperboloid lift are exported as
   artifacts, loaded back, and served through the ``serve`` JSONL loop
   (``topk`` at buckets 8 and 1024, ``score`` with ``prob``, ``stats``)
   with both scan modes; the answers are checked against each other and
   against a float64 brute force on the CPU, and every kernel's launch
   count must have risen during this phase;
5. print the kernels line (device times of each kernel and its plain
   version at the main path's shapes, bounds, launches), the top-k
   throughput at bucket 1024 (batches of cold ids through the batcher,
   the engine call alone, and the card's busy share), the
   ``nvidia-smi`` line, and finally ``{"ok": true, "device": {...}}``.
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
    ``torch.profiler``: only the events that ran on the card, so a host
    operator and the kernels it launched are not counted twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def device_ms(torch, fn, reps: int = 20) -> float:
    """Summed device time of everything ``fn`` runs on the card, per
    call: a kernel's own time, free of the host's launch overhead."""
    return sum(device_items(torch, fn, reps).values())


def device_share(torch, fn, wall_ms: float, reps: int = 5) -> dict:
    """Device busy time per call of ``fn``, its share of ``wall_ms`` (the
    call's unprofiled wall time) and the three largest device items."""
    items = device_items(torch, fn, reps)
    busy = sum(items.values())
    top = sorted(items.items(), key=lambda r: -r[1])[:3]
    return {"device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "top_device_ms": {k[:60]: ms for k, ms in top}}


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
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
    _support.build_all(["pdist", "scan_topk"])
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
            for rows in (table[:chunk], table):  # a served chunk, the table
                got = pdist(q, rows, C, manifold=man)
                torch.cuda.synchronize()
                want = pdist_plain(q, rows, C, manifold=man)
                diff = (got - want).abs()
                worst = float(diff.max())
                err["pdist"] = max(err["pdist"], worst)
                over = int((diff > ATOL + RTOL * want.abs()).sum())
                emit({"phase": "check", "kernel": "pdist", "manifold": man,
                      "shape": [b, rows.shape[0], rows.shape[1]],
                      "max_abs_err": worst, "over_tolerance": over})
                if over:
                    raise AssertionError(
                        f"pdist {man}: {over} entries beyond "
                        f"rtol={RTOL} atol={ATOL}")
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

    # --- phase 5: times ----------------------------------------------------
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
         "replaces": "hyperspace_tpu/kernels/distmat.py:119",
         "launches": launches["pdist"], "max_abs_err": err["pdist"],
         "shape": [BATCH, chunk, DIM],
         "ms": device_ms(torch, run_pdist(BATCH)),
         "plain_ms": device_ms(torch, lambda: pdist_plain(
             q, rows, C, manifold="poincare")),
         "bound_ms": pb, "bound_by": pby, "library_ms": None,
         "call_ms": timed_ms(torch, run_pdist(BATCH)),
         "ms_bucket8": device_ms(torch, run_pdist(8)),
         "full_table_ms": device_ms(torch, run_pdist(BATCH, table)),
         **card},
        {"name": "scan_topk", "route": "cuda",
         "source": "hyperspace_torch/kernels/csrc/scan_topk.cu",
         "replaces": "hyperspace_tpu/kernels/scan_topk.py:677",
         "launches": launches["scan_topk"],
         "max_abs_err": err["scan_topk"],
         "shape": [BATCH, padded, DIM, K],
         "ms": device_ms(torch, run_scan(BATCH)),
         "plain_ms": device_ms(torch, lambda: scan_topk_plain(
             slab, q, qi, 0, kind="poincare", c=C, k=K, n=ROWS,
             exclude_self=True), reps=3),
         "bound_ms": sb, "bound_by": sby, "library_ms": None,
         "call_ms": timed_ms(torch, run_scan(BATCH)),
         "ms_bucket8": device_ms(torch, run_scan(8)), **card},
    ]
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
        batcher = RequestBatcher(eng)
        walls = {"engine": [], "batcher": []}
        for j, ids in enumerate(cold[:21]):
            t0 = time.perf_counter()
            i, d = eng.topk_neighbors(ids.astype(np.int32), K)
            i.cpu(), d.cpu()
            t1 = time.perf_counter()
            batcher.topk(ids.tolist(), K)
            t2 = time.perf_counter()
            if j:                                      # after a warm-up
                walls["engine"].append(t1 - t0)
                walls["batcher"].append(t2 - t1)
        if batcher.stats()["cache_hit"]:
            raise AssertionError("a throughput batch hit the cache")
        med = float(np.median(walls["batcher"])) * 1e3
        more = iter(cold[21:])
        throughput[mode] = {
            "batch_ms": med, "batches_per_s": 1e3 / med,
            "queries_per_s": BATCH * 1e3 / med,
            "engine_ms": float(np.median(walls["engine"])) * 1e3,
            **device_share(torch, lambda: batcher.topk(next(more).tolist(),
                                                       K), med)}
    emit({"phase": "throughput", "bucket": BATCH, "k": K,
          "manifold": "poincare", "rows": ROWS, **throughput, **card})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

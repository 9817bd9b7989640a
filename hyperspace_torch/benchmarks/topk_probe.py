"""What the slab top-k scans spend on the card, and how steady the
profiler's reading of them is.

    python -m hyperspace_torch.benchmarks.topk_probe [--seed 0] [--windows 40]

needs one CUDA device and ``nvcc``; it prints JSON lines:

- ``registers``: registers and spill bytes of every kernel in
  ``kernels/csrc/scan_topk.cu`` (each instantiation of the exact scan by
  kind and query width, of the ADC scan by m, of the candidate scan by
  kind, width and load bytes, the split merge), from
  ``nvcc -Xptxas -v`` with the package's own flags; that build is only
  read, never loaded;
- ``clocks``: the SM clock and its maximum (``nvidia-smi``) before and
  after the timings;
- ``times``: ``scan_topk`` (k = 10) and ``scan_topk_pq`` (k = 170, the
  serving engine's over-fetch at k = 10) at the serving path's shapes
  (the 82,115 × 10 ball table padded to 83,968 rows, PQ m = 3 codes of
  the same table), at batches of 8 and 1024, each profiled in
  ``--windows`` windows of 20 calls (``benchmarks/devtime.py``).  Each
  figure is a median with its range over the windows: device ms a call
  on the card's clock, its scan kernel and split merge apart, the same
  ms as the profiler read them (``raw_ms``), the ratio of the
  profiler's time of a calibration spin to the CUDA events' time of
  the same spin, how far a window's start and end ratios differ, and
  the SM clock the events give; ``refused`` counts the windows that
  could not be put on the card's clock.

The table is drawn as ``chip_smoke.py`` draws its serving table (an
isotropic ball sample from ``--seed``); the answers are not checked here
(``chip_smoke.py`` and ``tests/test_torch_cuda.py`` do).  Builds go to
``build/topk_probe`` at the root of the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess

import numpy as np
import torch

from hyperspace_torch.benchmarks.devtime import profile_window, ptxas_usage
from hyperspace_torch.kernels import _support as S
from hyperspace_torch.kernels import scan_topk as T

OUT = os.path.join(os.path.dirname(S.BUILD_DIR), "topk_probe")
ROWS, PADDED, DIM, K, K_PQ = 82115, 83968, 10, 10, 170


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def registers() -> None:
    os.makedirs(OUT, exist_ok=True)
    kinds = ("poincare", "lorentz", "euclidean")

    def name_of(sym):
        d = re.search(r"scan_topk_kernelILi(\d)ELi(\d+)E", sym)
        p = re.search(r"scan_pq_kernelILi(\d)E", sym)
        if d:
            width = d.group(2)
            return (f"scan_topk_{kinds[int(d.group(1))]}_d"
                    + ("general" if width == "0" else f"le{width}"))
        if p:
            return f"scan_topk_pq_m{p.group(1)}"
        c = re.search(r"scan_cand_kernelILi(\d)ELi(\d+)ELi(\d)E", sym)
        if c:
            width = c.group(2)
            return (f"scan_topk_cand_{kinds[int(c.group(1))]}_d"
                    + ("general" if width == "0" else width)
                    + f"_loads{4 * int(c.group(3))}")
        k = re.search(r"merge_tree_kernel", sym)
        return k.group(0) if k else sym

    emit({"probe": "registers", "by_kernel": ptxas_usage(
        S._nvcc(), S.NVCC_FLAGS, os.path.join(S.CSRC, "scan_topk.cu"),
        os.path.join(OUT, "scan_topk_v.so"), name_of)})


def clocks() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def times(seed: int, windows: int) -> None:
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.serve.artifact import build_quant_payload
    from hyperspace_torch.serve.engine import QueryEngine
    from hyperspace_torch.serve.index import _lift

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    ball = PoincareBall(1.0)
    table = ball.expmap0(torch.as_tensor(
        rng.standard_normal((ROWS, DIM)) * 0.5, dtype=torch.float32))
    q = ball.expmap0(torch.as_tensor(
        rng.standard_normal((1024, DIM)) * 0.5, dtype=torch.float32,
        device=dev))
    qi = torch.as_tensor(rng.choice(ROWS, 1024, replace=False),
                         dtype=torch.int32, device=dev)
    slab = torch.zeros((PADDED, DIM), device=dev)
    slab[:ROWS] = table.to(dev)
    spec = ("poincare", 1.0)
    quant = build_quant_payload(table.numpy(), spec, "pq")
    eng = QueryEngine(table.numpy(), spec, precision="pq", quant=quant,
                      scan_mode="fused")
    lut = T.pq_lut(_lift(spec, q).float(), eng.pq_codebooks, kind="poincare")
    codes = eng.scan_table
    for b in (8, 1024):
        runs = {
            "scan_topk": (K, lambda: T.scan_topk(
                slab, q[:b], qi[:b], 0, spec=spec, k=K, n=ROWS,
                exclude_self=True), slab.shape[0]),
            "scan_topk_pq": (K_PQ, lambda: T.scan_topk_pq(
                codes, lut[:b], qi[:b], 0, spec=spec, k=K_PQ, n=ROWS,
                exclude_self=True), codes.shape[0]),
        }
        for name, (k, fn, m) in runs.items():
            wins = []
            for _ in range(windows):
                items, _, (win,) = profile_window(torch, fn, 20, tries=1)
                win.update(
                    scan_ms=sum(v for key, v in items.items()
                                if "scan_" in key),
                    merge_ms=sum(v for key, v in items.items()
                                 if "merge" in key))
                wins.append(win)
            ok = [w for w in wins if w["accepted"]]
            ratio = [r for w in wins for r in w["profiler_over_events"]
                     if r is not None]
            gap = [a - e for a, e in (w["profiler_over_events"]
                                      for w in wins) if None not in (a, e)]
            emit({"probe": "times", "kernel": name, "batch": b, "rows": m,
                  "k": k, "splits": T._slab_splits(b, m, k, dev),
                  "windows": windows, "refused": windows - len(ok),
                  **spread("ms", [w["busy_ms"] for w in ok]),
                  **spread("scan_ms", [w["scan_ms"] for w in ok]),
                  **spread("merge_ms", [w["merge_ms"] for w in ok]),
                  **spread("raw_ms", [w["raw_busy_ms"] for w in wins]),
                  **spread("profiler_over_events", ratio),
                  **spread("start_minus_end", gap),
                  **spread("sm_mhz", [w["sm_mhz"][1] for w in wins])})


def spread(key: str, xs: list) -> dict:
    """``{key: median, key_range: [least, largest]}`` (None if empty)."""
    if not xs:
        return {key: None, f"{key}_range": None}
    return {key: float(np.median(xs)), f"{key}_range": [min(xs), max(xs)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--windows", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("topk_probe needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"probe": "card", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})
    registers()
    emit({"probe": "clocks", "sm_mhz_now_max": clocks()})
    times(args.seed, args.windows)
    emit({"probe": "clocks", "sm_mhz_now_max": clocks()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

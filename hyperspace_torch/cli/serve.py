"""Serving entry point: ``python -m hyperspace_torch.cli.serve``
(counterpart of ``hyperspace_tpu/cli/serve.py``, ``query`` and ``serve``).

    # one-shot queries: prints one JSON line
    python -m hyperspace_torch.cli.serve query artifact=DIR ids=0,1,2 k=5
    python -m hyperspace_torch.cli.serve query artifact=DIR u=0,1 v=2,3 prob=1

    # stdin/JSONL loop: one request per line, one JSON response per line
    python -m hyperspace_torch.cli.serve serve artifact=DIR

    # the approximate lanes: IVF probing (an artifact with an index) and
    # PQ codes (a shipped payload, else codebooks trained at start-up)
    python -m hyperspace_torch.cli.serve serve artifact=DIR nprobe=4 \
        precision=pq scan_mode=fused

Loop requests and responses have the JAX CLI's shapes:

    {"op": "topk",  "ids": [0, 1, 2], "k": 5}  -> {"neighbors": ..., "dists": ...}
    {"op": "score", "u": [0, 1], "v": [2, 3], "prob": true}  -> {"scores": ...}
    {"op": "stats"}                            -> the batcher's counters

A failed line answers ``{"error": {"kind": ..., "message": ...}}``
(``parse`` / ``validation`` / ``internal``) and the loop continues.
``device=cuda`` is the default; ``device=cpu`` runs the kernels' plain
PyTorch versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from typing import Any

import numpy as np


@dataclasses.dataclass
class ServeConfig:
    artifact: str | None = None   # artifact dir
    device: str = "cuda"          # cuda | cpu
    k: int = 10
    ids: str = ""                 # comma-separated query ids (one-shot topk)
    u: str = ""                   # comma-separated endpoints (one-shot score)
    v: str = ""
    prob: bool = False            # score as Fermi–Dirac link probability
    fd_r: float = 2.0
    fd_t: float = 1.0
    min_bucket: int = 8
    max_bucket: int = 1024
    cache_size: int = 65536
    chunk_rows: int = 0           # 0 = auto from the tile budget
    scan_mode: str = "two_stage"  # two_stage | fused
    # table-scan precision: f32 (exact) | pq (product-quantized codes,
    # k + max(16k, 128) coarse candidates rescored in f32; an artifact
    # exported with a PQ payload serves its shipped codes and codebooks)
    precision: str = "f32"
    # IVF probing: cells probed per query.  0 = exact scan; needs an
    # artifact exported with an index.  nprobe >= ncells or a table under
    # IVF_MIN_TABLE_ROWS falls back to the exact scan.
    nprobe: int = 0


def _coerce(old: Any, s: str) -> Any:
    if old is None:
        return s
    t = type(old)
    if t is bool:
        return s.lower() in ("1", "true", "yes")
    try:
        return t(s)
    except (TypeError, ValueError):
        return s


def apply_overrides(cfg, overrides: dict[str, str]):
    """Apply {field: str} overrides to a dataclass, coercing types."""
    names = {f.name for f in dataclasses.fields(cfg)}
    for k in overrides:
        if k not in names:
            raise SystemExit(
                f"unknown option {k!r} for {type(cfg).__name__}; "
                f"known: {sorted(names)}")
    return dataclasses.replace(
        cfg, **{k: _coerce(getattr(cfg, k), v) for k, v in overrides.items()})


def _json_safe(x):
    """Non-finite floats → null and numpy scalars → Python, so every
    emitted line is strict JSON."""
    if isinstance(x, np.generic):
        x = x.item()
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    return x


def _ids(s: str, name: str) -> list[int]:
    try:
        out = [int(t) for t in s.split(",") if t.strip() != ""]
    except ValueError:
        raise SystemExit(f"{name}={s!r}: want comma-separated integers")
    if not out:
        raise SystemExit(f"{name}= is required (comma-separated ids)")
    return out


def _build(cfg: ServeConfig):
    """The batcher over the committed artifact's engine."""
    from hyperspace_torch.serve import (QueryEngine, RequestBatcher,
                                        load_artifact)

    if not cfg.artifact:
        raise SystemExit("artifact= is required for query/serve modes")
    art = load_artifact(cfg.artifact)
    try:
        eng = QueryEngine.from_artifact(art, chunk_rows=cfg.chunk_rows,
                                        scan_mode=cfg.scan_mode,
                                        precision=cfg.precision,
                                        nprobe=cfg.nprobe,
                                        device=cfg.device)
        return RequestBatcher(eng, min_bucket=cfg.min_bucket,
                              max_bucket=cfg.max_bucket,
                              cache_size=cfg.cache_size)
    except (ValueError, RuntimeError) as e:  # bad options, or no CUDA
        raise SystemExit(str(e)) from None


def run_query(cfg: ServeConfig) -> dict:
    batcher = _build(cfg)
    try:
        if cfg.u or cfg.v:
            scores = batcher.score(_ids(cfg.u, "u"), _ids(cfg.v, "v"),
                                   prob=cfg.prob, fd_r=cfg.fd_r,
                                   fd_t=cfg.fd_t)
            return {"mode": "query", "scores": scores.tolist()}
        ids = _ids(cfg.ids, "ids")
        idx, dist = batcher.topk(ids, cfg.k)
    except ValueError as e:  # request-shaped errors: clean exit
        raise SystemExit(str(e)) from None
    return {"mode": "query", "ids": ids, "k": cfg.k,
            "neighbors": idx.tolist(), "dists": dist.tolist()}


def _json_bool(req: dict, key: str, default: bool) -> bool:
    """Strict JSON boolean: the string "false" is an error, not truthy."""
    v = req.get(key, default)
    if not isinstance(v, bool):
        raise ValueError(
            f"{key} must be a JSON boolean, got {type(v).__name__}")
    return v


def _req_id(req: dict) -> str | None:
    """The optional per-request ``request_id``, echoed in the response."""
    v = req.get("request_id")
    if v is None:
        return None
    if not isinstance(v, str) or not v:
        raise ValueError(
            f"request_id must be a non-empty string, got {v!r}")
    return v


def _handle(batcher, req: dict) -> dict:
    op = req.get("op")
    rid = _req_id(req)
    echo = {} if rid is None else {"request_id": rid}
    if op in ("topk", "score") and req.get("deadline_ms") is not None:
        raise ValueError("deadline_ms is not supported by this server yet")
    if op == "topk":
        # k passes through raw: the batcher rejects non-integers
        ids, k = req["ids"], req.get("k", 10)
        idx, dist = batcher.topk(ids, k, exclude_self=_json_bool(
            req, "exclude_self", True))
        return {"neighbors": idx.tolist(), "dists": dist.tolist(), **echo}
    if op == "score":
        scores = batcher.score(req["u"], req["v"],
                               prob=_json_bool(req, "prob", False),
                               fd_r=float(req.get("fd_r", 2.0)),
                               fd_t=float(req.get("fd_t", 1.0)))
        return {"scores": scores.tolist(), **echo}
    if op == "stats":
        return {**batcher.stats(), **echo}
    raise ValueError(f"unknown op {op!r} (want topk|score|stats)")


class _ParseError(Exception):
    """The line was not JSON at all (kind=parse)."""


def run_serve(cfg: ServeConfig, *, stdin=None, stdout=None) -> dict:
    """The JSONL loop: every non-blank line read gets exactly one
    response line.  Returns the closing stats; ``stdin``/``stdout`` are
    injectable for tests and in-process callers."""
    from hyperspace_torch.serve.errors import ServeError, error_response

    stdin = sys.stdin if stdin is None else stdin
    stdout = sys.stdout if stdout is None else stdout
    batcher = _build(cfg)
    served = 0
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        req = None
        try:
            try:
                req = json.loads(line)
            except json.JSONDecodeError as e:
                raise _ParseError(str(e)) from None
            if not isinstance(req, dict):
                raise ValueError(f"request must be a JSON object, "
                                 f"got {type(req).__name__}")
            resp = _handle(batcher, req)
            served += 1
        except _ParseError as e:
            resp = {"error": {"kind": "parse", "message": str(e)}}
        except (ServeError, ValueError, KeyError, TypeError,
                OverflowError) as e:
            resp = error_response(e)
        if ("error" in resp and isinstance(req, dict)
                and isinstance(req.get("request_id"), str)
                and req["request_id"]):
            resp = {**resp, "request_id": req["request_id"]}
        print(json.dumps(_json_safe(resp)), file=stdout, flush=True)
    return {"mode": "serve", "served": served, **batcher.stats()}


MODES = {"query": run_query, "serve": run_serve}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="hyperspace_torch.cli.serve",
        description="Answer embedding queries from a serving artifact.")
    ap.add_argument("mode", choices=sorted(MODES))
    ap.add_argument("overrides", nargs="*",
                    help="key=value overrides (ServeConfig fields)")
    args = ap.parse_args(argv)
    kv = {}
    for p in args.overrides:
        if "=" not in p:
            raise SystemExit(f"expected key=value, got {p!r}")
        k, v = p.split("=", 1)
        kv[k] = v
    cfg = apply_overrides(ServeConfig(), kv)
    result = MODES[args.mode](cfg)
    # serve mode's stdout is the response stream: its closing stats go
    # to stderr
    print(json.dumps(_json_safe(result)),
          file=sys.stderr if args.mode == "serve" else sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())

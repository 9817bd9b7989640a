"""Serving entry point: ``python -m hyperspace_torch.cli.serve``
(counterpart of ``hyperspace_tpu/cli/serve.py``).

    # freeze a committed checkpoint step of the port into an artifact
    # (quant=int4 or pq ships that lane's codes)
    python -m hyperspace_torch.cli.serve export ckpt=runs/pe/ck \
        out=runs/pe/artifact workload=poincare c=1.0 index=1 quant=pq

    # one-shot queries: prints one JSON line (precision=bf16|int8|int4|pq
    # scans a quantized copy and rescores in f32)
    python -m hyperspace_torch.cli.serve query artifact=DIR ids=0,1,2 k=5
    python -m hyperspace_torch.cli.serve query artifact=DIR u=0,1 v=2,3 prob=1

    # stdin/JSONL loop: one request per line, one JSON response per line
    python -m hyperspace_torch.cli.serve serve artifact=DIR deadline_ms=50

    # the asyncio HTTP front door with continuous batching (port=0 =
    # ephemeral; "[serve-http] listening on HOST:PORT" goes to stderr);
    # POST /admin/rollover {"target": DIR2} flips it onto another artifact
    python -m hyperspace_torch.cli.serve serve-http artifact=DIR \
        port=8080 max_wait_us=2000 queue_max=64 deadline_ms=50 prewarm=1

    # the live index: upserts and deletes through a delta segment
    python -m hyperspace_torch.cli.serve serve-http artifact=DIR live=1 \
        delta_cap=1024 compact_at=0.75

    # many artifacts behind one door, engines paged under a budget
    python -m hyperspace_torch.cli.serve serve-http device_budget_mb=64 \
        tenants='[{"name": "en", "artifact": "A"}, {"name": "de",
                  "artifact": "B", "weight": 2, "nprobe": 8}]'

Loop requests and responses have the JAX CLI's shapes:

    {"op": "topk",   "ids": [0, 1, 2], "k": 5}  -> {"neighbors": ..., "dists": ...}
    {"op": "score",  "u": [0, 1], "v": [2, 3], "prob": true}  -> {"scores": ...}
    {"op": "upsert", "ids": [7, 120], "rows": [[...], [...]]}
    {"op": "delete", "ids": [3]}
    {"op": "stats"}                            -> the serve counters

A failed line answers ``{"error": {"kind": ..., "message": ...}}``
(``parse`` / ``validation`` / ``deadline_exceeded`` / ``overloaded`` /
``internal``) and the loop continues.  ``upsert``/``delete`` need
``live=1`` (the artifact's engine under a
:class:`~hyperspace_torch.serve.delta.LiveQueryEngine`; ``delta_cap=``
and ``compact_at=`` size its delta segment); a frozen engine answers
``validation``.  ``tenants=`` (serve-http only; inline JSON or a file)
and ``device_budget_mb=`` arm the engine registry.  ``deadline_ms=`` and
``queue_max=`` arm deadlines, admission and the degradation ladder;
``chaos=`` arms faults; ``access_log=``, ``window_s=``, ``slo_ms=``,
``incident_dir=``, ``trace=``, ``slow_log=``, ``log=``, ``telemetry=``
and ``trace_out=`` arm the observability plane; ``prewarm=`` launches
the bucket ladder before traffic; SIGTERM drains.  ``device=cuda`` is
the default (``serve-http`` without a card exits before it binds);
``device=cpu`` runs the kernels' plain PyTorch versions.  JAX's
``mesh`` and ``compile_cache_dir`` keys exit naming themselves.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import sys
from typing import Any

import numpy as np


@dataclasses.dataclass
class ServeConfig:
    artifact: str | None = None   # artifact dir (query/serve/serve-http)
    device: str = "cuda"          # cuda | cpu
    telemetry: bool = False       # host trace spans + a closing summary
    trace_out: str | None = None  # Chrome trace_events dump
    # export
    ckpt: str | None = None       # the port's checkpoint dir
    out: str | None = None        # artifact dir to write
    workload: str = "poincare"    # poincare | lorentz | product
    c: str | None = None          # the trained curvature (poincare/lorentz)
    factors: str = ""             # product factor layout JSON [[kind, dim], ...]
    step: int = -1                # checkpoint step (-1 = newest committed)
    overwrite: bool = False
    index: bool = False           # build an IVF index into the artifact
    ncells: int = 0               # 0 = ~sqrt(N); ncells=K alone implies index
    quant: str = ""               # int4 | pq: ship the lane's payload
    # query / serve
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
    mesh: int = 0                 # not ported: the port serves one device
    scan_mode: str = "two_stage"  # two_stage | fused
    # table-scan precision: f32 (exact) | bf16 | int8 | int4 | pq: a
    # coarse scan of a bf16, int8 (per-row f32 scale), int4 (per-row f16
    # scale) or PQ copy keeps k + max(k, 8), k + max(4k, 32) or
    # k + max(16k, 128) candidates, rescored in f32; an artifact
    # exported with an int4 or PQ payload serves its shipped codes
    precision: str = "f32"
    # IVF probing: cells probed per query.  0 = exact scan; needs an
    # artifact exported with an index.
    nprobe: int = 0
    # the live index (serve/delta.py): upsert/delete through a delta
    # segment of delta_cap rows, compacted in the background at
    # compact_at of it; the base must not be fused
    live: bool = False
    delta_cap: int = 1024
    compact_at: float = 0.75
    # overload safety: a default per-request deadline (0 = none), and a
    # bounded admission queue driving the degradation ladder (0 = off)
    deadline_ms: float = 0.0
    queue_max: int = 0
    # fault injection, e.g. chaos=serve.dispatch:latency:ms=50:times=3
    chaos: str | None = None
    chaos_seed: int = 0
    # the HTTP front door (serve-http)
    host: str = "127.0.0.1"
    port: int = 0
    max_wait_us: float = 2000.0   # continuous batching's max wait
    compile_cache_dir: str | None = None  # not ported: XLA's cache
    # launch the bucket ladder before traffic: 0 = off, 1 = k=, or a
    # comma list of k values
    prewarm: str = "0"
    # observability plane
    log: str | None = None        # run_manifest + telemetry_summary JSONL
    access_log: str | None = None  # one JSONL line per request
    window_s: float = 60.0        # rolling SLO window (0 disables)
    slo_ms: float = 0.0           # latency-aware ladder signal (0 = off)
    incident_dir: str | None = None  # flight-recorder dumps
    trace: bool = False           # per-stage span trees (syncs per dispatch)
    slow_log: str | None = None   # SLO breaches with span trees
    # multi-tenant serving (serve-http only; serve/registry.py): a JSON
    # list, inline or a file, of {"name", "artifact", "weight"?,
    # "queue_max"?, "deadline_ms"?, "slo_ms"?, "precision"?, "nprobe"?};
    # the first is the default route.  Exclusive of artifact= and live=1
    tenants: str | None = None
    # engine paging: MiB of device tables past which idle tenants'
    # engines are dropped and rebuilt on demand (0 = unlimited)
    device_budget_mb: float = 0.0


# JAX's keys this port does not serve yet: set to anything but the
# default, they exit naming themselves
NOT_PORTED = {
    "mesh": "mesh sharding (the port serves one device)",
    "compile_cache_dir": "XLA's persistent compilation cache",
}


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


def reject_not_ported(cfg: ServeConfig) -> None:
    defaults = ServeConfig()
    for name, what in NOT_PORTED.items():
        value = getattr(cfg, name)
        if value != getattr(defaults, name):
            raise SystemExit(f"{name}={value!r}: not ported ({what})")


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


def _stderr(line: str) -> None:
    """A diagnostics line on stderr; a closed stderr loses it, never a
    request."""
    with contextlib.suppress(OSError, ValueError):
        print(line, file=sys.stderr, flush=True)


def _build(cfg: ServeConfig):
    """The batcher over the committed artifact's engine, with the
    observability plane the config arms."""
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
        if cfg.live:
            # the artifact table becomes the host master (a writable
            # copy: the loaded artifact stays as it is) and the frozen
            # engine the base under a delta segment
            from hyperspace_torch.parallel.host_table import HostEmbedTable
            from hyperspace_torch.serve.delta import LiveQueryEngine

            master = HostEmbedTable.from_array(
                np.array(art.table, np.float32))
            eng = LiveQueryEngine(eng, master, capacity=cfg.delta_cap,
                                  compact_at=cfg.compact_at)
    except (ValueError, RuntimeError) as e:  # bad options, or no CUDA
        raise SystemExit(str(e)) from None
    window = recorder = alog = sink = slow = slow_sink = None
    if cfg.window_s < 0:
        raise SystemExit(f"window_s must be >= 0; got {cfg.window_s}")
    if cfg.window_s:
        from hyperspace_torch.telemetry.window import SloWindow

        window = SloWindow(cfg.window_s)
    if cfg.trace or cfg.slow_log:
        from hyperspace_torch.telemetry import spans

        spans.enable()      # slow_log= needs span trees: implies trace=
    try:
        from hyperspace_torch.serve.access import AccessLog, FlightRecorder

        if cfg.incident_dir:
            recorder = FlightRecorder(cfg.incident_dir)
        if cfg.access_log or recorder is not None:
            alog = AccessLog(cfg.access_log, recorder=recorder)
            sink = alog.emit
        if cfg.slow_log:
            slow = AccessLog(cfg.slow_log)
            slow_sink = slow.emit
    except OSError as e:
        raise SystemExit(f"observability path: {e}") from None
    try:
        batcher = RequestBatcher(eng, min_bucket=cfg.min_bucket,
                                 max_bucket=cfg.max_bucket,
                                 cache_size=cfg.cache_size,
                                 queue_max=cfg.queue_max,
                                 deadline_ms=cfg.deadline_ms,
                                 window=window, slo_ms=cfg.slo_ms,
                                 access_sink=sink, recorder=recorder,
                                 slow_sink=slow_sink)
    except ValueError as e:  # bad queue_max/deadline_ms/slo_ms
        raise SystemExit(str(e)) from None
    batcher.access_log = alog  # closed by the serve-session bracket
    batcher.slow_log = slow
    return batcher


TENANT_FIELDS = ("name", "artifact", "weight", "queue_max", "deadline_ms",
                 "slo_ms", "precision", "nprobe")


def _build_registry(cfg: ServeConfig, prewarm_ks: list[int]):
    """``tenants=`` (inline JSON or a path to a JSON file) → a built
    :class:`~hyperspace_torch.serve.registry.EngineRegistry`.  A tenant's
    fields override the shared config's knobs; malformed rosters are
    usage errors before any engine builds."""
    from hyperspace_torch.serve.registry import EngineRegistry

    if cfg.artifact:
        raise SystemExit("tenants= and artifact= are mutually exclusive "
                         "(each tenant names its own artifact)")
    if cfg.live:
        raise SystemExit("tenants= does not support live=1 yet (the "
                         "delta segment is per-engine state that "
                         "engine paging would drop)")
    text = cfg.tenants
    if text and os.path.exists(text):
        try:
            with open(text, "r", encoding="utf-8") as f:
                text = f.read()
        except OSError as e:
            raise SystemExit(f"tenants={cfg.tenants}: {e}") from None
    try:
        roster = json.loads(text or "")
    except json.JSONDecodeError as e:
        raise SystemExit(
            f"tenants= wants a JSON list (inline or a file path): {e}"
        ) from None
    if (not isinstance(roster, list) or not roster
            or not all(isinstance(t, dict) for t in roster)):
        raise SystemExit(
            "tenants= wants a non-empty JSON list of tenant objects")
    try:
        reg = EngineRegistry(device_budget_mb=cfg.device_budget_mb,
                             max_wait_us=cfg.max_wait_us,
                             prewarm_ks=prewarm_ks)
    except ValueError as e:
        raise SystemExit(f"device_budget_mb: {e}") from None
    try:
        for t in roster:
            name, artifact = t.get("name"), t.get("artifact")
            if not (isinstance(name, str) and name
                    and isinstance(artifact, str) and artifact):
                raise SystemExit(
                    f"tenant entry {t!r}: wants string \"name\" and "
                    "\"artifact\" fields")
            unknown = set(t) - set(TENANT_FIELDS)
            if unknown:
                raise SystemExit(
                    f"tenant {name!r}: unknown field(s) "
                    f"{sorted(unknown)}")
            reg.add_tenant(
                name, artifact,
                weight=float(t.get("weight", 1.0)),
                window_s=cfg.window_s,
                engine_kw=dict(
                    chunk_rows=cfg.chunk_rows,
                    scan_mode=cfg.scan_mode,
                    precision=t.get("precision", cfg.precision),
                    nprobe=int(t.get("nprobe", cfg.nprobe)),
                    device=cfg.device),
                batcher_kw=dict(
                    min_bucket=cfg.min_bucket,
                    max_bucket=cfg.max_bucket,
                    cache_size=cfg.cache_size,
                    queue_max=int(t.get("queue_max", cfg.queue_max)),
                    deadline_ms=float(t.get("deadline_ms",
                                            cfg.deadline_ms)),
                    slo_ms=float(t.get("slo_ms", cfg.slo_ms))))
    except (ValueError, TypeError, OSError, RuntimeError) as e:
        # a bad artifact, a duplicate name, bad knob values, no CUDA
        reg.close(wait=False)
        raise SystemExit(f"tenants=: {e}") from None
    except SystemExit:
        reg.close(wait=False)
        raise
    return reg


def _prewarm_ks(cfg: ServeConfig) -> list[int]:
    """``prewarm=`` as the k values to warm ([] = off)."""
    v = cfg.prewarm.strip().lower()
    if v in ("", "0", "false", "no", "off"):
        return []
    if v in ("1", "true", "yes", "on"):
        return [cfg.k]
    try:
        ks = [int(t) for t in v.split(",") if t.strip()]
    except ValueError:
        raise SystemExit(
            f"prewarm={cfg.prewarm!r}: want 0/1 or a comma-separated "
            "list of k values to warm") from None
    if not ks or any(k < 1 for k in ks):
        raise SystemExit(f"prewarm={cfg.prewarm!r}: k values must be >= 1")
    return ks


def run_export(cfg: ServeConfig) -> dict:
    from hyperspace_torch.serve import export_from_checkpoint

    if not (cfg.ckpt and cfg.out):
        raise SystemExit("export needs ckpt= and out=")
    model_config: dict = {}
    if cfg.workload in ("poincare", "lorentz"):
        if cfg.c is None:
            raise SystemExit(
                f"export workload={cfg.workload} requires c= (the "
                "curvature the run trained with)")
        try:
            model_config["c"] = float(cfg.c)
        except ValueError:
            raise SystemExit(f"c={cfg.c!r}: want a float") from None
    elif cfg.factors:
        try:
            model_config["factors"] = json.loads(cfg.factors)
        except json.JSONDecodeError as e:
            raise SystemExit(
                f"factors={cfg.factors!r}: want JSON [[kind, dim], ...] "
                f"({e})") from None
    index_ncells = None
    if cfg.index or cfg.ncells:
        if cfg.ncells < 0:
            raise SystemExit(f"ncells={cfg.ncells}: want 0 (auto) or >= 2")
        index_ncells = cfg.ncells or -1  # <= 0 = auto (~sqrt(N))
    if cfg.quant and cfg.quant not in ("int4", "pq"):
        raise SystemExit(f"quant={cfg.quant!r}: want int4 or pq")
    try:
        art = export_from_checkpoint(
            cfg.ckpt, cfg.out, workload=cfg.workload,
            model_config=model_config,
            step=None if cfg.step < 0 else cfg.step,
            overwrite=cfg.overwrite, index_ncells=index_ncells,
            quant_lane=cfg.quant or None, device=cfg.device)
    except (ValueError, FileNotFoundError, FileExistsError,
            RuntimeError) as e:
        raise SystemExit(str(e)) from None
    out = {"mode": "export", "out": cfg.out, "workload": cfg.workload,
           "num_nodes": art.num_nodes, "dim": art.dim, "step": art.step,
           "fingerprint": art.fingerprint}
    if art.index is not None:
        out["index"] = {"ncells": art.index.ncells,
                        "max_cell": art.index.max_cell,
                        "fingerprint": art.index.fingerprint}
    if art.quant is not None:
        out["quant"] = {"lane": art.quant.lane,
                        "fingerprint": art.quant.fingerprint}
    return out


def run_query(cfg: ServeConfig) -> dict:
    from hyperspace_torch.serve.errors import ServeError

    batcher = _build(cfg)
    try:
        if cfg.u or cfg.v:
            scores = batcher.score(_ids(cfg.u, "u"), _ids(cfg.v, "v"),
                                   prob=cfg.prob, fd_r=cfg.fd_r,
                                   fd_t=cfg.fd_t)
            return {"mode": "query", "scores": scores.tolist()}
        ids = _ids(cfg.ids, "ids")
        idx, dist = batcher.topk(ids, cfg.k)
    except (ValueError, ServeError) as e:  # request-shaped: clean exit
        raise SystemExit(str(e)) from None
    finally:
        _close_logs(batcher)
    return {"mode": "query", "ids": ids, "k": cfg.k,
            "neighbors": idx.tolist(), "dists": dist.tolist()}


def _close_logs(batcher) -> None:
    """Close the logs ``_build`` opened (a registry's batchers have none)."""
    for log in (getattr(batcher, "access_log", None),
                getattr(batcher, "slow_log", None)):
        if log is not None:
            log.close()


def _window_line(batcher) -> str | None:
    """The rolling-window SLO line; None when no window is armed."""
    if batcher.window is None:
        return None
    rep = batcher.window.report()
    e = rep.get("e2e_ms")
    if not e:
        return "[serve] window: no requests in the current window"
    return ("[serve] window %.1fs e2e_ms count=%d p50=%.3f p95=%.3f "
            "p99=%.3f qps=%.2f shed/s=%.2f err/s=%.2f"
            % (rep["window_s"], e["count"], e["p50"], e["p95"],
               e["p99"], rep["rate_qps"], rep["shed_rate"],
               rep["error_rate"]))


def _print_window(batcher) -> None:
    line = _window_line(batcher)
    if line is not None:
        _stderr(line)


def _run_manifest(cfg: ServeConfig) -> dict:
    """The first record of a ``log=`` session: the config as executed
    and the device's identity (JAX's ``run_manifest`` keys)."""
    import torch

    import hyperspace_torch

    cuda = cfg.device.startswith("cuda") and torch.cuda.is_available()
    return {"config": dataclasses.asdict(cfg),
            "backend": "cuda" if cuda else "cpu",
            "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 1,
            "process_index": 0, "process_count": 1,
            "version": hyperspace_torch.__version__}


@contextlib.contextmanager
def _serve_session(cfg: ServeConfig, batcher):
    """With ``log=``, a ``run_manifest`` first record and a closing
    ``telemetry_summary`` scoped to this session by a registry mark;
    always closes the access logs and turns spans back off.  Yields the
    mark."""
    from hyperspace_torch.telemetry import registry as telem

    logs = (getattr(batcher, "access_log", None),
            getattr(batcher, "slow_log", None))
    del batcher   # a rollover's flip must be able to free the old engine
    mark = telem.default_registry().mark()
    logger = None
    try:
        if cfg.log:
            from hyperspace_torch.train.logging import MetricsLogger

            try:
                logger = MetricsLogger(cfg.log, stdout=False)
            except OSError as e:
                raise SystemExit(f"log={cfg.log}: {e}") from None
            logger.event("run_manifest", **_run_manifest(cfg))
        yield mark
    finally:
        if logger is not None:
            logger.event("telemetry_summary",
                         **telem.default_registry().snapshot(
                             "ctr/", baseline=mark))
            logger.close()
        for log in logs:
            if log is not None:
                log.close()
        if cfg.trace or cfg.slow_log:
            from hyperspace_torch.telemetry import spans

            spans.disable()


def _json_bool(req: dict, key: str, default: bool) -> bool:
    """Strict JSON boolean: the string "false" is an error, not truthy."""
    v = req.get(key, default)
    if not isinstance(v, bool):
        raise ValueError(
            f"{key} must be a JSON boolean, got {type(v).__name__}")
    return v


def _req_deadline(req: dict):
    """The optional per-request ``deadline_ms``: a positive number."""
    v = req.get("deadline_ms")
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, (int, float)) or v <= 0:
        raise ValueError(
            f"deadline_ms must be a positive number, got {v!r}")
    return float(v)


def _req_id(req: dict) -> str | None:
    """The optional per-request ``request_id``, echoed in the response."""
    v = req.get("request_id")
    if v is None:
        return None
    if not isinstance(v, str) or not v:
        raise ValueError(
            f"request_id must be a non-empty string, got {v!r}")
    return v


def _handle(batcher, req: dict, entered=None) -> dict:
    """One request; ``entered[0]`` turns True once a batcher entry runs
    (past it the batcher writes the access record)."""
    op = req.get("op")
    rid = _req_id(req)
    echo = {} if rid is None else {"request_id": rid}
    if op == "topk":
        # k passes through raw: the batcher rejects non-integers
        ids, k = req["ids"], req.get("k", 10)
        exclude_self = _json_bool(req, "exclude_self", True)
        deadline_ms = _req_deadline(req)
        if entered is not None:
            entered[0] = True
        idx, dist = batcher.topk(ids, k, exclude_self=exclude_self,
                                 deadline_ms=deadline_ms, request_id=rid)
        return {"neighbors": idx.tolist(), "dists": dist.tolist(), **echo}
    if op == "score":
        u, v = req["u"], req["v"]
        prob = _json_bool(req, "prob", False)
        fd_r = float(req.get("fd_r", 2.0))
        fd_t = float(req.get("fd_t", 1.0))
        deadline_ms = _req_deadline(req)
        if entered is not None:
            entered[0] = True
        scores = batcher.score(u, v, prob=prob, fd_r=fd_r, fd_t=fd_t,
                               deadline_ms=deadline_ms, request_id=rid)
        return {"scores": scores.tolist(), **echo}
    if op in ("upsert", "delete"):
        deadline_ms = _req_deadline(req)
        if entered is not None:
            entered[0] = True
        if op == "upsert":
            return {**batcher.upsert(req.get("ids"), req.get("rows"),
                                     deadline_ms=deadline_ms,
                                     request_id=rid), **echo}
        return {**batcher.delete(req.get("ids"), deadline_ms=deadline_ms,
                                 request_id=rid), **echo}
    if op == "stats":
        return {**batcher.stats(), **echo}
    raise ValueError(
        f"unknown op {op!r} (want topk|score|upsert|delete|stats)")


def _loop_access(batcher, req, outcome: str) -> None:
    """Access-account a loop failure that never reached the batcher."""
    op, rid = "none", None
    if isinstance(req, dict):
        if isinstance(req.get("op"), str):
            op = req["op"]
        v = req.get("request_id")
        if isinstance(v, str) and v:
            rid = v
    batcher.emit_synthetic_access(op, request_id=rid, outcome=outcome)


class _ParseError(Exception):
    """The line was not JSON at all (kind=parse)."""


def _poll_lines(fd: int, draining):
    """Lines from a raw fd with a drain check every 0.25 s poll tick, so
    an idle server drains on SIGTERM (a blocking ``readline`` is retried
    after the handler runs and would wait for the client's next line)."""
    import select

    buf = b""
    while True:
        nl = buf.find(b"\n")
        if nl >= 0:
            line, buf = buf[:nl + 1], buf[nl + 1:]
            yield line.decode("utf-8", errors="replace")
            continue
        if draining.is_set():
            return
        ready, _, _ = select.select([fd], [], [], 0.25)
        if not ready:
            continue
        chunk = os.read(fd, 65536)
        if not chunk:  # EOF; a trailing unterminated line still serves
            if buf:
                yield buf.decode("utf-8", errors="replace")
            return
        buf += chunk


def _line_source(stdin, draining):
    """The polling raw-fd reader for real streams, plain iteration for
    injected ones (they drain at line boundaries)."""
    try:
        fd = stdin.fileno()
    except (AttributeError, OSError, ValueError, io.UnsupportedOperation):
        return iter(stdin)
    return _poll_lines(fd, draining)


def run_serve(cfg: ServeConfig, *, stdin=None, stdout=None) -> dict:
    """The JSONL loop: every non-blank line read gets exactly one
    response line.  SIGTERM drains: stop admitting lines, answer the one
    in flight, print the drain notice and the latency summary to stderr.
    Returns the closing stats; ``stdin``/``stdout`` are injectable."""
    import signal
    import threading

    from hyperspace_torch.serve.batcher import _REQUEST_ERRORS
    from hyperspace_torch.serve.errors import error_response
    from hyperspace_torch.serve.server import latency_summary_line

    stdin = sys.stdin if stdin is None else stdin
    stdout = sys.stdout if stdout is None else stdout
    batcher = _build(cfg)
    ks = _prewarm_ks(cfg)
    if ks:
        try:
            info = batcher.prewarm(ks)
        except ValueError as e:
            _close_logs(batcher)
            raise SystemExit(f"prewarm: {e}") from None
        _stderr(f"[serve] prewarmed {info['programs']} program(s) over "
                f"buckets {info['buckets']} ks {info['ks']} in "
                f"{info['seconds']:.2f}s")
    served = 0
    draining = threading.Event()
    prev_handler = None
    try:
        prev_handler = signal.signal(signal.SIGTERM,
                                     lambda _s, _f: draining.set())
    except ValueError:
        pass  # not the main thread: no drain hook, the loop still serves
    session = _serve_session(cfg, batcher)
    session_mark = session.__enter__()
    try:
        for line in _line_source(stdin, draining):
            if draining.is_set():
                break
            line = line.strip()
            if not line:
                continue
            is_stats = False
            req = None
            entered = [False]
            try:
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    raise _ParseError(str(e)) from None
                if not isinstance(req, dict):
                    raise ValueError(f"request must be a JSON object, "
                                     f"got {type(req).__name__}")
                resp = _handle(batcher, req, entered)
                served += 1
                is_stats = req.get("op") == "stats"
            except _ParseError as e:
                resp = {"error": {"kind": "parse", "message": str(e)}}
                _loop_access(batcher, req, "parse")
            except _REQUEST_ERRORS as e:
                resp = error_response(e)
                if not entered[0]:
                    _loop_access(batcher, req, resp["error"]["kind"])
            if ("error" in resp and isinstance(req, dict)
                    and isinstance(req.get("request_id"), str)
                    and req["request_id"]):
                resp = {**resp, "request_id": req["request_id"]}
            print(json.dumps(_json_safe(resp)), file=stdout, flush=True)
            if is_stats:
                _stderr(latency_summary_line(session_mark))
                _print_window(batcher)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        if draining.is_set():
            _stderr(f"[serve] drained: SIGTERM — stopped admitting, "
                    f"{served} request(s) served")
            if batcher.recorder is not None:
                batcher.recorder.dump("sigterm_drain", _cls="drain",
                                      wait=True)
        _stderr(latency_summary_line(session_mark))
        _print_window(batcher)
        session.__exit__(None, None, None)
    return {"mode": "serve", "served": served,
            "drained": draining.is_set(), **batcher.stats()}


def run_serve_http(cfg: ServeConfig, *, ready=None) -> dict:
    """The asyncio HTTP front door (``serve/server.py``) over the
    continuous-batching collator, or over an engine registry with
    ``tenants=``; ``/admin/rollover`` is armed with a builder that
    replays this config against the posted artifact (single tenant);
    SIGTERM drains.  ``ready(door)`` is
    called once the listener is bound (after the default ``[serve-http]
    listening on HOST:PORT`` line on stderr): ``door.port`` is the bound
    port, and an in-process caller drains the door on ``door.loop``."""
    import asyncio

    from hyperspace_torch.kernels._support import resolve_device
    from hyperspace_torch.serve.server import run_front_door

    if cfg.max_wait_us < 0:
        raise SystemExit(f"max_wait_us must be >= 0; got {cfg.max_wait_us}")
    prewarm_ks = _prewarm_ks(cfg)
    try:
        resolve_device(cfg.device)  # no card: exit before anything binds
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"serve-http: {e}") from None

    served = {}

    def announce(door):
        served["door"] = door
        _stderr(f"[serve-http] listening on {door.host}:{door.port}")
        if ready is not None:
            ready(door)

    if cfg.tenants:
        # one engine, batcher and ladder per roster entry behind the one
        # door, fair dispatch on the shared executor, engine paging
        registry = _build_registry(cfg, prewarm_ks)
        with _serve_session(cfg, registry.default.batcher):
            try:
                result = asyncio.run(run_front_door(
                    registry=registry, host=cfg.host, port=cfg.port,
                    max_wait_us=cfg.max_wait_us, ready=announce,
                    prewarm_ks=prewarm_ks))
            except ValueError as e:  # prewarm k out of range
                raise SystemExit(f"prewarm: {e}") from None
            except OSError as e:
                raise SystemExit(
                    f"serve-http: cannot bind {cfg.host}:{cfg.port} "
                    f"— {e}") from None
            finally:
                registry.close(wait=False)
        return {"mode": "serve_http", **result,
                "tenants": registry.stats()}
    def rebuild(target: str):
        # _build reports a bad artifact by SystemExit, which would escape
        # the connection task: the door's taxonomy answers a ValueError
        try:
            return _build(dataclasses.replace(cfg, artifact=target))
        except SystemExit as e:
            raise ValueError(str(e)) from None

    # the door alone holds the batcher (no local name here), so a
    # rollover frees the engine it flips away from; the closing stats
    # and window are the serving batcher's
    built = [_build(cfg)]
    with _serve_session(cfg, built[0]):
        try:
            result = asyncio.run(run_front_door(
                built.pop(), host=cfg.host, port=cfg.port,
                max_wait_us=cfg.max_wait_us, ready=announce,
                prewarm_ks=prewarm_ks, rollover_builder=rebuild))
        except ValueError as e:  # prewarm k out of range for this table
            raise SystemExit(f"prewarm: {e}") from None
        except OSError as e:  # bind failure: a usage error
            raise SystemExit(
                f"serve-http: cannot bind {cfg.host}:{cfg.port} — {e}"
            ) from None
        _print_window(served["door"].batcher)
    return {"mode": "serve_http", **result, **served["door"].batcher.stats()}


MODES = {"export": run_export, "query": run_query, "serve": run_serve,
         "serve-http": run_serve_http}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="hyperspace_torch.cli.serve",
        description="Export serving artifacts and answer embedding queries.")
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
    reject_not_ported(cfg)

    from hyperspace_torch.resilience import faults
    from hyperspace_torch.telemetry import cli_session
    from hyperspace_torch.telemetry import registry as telem

    try:
        chaos_armed = faults.install_chaos(cfg.chaos, cfg.chaos_seed)
    except ValueError as e:  # malformed chaos= grammar: a usage error
        raise SystemExit(str(e)) from None
    try:
        with cli_session(cfg.telemetry, cfg.trace_out, stream=sys.stderr):
            result = MODES[args.mode](cfg)
        if chaos_armed:
            result["chaos"] = faults.stats()
    finally:
        if chaos_armed:
            faults.clear()  # an in-process caller never inherits faults
        if cfg.telemetry:
            print(json.dumps({"telemetry_summary": telem.snapshot("ctr/")}),
                  file=sys.stderr, flush=True)
    # serve's stdout is its response stream and serve-http's responses
    # ride the sockets: their closing stats go to stderr
    print(json.dumps(_json_safe(result)),
          file=(sys.stderr if args.mode in ("serve", "serve-http")
                else sys.stdout))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Asyncio HTTP/1.1 front door over the collator (counterpart of
``hyperspace_tpu/serve/server.py``; standard library only).

====================  ======================================================
route                 body / answer
====================  ======================================================
``POST /v1/topk``     ``{"ids": [...], "k": 5, "exclude_self"?: bool,
                      "deadline_ms"?: ms}`` → ``{"neighbors": [[...]],
                      "dists": [[...]]}``
``POST /v1/score``    ``{"u": [...], "v": [...], "prob"?: bool, "fd_r"?,
                      "fd_t"?, "deadline_ms"?}`` → ``{"scores": [...]}``
``POST /v1/upsert``   ``{"ids": [...], "rows": [[...]], "deadline_ms"?}``
                      → ``{"upserted", "inserted", "generation",
                      "segment_rows"}`` (live engines, ``serve/delta.py``;
                      a frozen engine answers 400)
``POST /v1/delete``   ``{"ids": [...], "deadline_ms"?}`` →
                      ``{"deleted", "generation"}``
``POST /admin/rollover``  ``{"target": "<artifact dir>"}`` → the flip
                      report (``serve/rollover.py``); 400 when no
                      coordinator is armed or the gate refuses
``GET|POST /v1/stats``  ``batcher.stats()`` + a ``server`` block +
                      ``collator_flushes`` (``?tenant=`` narrows)
``GET /healthz``      ok/draining, uptime, version, fingerprint, scan
                      signature, precision, degrade level, generation
                      (503 draining; ``?tenant=`` narrows)
``GET /metrics``      Prometheus text of the telemetry registry
====================  ======================================================

With a registry (``registry=``, ``serve/registry.py``) one door serves
many tenants: a body's ``tenant`` field (a name or an artifact
fingerprint; absent = the default tenant) picks the stack, a paged-out
tenant is re-admitted before its dispatch, and an unknown one answers
404 ``unknown_tenant``.  ``door.batcher`` and ``door.collator`` are then
views onto the default tenant's stack, so a rollover flips the default
tenant.  A single-tenant door answers its own fingerprint as a tenant
and 404 for any other.

Every parsed request gets a request id (``X-Request-Id`` from the
client, sanitized, or generated), echoed as a response header and
stamped on the access record.  A failed request answers the stdin
loop's typed body ``{"error": {"kind": ..., "message": ...}}`` with the
kind mapped onto the status: ``parse``/``validation`` 400,
``overloaded`` 429, ``deadline_exceeded`` 504, ``internal`` 500 (a
kernel that fails to build or launch lands here: there is no fallback);
a body past ``MAX_BODY_BYTES`` answers 413, a wrong method 405, an
unknown route 404.  Exactly one response per request.

Deadlines count from the request line's arrival on the socket, so time
queued in the collator and the dispatch executor counts against
``deadline_ms``.  Drain (SIGTERM): stop accepting (the listener closes),
flush the collator's pending buckets, wait for every in-flight request —
the device dispatch on the executor cannot be cancelled, so it is
awaited and answered — close idle keep-alive connections, and release
the executor.  One task per connection; all device work lives on the
collator's dispatch thread, so nothing here blocks the event loop.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import signal
import sys
import time
import urllib.parse
from typing import Optional

import numpy as np

import hyperspace_torch
from hyperspace_torch.serve.access import new_request_id
from hyperspace_torch.serve.batcher import _REQUEST_ERRORS, RequestBatcher
from hyperspace_torch.serve.collator import DEFAULT_MAX_WAIT_US, Collator
from hyperspace_torch.serve.errors import (ServeError, UnknownTenantError,
                                           error_response)
from hyperspace_torch.telemetry import registry as telem
from hyperspace_torch.telemetry import spans
from hyperspace_torch.telemetry.exposition import render_prometheus

MAX_BODY_BYTES = 8 << 20  # one request's JSON; far past any bucket
MAX_HEADERS = 128         # header-count cap: no unbounded dict growth
_STATUS_BY_KIND = {"parse": 400, "validation": 400, "overloaded": 429,
                   "deadline_exceeded": 504, "unknown_tenant": 404,
                   "internal": 500}
_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable", 504: "Gateway Timeout"}


def _json_default(o):
    """numpy scalars and arrays degrade per value."""
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def _json_bool(req: dict, key: str, default: bool) -> bool:
    """Strict JSON boolean — the string \"false\" must be an error, not
    truthy (the stdin loop's reject-don't-coerce policy)."""
    v = req.get(key, default)
    if not isinstance(v, bool):
        raise ValueError(
            f"{key} must be a JSON boolean, got {type(v).__name__}")
    return v


def _req_deadline(req: dict) -> Optional[float]:
    """The optional per-request ``deadline_ms`` field, strict: a
    positive JSON number, not a bool/string; None = server default."""
    v = req.get("deadline_ms")
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, (int, float)) or v <= 0:
        raise ValueError(
            f"deadline_ms must be a positive number, got {v!r}")
    return float(v)


def _req_number(req: dict, key: str, default: float) -> float:
    v = req.get(key, default)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ValueError(f"{key} must be a JSON number, got {v!r}")
    return float(v)


class _TextPayload(str):
    """A non-JSON response body (the ``/metrics`` exposition): written
    verbatim with the given content type instead of json.dumps."""

    content_type = "text/plain; version=0.0.4; charset=utf-8"


class _Request:
    __slots__ = ("method", "target", "headers", "body", "t_in", "close",
                 "request_id")

    def __init__(self, method, target, headers, body, t_in, close):
        self.method = method
        self.target = target
        self.headers = headers
        self.body = body
        self.t_in = t_in       # socket-in stamp: deadline origin
        self.close = close     # client asked Connection: close / HTTP/1.0
        # accept-or-generate (docs/observability.md "Request tracing"):
        # the client's X-Request-Id wins; otherwise a fresh id — either
        # way it is echoed back and stamped on the access-log line.
        # Sanitized to [A-Za-z0-9._-] and capped: the id is echoed into
        # a response HEADER, so a hostile value must not be able to
        # smuggle CR/LF (header injection) or megabytes
        rid = headers.get("x-request-id", "")
        # ASCII-explicit: str.isalnum alone admits latin-1 letters
        # ('µ'), which would ride the echoed header as non-ASCII bytes
        rid = "".join(c for c in rid
                      if c.isascii() and (c.isalnum() or c in "-_."))[:64]
        self.request_id = rid or new_request_id()


class _BadRequest(Exception):
    """Protocol-level failure (not a serve op): answered 400 + close."""


class _TooLarge(_BadRequest):
    """Body past MAX_BODY_BYTES: answered 413 + close."""


class HttpFrontDoor:
    """The asyncio HTTP server (module docstring).  ``await start()``
    binds (port 0 = ephemeral; ``.port`` holds the bound port, ``.loop``
    the loop it serves on), ``await serve_until_drained()`` installs the
    SIGTERM handler and blocks until a drain completes, or drive
    ``drain()`` directly (from another thread, on ``.loop``).
    ``prewarm_info`` is what :func:`run_front_door`'s prewarm returned
    (None without one).  ``registry=`` (exclusive of ``batcher=`` and
    ``collator=``) serves every tenant of an
    :class:`~hyperspace_torch.serve.registry.EngineRegistry`;
    ``rollover`` (a :class:`~hyperspace_torch.serve.rollover.
    RolloverCoordinator`, armed after construction) serves
    ``/admin/rollover``."""

    def __init__(self, batcher: Optional[RequestBatcher] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_wait_us: float = DEFAULT_MAX_WAIT_US,
                 collator: Optional[Collator] = None,
                 registry=None):
        self._registry = registry
        if registry is not None:
            if batcher is not None or collator is not None:
                raise ValueError(
                    "registry= and batcher=/collator= are mutually "
                    "exclusive — the registry owns the tenant stacks")
        else:
            if batcher is None:
                raise ValueError("HttpFrontDoor needs a batcher "
                                 "or a registry")
            self._batcher = batcher
            self._collator = collator or Collator(
                batcher, max_wait_us=max_wait_us)
        self.rollover = None     # a RolloverCoordinator, or 400
        self.host = host
        self.port = int(port)
        self.served = 0          # responses written (errors included)
        self.inflight = 0        # requests being handled
        self.aborted_connections = 0  # abandoned at the drain timeout
        self.t_start = time.monotonic()
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.prewarm_info: Optional[dict] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._conn_tasks: set = set()
        self._draining: Optional[asyncio.Event] = None
        self._drained: Optional[asyncio.Event] = None

    # --- default-tenant views -------------------------------------------------
    # with a registry, door.batcher / door.collator read and write the
    # default tenant's stack (the rollover's flip keeps working)

    @property
    def batcher(self) -> RequestBatcher:
        if self._registry is not None:
            return self._registry.default.batcher
        return self._batcher

    @batcher.setter
    def batcher(self, b: RequestBatcher) -> None:
        if self._registry is not None:
            self._registry.default.batcher = b
        else:
            self._batcher = b

    @property
    def collator(self) -> Collator:
        if self._registry is not None:
            return self._registry.default.collator
        return self._collator

    @collator.setter
    def collator(self, c: Collator) -> None:
        if self._registry is not None:
            self._registry.default.collator = c
        else:
            self._collator = c

    @property
    def registry(self):
        return self._registry

    # --- lifecycle ------------------------------------------------------------

    async def start(self) -> tuple[str, int]:
        self.loop = asyncio.get_running_loop()
        self._draining = asyncio.Event()
        self._drained = asyncio.Event()
        self._server = await asyncio.start_server(
            self._on_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.host, self.port

    async def serve_until_drained(self) -> None:
        """Install SIGTERM → drain (where a handler can install) and
        block until the drain finishes."""
        loop = asyncio.get_running_loop()
        installed = False
        try:
            loop.add_signal_handler(
                signal.SIGTERM, lambda: asyncio.ensure_future(self.drain()))
            installed = True
        except (NotImplementedError, RuntimeError, ValueError):
            pass  # not the main thread: no drain hook
        try:
            await self._drained.wait()
        finally:
            if installed:
                loop.remove_signal_handler(signal.SIGTERM)

    async def drain(self, timeout_s: float = 30.0) -> None:
        """Graceful shutdown: refuse new connections, flush the pending
        buckets, answer every in-flight request (its dispatch on the
        executor is awaited, never cancelled), close idle connections,
        release the executor.  Idempotent."""
        if self._draining.is_set():
            await self._drained.wait()
            return
        self._draining.set()
        self._server.close()          # the listener stops accepting
        for coll in ([s.collator for s in self._registry.tenants()]
                     if self._registry is not None else [self.collator]):
            coll.flush_all()
        if self._conn_tasks:
            _done, pending = await asyncio.wait(self._conn_tasks,
                                                timeout=timeout_s)
            self.aborted_connections = len(pending)
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(self._server.wait_closed(), 1.0)
        # every answered dispatch has returned; wait=False keeps a
        # straggler (an abandoned connection's) off the event loop
        if self._registry is not None:
            self._registry.close(wait=False)
        else:
            self.collator.close(wait=False)
        if self.batcher.recorder is not None:
            self.batcher.recorder.dump("sigterm_drain", _cls="drain",
                                       wait=True)
        self._drained.set()

    @property
    def draining(self) -> bool:
        return self._draining is not None and self._draining.is_set()

    # --- connection handling --------------------------------------------------

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        try:
            while not self._draining.is_set():
                read = asyncio.ensure_future(self._read_request(reader))
                drainw = asyncio.ensure_future(self._draining.wait())
                # race the next request against drain: a SIGTERM while
                # this connection idles must not wait for the client's
                # next request (the stdin loop's select-poll analog,
                # event-driven instead of polled)
                done, _ = await asyncio.wait(
                    {read, drainw},
                    return_when=asyncio.FIRST_COMPLETED)
                drainw.cancel()
                if read not in done:
                    read.cancel()
                    with contextlib.suppress(
                            asyncio.CancelledError, Exception):
                        await read  # join the cancelled read
                    break
                try:
                    req = read.result()
                except _TooLarge as e:
                    # framing failures feed the same error accounting
                    # as body-level ones: a storm of oversized/garbled
                    # HTTP must tick serve/errors, the window's error
                    # rate, and the flight recorder's burst detector
                    self._framing_access("validation")
                    await self._write_response(
                        writer, 413,
                        {"error": {"kind": "validation",
                                   "message": str(e)}},
                        close=True)
                    break
                except _BadRequest as e:
                    self._framing_access("parse")
                    await self._write_response(
                        writer, 400,
                        {"error": {"kind": "parse", "message": str(e)}},
                        close=True)
                    break
                except (ConnectionError, asyncio.IncompleteReadError):
                    break  # peer went away mid-request
                if req is None:
                    break  # clean EOF between requests
                self.inflight += 1
                try:
                    status, payload = await self._route(req)
                finally:
                    self.inflight -= 1
                close = req.close or self._draining.is_set()
                await self._write_response(writer, status, payload,
                                           close=close,
                                           request_id=req.request_id)
                if close:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # peer reset under our feet: nothing left to answer
        finally:
            self._conn_tasks.discard(task)
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    @staticmethod
    async def _read_line(reader) -> bytes:
        """One protocol line; a line past the StreamReader's buffer
        limit (64 KiB default) surfaces as ValueError — mapped onto
        the 400 path, never an unhandled task death (the 'exactly one
        response per request' contract covers hostile lines too)."""
        try:
            return await reader.readline()
        except ValueError as e:  # LimitOverrunError → ValueError
            raise _BadRequest(f"protocol line too long ({e})") from None

    async def _read_request(self, reader) -> Optional[_Request]:
        line = await self._read_line(reader)
        if not line:
            return None
        t_in = time.perf_counter()  # socket-in: the deadline origin
        parts = line.decode("latin-1").strip().split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/"):
            raise _BadRequest(f"malformed request line: {line[:80]!r}")
        method, target, version = parts
        headers = {}
        while True:
            h = await self._read_line(reader)
            if h in (b"\r\n", b"\n", b""):
                break
            if len(headers) >= MAX_HEADERS:
                # a protocol-level failure, not an oversized payload:
                # 400, like any other unparseable-request shape
                raise _BadRequest(f"more than {MAX_HEADERS} headers")
            name, sep, val = h.decode("latin-1").partition(":")
            if sep:
                headers[name.strip().lower()] = val.strip()
        body = b""
        cl = headers.get("content-length")
        if cl is not None:
            try:
                n = int(cl)
            except ValueError:
                raise _BadRequest(
                    f"bad Content-Length: {cl!r}") from None
            if n < 0:
                raise _BadRequest(f"negative Content-Length {n}")
            if n > MAX_BODY_BYTES:
                raise _TooLarge(
                    f"Content-Length {n} > {MAX_BODY_BYTES} cap")
            if n:
                body = await reader.readexactly(n)
        close = (headers.get("connection", "").lower() == "close"
                 or version == "HTTP/1.0")
        return _Request(method, target, headers, body, t_in, close)

    # --- routing --------------------------------------------------------------

    def _framing_access(self, outcome: str) -> None:
        """Error-account an HTTP framing failure (no parsed request)."""
        self.batcher.emit_synthetic_access("none", outcome=outcome)

    def _serve_access(self, req: _Request, route: str,
                      outcome: str) -> None:
        """Access-log a serve-op failure that never reached the collator
        (the collator and batcher log everything past their entry)."""
        self.batcher.emit_synthetic_access(
            route, request_id=req.request_id, outcome=outcome,
            t_enq=req.t_in)

    @staticmethod
    def _query_tenant(query: str) -> Optional[str]:
        """The ``?tenant=`` selector of the scrape routes."""
        if not query:
            return None
        vals = urllib.parse.parse_qs(query).get("tenant")
        return vals[-1] if vals else None

    async def _route(self, req: _Request) -> tuple[int, dict]:
        target, _, query = req.target.partition("?")
        if target == "/healthz":
            if req.method != "GET":
                return 405, {"error": {"kind": "validation",
                                       "message": "/healthz wants GET"}}
            try:
                return self._healthz(self._query_tenant(query))
            except ServeError as e:   # an unknown ?tenant= → 404
                err = error_response(e)
                return _STATUS_BY_KIND[err["error"]["kind"]], err
        if target == "/metrics":
            if req.method != "GET":
                return 405, {"error": {"kind": "validation",
                                       "message": "/metrics wants GET"}}
            return 200, _TextPayload(render_prometheus())
        if target == "/v1/stats":
            if req.method not in ("GET", "POST"):
                return 405, {"error": {"kind": "validation",
                                       "message":
                                       "/v1/stats wants GET or POST"}}
            try:
                return 200, self._stats(self._query_tenant(query))
            except ServeError as e:   # an unknown ?tenant= → 404
                err = error_response(e)
                return _STATUS_BY_KIND[err["error"]["kind"]], err
        if target not in ("/v1/topk", "/v1/score", "/v1/upsert",
                          "/v1/delete", "/admin/rollover"):
            self._serve_access(req, "none", "validation")
            return 404, {"error": {"kind": "validation",
                                   "message": f"no route {target!r}"}}
        route = target.rsplit("/", 1)[-1]
        if req.method != "POST":
            self._serve_access(req, route, "validation")
            return 405, {"error": {"kind": "validation",
                                   "message": f"{target} wants POST"}}
        entered = [False]  # past this flag, the collator owns the log
        try:
            try:
                body = json.loads(req.body.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                self._serve_access(req, route, "parse")
                return 400, {"error": {"kind": "parse",
                                       "message": str(e)}}
            if not isinstance(body, dict):
                raise ValueError(
                    f"request body must be a JSON object, got "
                    f"{type(body).__name__}")
            if target == "/admin/rollover":
                if self.rollover is None:
                    raise ValueError(
                        "no rollover coordinator armed on this server "
                        "(serve-http arms one when it can rebuild from "
                        "an artifact)")
                dest = body.get("target")
                if not isinstance(dest, str) or not dest:
                    raise ValueError(
                        "rollover needs \"target\": a non-empty "
                        "artifact path string")
                # the standby builds off the loop; the flip is one loop
                # step, and in-flight requests answer from the old stack
                resp = await self.rollover.rollover(dest)
            elif self._registry is not None:
                stack = self._registry.resolve(body.get("tenant"))
                # a paged-out tenant is re-admitted (coalesced, on the
                # paging executor) before its dispatch
                await self._registry.ensure_resident(stack)
                async with self._registry.using(stack):
                    resp = await self._serve_op(target, route, body, req,
                                                stack.collator, entered)
            else:
                tenant = body.get("tenant")
                if tenant is not None:
                    if not isinstance(tenant, str) or not tenant:
                        raise ValueError(
                            "tenant must be a non-empty string, "
                            f"got {tenant!r}")
                    if tenant != self.batcher.engine.fingerprint:
                        raise UnknownTenantError(tenant)
                resp = await self._serve_op(target, route, body, req,
                                            self.collator, entered)
        except _REQUEST_ERRORS as e:
            # an IO fault or a kernel that failed to build or launch
            # answers 500 and the server survives
            err = error_response(e)
            if not entered[0]:
                self._serve_access(req, route, err["error"]["kind"])
            return _STATUS_BY_KIND[err["error"]["kind"]], err
        return 200, resp

    async def _serve_op(self, target: str, route: str, body: dict,
                        req: _Request, coll: Collator,
                        entered: list) -> dict:
        """One serve op against the resolved tenant's collator."""
        if target == "/v1/topk":
            exclude_self = _json_bool(body, "exclude_self", True)
            deadline_ms = _req_deadline(body)
            entered[0] = True
            with spans.request(route, req.request_id):
                idx, dist = await coll.topk(
                    body.get("ids"), body.get("k", 10),
                    exclude_self=exclude_self, deadline_ms=deadline_ms,
                    t_enq=req.t_in, request_id=req.request_id)
                return {"neighbors": idx.tolist(), "dists": dist.tolist()}
        if target == "/v1/score":
            prob = _json_bool(body, "prob", False)
            fd_r = _req_number(body, "fd_r", 2.0)
            fd_t = _req_number(body, "fd_t", 1.0)
            deadline_ms = _req_deadline(body)
            entered[0] = True
            with spans.request(route, req.request_id):
                scores = await coll.score(
                    body.get("u"), body.get("v"), prob=prob, fd_r=fd_r,
                    fd_t=fd_t, deadline_ms=deadline_ms, t_enq=req.t_in,
                    request_id=req.request_id)
                return {"scores": scores.tolist()}
        deadline_ms = _req_deadline(body)
        entered[0] = True
        with spans.request(route, req.request_id):
            if target == "/v1/upsert":
                return await coll.upsert(
                    body.get("ids"), body.get("rows"),
                    deadline_ms=deadline_ms, t_enq=req.t_in,
                    request_id=req.request_id)
            return await coll.delete(
                body.get("ids"), deadline_ms=deadline_ms, t_enq=req.t_in,
                request_id=req.request_id)

    def _healthz(self, tenant_key: Optional[str] = None
                 ) -> tuple[int, dict]:
        """The load balancer's body: ok, uptime, version, and which
        artifact and program answer (503 + ``ok: false`` draining).  With
        a registry: a per-tenant summary list, or one tenant's summary
        under ``?tenant=`` (its identity captured at build, so a
        paged-out tenant answers without a rebuild)."""
        ok = not self._draining.is_set()
        if self._registry is not None:
            out = {"ok": ok, "draining": not ok,
                   "uptime_s": round(time.monotonic() - self.t_start, 3),
                   "version": hyperspace_torch.__version__}
            if tenant_key is not None:
                out.update(self._registry.resolve(tenant_key).summary())
            else:
                d = self._registry.default
                out["fingerprint"] = d.fingerprint
                out["tenant"] = d.name
                out["tenants"] = [s.summary()
                                  for s in self._registry.tenants()]
            return (200 if ok else 503), out
        if tenant_key is not None and (
                tenant_key != self.batcher.engine.fingerprint):
            raise UnknownTenantError(tenant_key)
        eng = self.batcher.engine
        return (200 if ok else 503), {
            "ok": ok,
            "draining": not ok,
            "uptime_s": round(time.monotonic() - self.t_start, 3),
            "version": hyperspace_torch.__version__,
            "fingerprint": eng.fingerprint,
            "scan_signature": list(eng.scan_signature),
            "precision": eng.precision,
            "degrade_level": self.batcher.degrade_level,
            "generation": getattr(eng, "generation", None),
        }

    def _stats(self, tenant_key: Optional[str] = None) -> dict:
        if self._registry is not None:
            tenants = self._registry.stats()
            if tenant_key is not None:
                out = dict(tenants[self._registry.resolve(tenant_key).name])
            else:
                out = dict(tenants[self._registry.default.name])
                out["tenants"] = tenants
        else:
            out = dict(self.batcher.stats())
        out["server"] = {"served": self.served,
                         "inflight": self.inflight,
                         "draining": self.draining,
                         "max_wait_us": round(
                             self.collator.max_wait_s * 1e6, 1)}
        out["collator_flushes"] = telem.default_registry().get(
            "serve/collator_flushes")
        return out

    # --- response write -------------------------------------------------------

    async def _write_response(self, writer, status: int, payload,
                              *, close: bool,
                              request_id: Optional[str] = None) -> None:
        if isinstance(payload, _TextPayload):
            body = str(payload).encode("utf-8")
            ctype = payload.content_type
        else:
            body = json.dumps(payload,
                              default=_json_default).encode("utf-8")
            ctype = "application/json"
        rid = (f"X-Request-Id: {request_id}\r\n"
               if request_id is not None else "")
        head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n{rid}"
                f"Connection: {'close' if close else 'keep-alive'}\r\n"
                "\r\n").encode("latin-1")
        writer.write(head + body)
        await writer.drain()
        self.served += 1
        telem.inc("serve/http_requests")



def latency_summary_line(baseline: Optional[dict] = None) -> str:
    """One-line ``serve/e2e_ms`` summary (count and p50/p95/p99),
    optionally as a delta over a registry ``mark()``."""
    snap = telem.default_registry().snapshot(baseline=baseline)
    lat = snap.get("hist/serve/e2e_ms")
    if not lat or not lat.get("count"):
        return "[serve] latency e2e_ms: no requests"
    return ("[serve] latency e2e_ms count=%d p50=%.3f p95=%.3f p99=%.3f"
            % (lat["count"], lat["p50"], lat["p95"], lat["p99"]))


async def run_front_door(batcher: Optional[RequestBatcher] = None, *,
                         host: str, port: int,
                         max_wait_us: float = DEFAULT_MAX_WAIT_US,
                         ready=None, prewarm_ks=None,
                         rollover_builder=None, registry=None) -> dict:
    """Prewarm, start, announce, serve until drained, summarize.

    ``prewarm_ks`` launches the whole bucket ladder on the dispatch
    thread before the listener opens (deliberately blocking: nothing
    listens yet), so no request ever meets a kernel build; with a
    registry, every resident tenant's.  ``ready(door)`` is called once
    the listener is bound (``door.host``, ``door.port``; in-process
    callers drain it on ``door.loop``).  ``rollover_builder(target)`` (a
    blocking callable returning a standby :class:`RequestBatcher`) arms
    ``POST /admin/rollover``, the standby prewarmed over the same
    ``prewarm_ks``.  ``registry=`` serves every tenant of an
    :class:`~hyperspace_torch.serve.registry.EngineRegistry` instead of
    one batcher.  Returns the closing counts."""
    door = HttpFrontDoor(batcher, host=host, port=port,
                         max_wait_us=max_wait_us, registry=registry)
    # the door owns the batcher: after a rollover's flip nothing here may
    # keep the old engine's tensors alive
    del batcher
    if rollover_builder is not None:
        from hyperspace_torch.serve.rollover import RolloverCoordinator

        door.rollover = RolloverCoordinator(
            door, rollover_builder, prewarm_ks=prewarm_ks or None)
    session_mark = telem.default_registry().mark()
    if prewarm_ks:
        if registry is not None:
            infos = registry.prewarm(prewarm_ks)
            info = door.prewarm_info = {
                "programs": sum(i["programs"] for i in infos.values()),
                "seconds": sum(i["seconds"] for i in infos.values()),
                "tenants": infos}
        else:
            info = door.prewarm_info = door.collator.prewarm(prewarm_ks)
        with contextlib.suppress(OSError, ValueError):
            print(f"[serve-http] prewarmed {info['programs']} "
                  f"program(s) in {info['seconds']:.2f}s",
                  file=sys.stderr, flush=True)
    try:
        await door.start()
    except BaseException:
        if registry is not None:
            registry.close(wait=False)
        else:
            door.collator.close(wait=False)
        raise
    if ready is not None:
        ready(door)
    await door.serve_until_drained()
    with contextlib.suppress(OSError, ValueError):
        print(f"[serve-http] drained: stopped accepting, "
              f"{door.served} response(s) sent", file=sys.stderr,
              flush=True)
        if door.aborted_connections:
            print(f"[serve-http] WARNING: {door.aborted_connections} "
                  "connection(s) still in flight at the drain timeout "
                  "were abandoned", file=sys.stderr, flush=True)
        print(latency_summary_line(session_mark), file=sys.stderr,
              flush=True)
    return {"served": door.served, "drained": True,
            "aborted_connections": door.aborted_connections}

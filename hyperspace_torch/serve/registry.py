"""Multi-tenant engine registry: one front door, many artifacts
(counterpart of ``hyperspace_tpu/serve/registry.py``).

- :class:`TenantStack` — one tenant's serving stack: its artifact (the
  host-resident master copy), its
  :class:`~hyperspace_torch.serve.engine.QueryEngine` (device tables,
  possibly paged out), a persistent
  :class:`~hyperspace_torch.serve.batcher.RequestBatcher` (tenant-tagged
  cache, admission, degradation ladder, per-tenant
  :class:`~hyperspace_torch.telemetry.window.SloWindow`) and a
  :class:`~hyperspace_torch.serve.collator.Collator` on the registry's
  shared dispatch executor.
- :class:`EngineRegistry` — routes a request's ``tenant`` field (a
  tenant name or an artifact fingerprint; absent = the default tenant)
  to its stack, schedules the shared one-worker dispatch executor through
  a :class:`~hyperspace_torch.serve.collator.FairDispatcher` (weighted
  deficit round robin), and **pages whole engines** under a device
  budget (``device_budget_mb=``).

**Engine paging.**  The artifact on disk is the master copy; the device
tables are a cache.  Past the budget, the least recently used idle
tenant's engine is dropped (``batcher.engine = None``): its tensors go
back to PyTorch's caching allocator, so ``memory_allocated`` falls and
``memory_reserved`` does not, and nothing on the serving path empties
the cache.  A dropped tenant is rebuilt on demand on a one-worker
**paging executor**, off the dispatch executor, its new engine synced
on the card before it serves; the rebuild and the prewarm of its bucket
ladder are coalesced (concurrent requests for one cold tenant await one
admission).  The prewarm launches kernels this process has already
built and loaded, so a re-admission builds and loads nothing.  The
batcher persists across paging: its cache is keyed by fingerprint and
scan signature, so a re-admitted engine from the same artifact serves
cached rows unchanged, and its ladder, window and cold-dispatch record
survive.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from hyperspace_torch.serve.batcher import RequestBatcher
from hyperspace_torch.serve.collator import (DEFAULT_MAX_WAIT_US, Collator,
                                             FairDispatcher)
from hyperspace_torch.serve.engine import QueryEngine
from hyperspace_torch.serve.errors import UnknownTenantError
from hyperspace_torch.telemetry import registry as telem
from hyperspace_torch.telemetry.exposition import tenant_metric

# the engine tensors that hold its device memory
_ENGINE_TENSORS = ("table", "scan_table", "scan_scale", "pq_codebooks",
                   "_centroids", "_cells", "_cols")


def engine_device_bytes(engine) -> int:
    """Device bytes an engine's tables hold — the paging budget's unit:
    the table, the lane's scan copy and scales, the PQ codebooks, the IVF
    centroids and cells and the column ids, each storage counted once
    (``scan_table`` aliases ``table`` on the f32 lane; a view has an id
    of its own but its storage's address)."""
    total = 0
    seen: set = set()
    for name in _ENGINE_TENSORS:
        t = getattr(engine, name, None)
        if t is None or not hasattr(t, "untyped_storage"):
            continue
        st = t.untyped_storage()
        key = (str(t.device), st.data_ptr())
        if key in seen:
            continue
        seen.add(key)
        total += int(st.nbytes())
    return total


def _twrite(write, name: str, tenant, value) -> None:
    """One base + tenant-twin registry write."""
    write(name, value)
    if tenant:
        write(tenant_metric(name, tenant), value)


class TenantStack:
    """One tenant's serving stack (module docstring), built and owned by
    :class:`EngineRegistry`; its mutable state (residency, inflight,
    last use) is touched on the event loop only."""

    __slots__ = ("name", "artifact", "art", "weight", "batcher",
                 "collator", "engine_kw", "fingerprint", "scan_signature",
                 "precision", "device_bytes", "resident", "last_use",
                 "inflight", "admit_future", "admissions", "evictions")

    def __init__(self, name: str, artifact: str, art, weight: float,
                 engine_kw: dict):
        self.name = name
        self.artifact = artifact      # path: the host-resident master
        self.art = art                # the loaded ServingArtifact
        self.weight = float(weight)
        self.engine_kw = dict(engine_kw)
        self.batcher: Optional[RequestBatcher] = None
        self.collator: Optional[Collator] = None
        # identity captured at build: /healthz of a paged-out tenant
        # answers without a rebuild
        self.fingerprint: Optional[str] = None
        self.scan_signature: Optional[tuple] = None
        self.precision: Optional[str] = None
        self.device_bytes = 0         # last known resident footprint
        self.resident = False
        self.last_use = 0             # registry use sequence (LRU order)
        self.inflight = 0             # requests inside using() brackets
        self.admit_future: Optional[asyncio.Future] = None
        self.admissions = 0
        self.evictions = 0

    def summary(self) -> dict:
        """The per-tenant block /healthz and /v1/stats carry."""
        return {
            "tenant": self.name,
            "resident": self.resident,
            "weight": self.weight,
            "fingerprint": self.fingerprint,
            "scan_signature": (list(self.scan_signature)
                               if self.scan_signature else None),
            "precision": self.precision,
            "device_bytes": self.device_bytes if self.resident else 0,
            "degrade_level": (self.batcher.degrade_level
                              if self.batcher is not None else 0),
            "inflight": self.inflight,
            "admissions": self.admissions,
            "evictions": self.evictions,
        }


class EngineRegistry:
    """Tenant routing + weighted-fair dispatch + engine paging.

    Construct, :meth:`add_tenant` each artifact (the first is the
    default: requests without a ``tenant`` field route there), then hand
    the registry to :class:`~hyperspace_torch.serve.server.HttpFrontDoor`.
    After construction everything mutates on the event loop;
    :meth:`add_tenant` and :meth:`prewarm` are blocking set-up calls made
    before the listener opens."""

    def __init__(self, *, device_budget_mb: float = 0.0,
                 max_wait_us: float = DEFAULT_MAX_WAIT_US,
                 quantum: int = 8, prewarm_ks=()):
        if device_budget_mb < 0:
            raise ValueError(
                f"device_budget_mb must be >= 0; got {device_budget_mb}")
        self.device_budget_bytes = int(device_budget_mb * (1 << 20))
        self.max_wait_us = float(max_wait_us)
        self.prewarm_ks = tuple(prewarm_ks)
        self._stacks: dict[str, TenantStack] = {}
        self._by_fp: dict[str, TenantStack] = {}
        self._default: Optional[TenantStack] = None
        # the one dispatch executor every tenant's device work rides
        self._exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-dispatch")
        # engine rebuilds and their prewarms, off the dispatch executor
        self._pager = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-pager")
        self.dispatcher = FairDispatcher(self._exec, quantum=quantum)
        self._use_seq = 0
        self._admits: set = set()   # admission tasks in flight
        self._closed = False
        self._build_lock = threading.Lock()

    # --- construction ---------------------------------------------------------

    def add_tenant(self, name: str, artifact: str, *,
                   weight: float = 1.0, window_s: float = 60.0,
                   engine_kw: Optional[dict] = None,
                   batcher_kw: Optional[dict] = None) -> TenantStack:
        """Register one tenant: load its artifact, build its engine (the
        fingerprint must route at once), and assemble its batcher and
        collator.  ``engine_kw`` goes to :meth:`QueryEngine.from_artifact`
        (precision, scan_mode, nprobe, chunk_rows, device), ``batcher_kw``
        to :class:`RequestBatcher`.  Raises ``ValueError`` on an empty
        or duplicate name and on a weight <= 0."""
        from hyperspace_torch.serve.artifact import load_artifact

        if not name:
            raise ValueError("tenant name must be non-empty")
        if weight <= 0:
            raise ValueError(
                f"tenant {name!r}: weight must be > 0; got {weight}")
        with self._build_lock:
            if name in self._stacks:
                raise ValueError(f"duplicate tenant {name!r}")
            art = load_artifact(artifact)
            stack = TenantStack(name, artifact, art, weight,
                                engine_kw or {})
            eng = self._build_engine(stack)
            window = None
            if window_s:
                from hyperspace_torch.telemetry.window import SloWindow

                window = SloWindow.for_tenant(name, window_s)
            stack.batcher = RequestBatcher(eng, tenant=name, window=window,
                                           **(batcher_kw or {}))
            stack.collator = Collator(stack.batcher,
                                      max_wait_us=self.max_wait_us,
                                      executor=self._exec,
                                      dispatcher=self.dispatcher,
                                      tenant=name)
            self._note_built(stack, eng)
            stack.resident = True
            self.dispatcher.set_weight(name, weight)
            self._stacks[name] = stack
            self._by_fp[stack.fingerprint] = stack
            if self._default is None:
                self._default = stack
            self._update_resident_gauge()
            # a new tenant may push the resident set past the budget
            self._enforce_budget(keep=stack)
        return stack

    def _build_engine(self, stack: TenantStack):
        """The tenant's engine from its artifact, its tables on the card
        (a sync) before anything serves from it."""
        eng = QueryEngine.from_artifact(stack.art, **stack.engine_kw)
        if eng.device.type == "cuda":
            torch.cuda.current_stream(eng.device).synchronize()
        return eng

    def _note_built(self, stack: TenantStack, eng) -> None:
        stack.fingerprint = eng.fingerprint
        stack.scan_signature = tuple(eng.scan_signature)
        stack.precision = eng.precision
        stack.device_bytes = engine_device_bytes(eng)

    # --- routing --------------------------------------------------------------

    @property
    def default(self) -> TenantStack:
        if self._default is None:
            raise UnknownTenantError(None)
        return self._default

    def tenants(self) -> list[TenantStack]:
        return list(self._stacks.values())

    def resolve(self, key=None) -> TenantStack:
        """The stack a request's ``tenant`` field routes to: None → the
        default tenant, else a tenant name or an artifact fingerprint; an
        unknown key raises :class:`UnknownTenantError` (HTTP 404)."""
        if key is None:
            return self.default
        if not isinstance(key, str) or not key:
            raise ValueError(
                f"tenant must be a non-empty string, got {key!r}")
        stack = self._stacks.get(key) or self._by_fp.get(key)
        if stack is None:
            raise UnknownTenantError(key)
        return stack

    @contextlib.asynccontextmanager
    async def using(self, stack: TenantStack):
        """Request scope: the stack is busy (never an eviction victim)
        and its LRU stamp moves."""
        self._use_seq += 1
        stack.last_use = self._use_seq
        stack.inflight += 1
        try:
            yield stack
        finally:
            stack.inflight -= 1

    # --- engine paging --------------------------------------------------------

    async def ensure_resident(self, stack: TenantStack) -> None:
        """Make the stack's engine resident, rebuilding it from the
        artifact if it was paged out; concurrent callers for one cold
        tenant await the same admission."""
        self._use_seq += 1
        stack.last_use = self._use_seq
        if stack.resident:
            return
        fut = stack.admit_future
        if fut is None:
            loop = asyncio.get_running_loop()
            fut = stack.admit_future = loop.create_future()
            # the loop holds tasks weakly: keep the admission's until done
            task = asyncio.ensure_future(self._admit(stack, fut))
            self._admits.add(task)
            task.add_done_callback(self._admits.discard)
        await fut

    async def _admit(self, stack: TenantStack,
                     fut: asyncio.Future) -> None:
        loop = asyncio.get_running_loop()
        try:
            t0 = time.perf_counter()
            eng = await loop.run_in_executor(
                self._pager, functools.partial(self._build_engine, stack))
            stack.batcher.engine = eng
            self._note_built(stack, eng)
            stack.resident = True
            stack.admissions += 1
            del eng
            if self.prewarm_ks:
                await loop.run_in_executor(
                    self._pager, functools.partial(stack.batcher.prewarm,
                                                   self.prewarm_ks))
            _twrite(telem.inc, "serve/tenant_admissions", stack.name, 1)
            _twrite(telem.inc, "serve/tenant_admit_s", stack.name,
                    time.perf_counter() - t0)
            self._update_resident_gauge()
            # admitting this tenant may displace another idle one
            self._enforce_budget(keep=stack)
            fut.set_result(True)
        except (ValueError, KeyError, TypeError, OSError,
                RuntimeError) as e:
            # every coalesced awaiter gets the typed failure; the next
            # request retries a fresh admission
            fut.set_exception(e)
        finally:
            stack.admit_future = None

    def _evict(self, stack: TenantStack) -> None:
        """Drop the stack's engine; the artifact stays the master and the
        batcher (cache, ladder, window) persists."""
        stack.batcher.engine = None
        stack.resident = False
        stack.evictions += 1
        _twrite(telem.inc, "serve/tenant_evictions", stack.name, 1)
        self._update_resident_gauge()

    def _enforce_budget(self, keep: Optional[TenantStack] = None) -> None:
        """Evict idle LRU stacks until the resident set fits the budget.
        A stack with requests in flight or flushes queued is never a
        victim: with no safe victim the set stays over budget until the
        traffic passes."""
        if not self.device_budget_bytes:
            return
        while True:
            resident = [s for s in self._stacks.values() if s.resident]
            if sum(s.device_bytes
                   for s in resident) <= self.device_budget_bytes:
                return
            queued = self.dispatcher.pending()
            victims = [s for s in resident
                       if s is not keep and s.inflight == 0
                       and not queued.get(s.name)]
            if not victims:
                return
            self._evict(min(victims, key=lambda s: s.last_use))

    def _update_resident_gauge(self) -> None:
        telem.set_gauge(
            "serve/tenants_resident",
            sum(1 for s in self._stacks.values() if s.resident))

    # --- lifecycle / observability --------------------------------------------

    def prewarm(self, ks) -> dict:
        """Warm every resident tenant's bucket ladder on the dispatch
        thread (set-up, before the listener opens); {tenant: info}."""
        out = {}
        for stack in self._stacks.values():
            if stack.resident:
                out[stack.name] = stack.collator.prewarm(list(ks))
        return out

    def stats(self) -> dict:
        """{tenant: batcher stats + registry block}; a paged-out tenant
        carries the registry block only (its batcher stats would need
        the engine)."""
        out = {}
        for stack in self._stacks.values():
            s = (dict(stack.batcher.stats())
                 if stack.resident else {"tenant": stack.name})
            s["registry"] = stack.summary()
            out[stack.name] = s
        return out

    def close(self, wait: bool = True) -> None:
        """Shut the shared executors down; the tenant collators only mark
        themselves closed (they never owned the executor)."""
        if self._closed:
            return
        self._closed = True
        for stack in self._stacks.values():
            if stack.collator is not None:
                stack.collator.close(wait=wait)
        self._exec.shutdown(wait=wait)
        self._pager.shutdown(wait=wait)

"""Process-wide deterministic fault injection (counterpart of
``hyperspace_tpu/resilience/faults.py``).

Faults are named (a test arms exactly the failure it is about),
deterministic (a seeded schedule fires on the same calls every run) and
free when off (a site costs one module-global read).  The port's
sites: ``serve.dispatch`` (``serve/batcher.py``: sleep or raise on the
dispatch thread, before the engine call), ``ckpt.save``
(``train/checkpoint.py``: an ``ioerror`` the save retries, latency, or
``crash_staged``'s debris and a crash that is not retried) and
``train.step_nan`` (``train/loop.py``: every floating tensor of the state
NaN-ed in place after a dispatch) and ``data.next_batch``
(``data/prefetch.py``: an ``ioerror`` or latency in
``HostPrefetcher.next``, on the consumer's side; it fires only on a path
that runs a prefetcher, such as the train CLI's ``host_table=1``).

Kinds: ``ioerror`` raises :class:`InjectedIOError` (an ``IOError``);
``latency`` sleeps ``ms``; ``nan`` makes :func:`poison` return True;
``crash_staged`` raises :class:`InjectedCrash`.

Scheduling: a spec fires on call indices ``after <= i < after + times``
at its site, or, with ``prob`` set, on a seeded Bernoulli stream.  The
stream's seed is an int derived from (seed, site, kind) by
:func:`stream_seed`; JAX passes the tuple to ``random.Random``, which
Python 3.12 refuses, so the two packages' ``prob`` streams differ.
Every armed spec counts into ``fault/armed`` and every fired fault into
``fault/fired``.

CLI grammar (``chaos=`` of both CLIs)::

    chaos=site:kind[:key=value[:key=value...]][,site:kind...]
    chaos=serve.dispatch:latency:ms=50:times=3
    chaos=serve.dispatch:ioerror:prob=0.05

Keys: ``times`` (default 1; 0 = every eligible call), ``after`` (skip
the first N calls), ``ms`` (latency only), ``prob`` (seeded Bernoulli
firing instead of the times/after window).
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
import threading
import time
from typing import Optional

KINDS = ("ioerror", "latency", "nan", "crash_staged")


class InjectedIOError(IOError):
    """A transient injected IO failure (retry loops may absorb it)."""


class InjectedCrash(RuntimeError):
    """An injected process death (retry loops must NOT absorb it)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed fault: where, what, and on which calls it fires."""

    site: str
    kind: str
    times: int = 1       # fire on this many eligible calls (0 = all)
    after: int = 0       # skip the first `after` calls at the site
    ms: float = 0.0      # latency kind: injected delay
    prob: float = 0.0    # >0: seeded Bernoulli instead of the window

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"fault kind must be one of {KINDS}; got {self.kind!r}")
        if self.times < 0 or self.after < 0 or self.ms < 0:
            raise ValueError(f"times/after/ms must be >= 0: {self}")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1]: {self}")


def stream_seed(seed: int, site: str, kind: str) -> int:
    """The int seed of one spec's Bernoulli stream: the first 8 bytes of
    a BLAKE2b digest of ``seed``, ``site`` and ``kind`` joined by NUL.
    Two specs on one site draw independent streams, each reproducible
    for a fixed ``seed``.  (JAX seeds ``random.Random`` with the tuple
    itself, which Python 3.12 refuses.)"""
    text = "\0".join((str(int(seed)), site, kind)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(),
                          "little")


class _Armed:
    """A spec plus its live firing state (calls seen, fires left)."""

    def __init__(self, spec: FaultSpec, seed: int):
        self.spec = spec
        self.calls = 0
        self.fired = 0
        self._rng = random.Random(stream_seed(seed, spec.site, spec.kind))

    def due(self) -> bool:
        i = self.calls
        self.calls += 1
        s = self.spec
        if s.prob > 0.0:
            hit = i >= s.after and self._rng.random() < s.prob
        else:
            hit = s.after <= i and (s.times == 0
                                    or i < s.after + s.times)
        if hit:
            self.fired += 1
        return hit


class _Registry:
    def __init__(self, specs: list[FaultSpec], seed: int):
        self._lock = threading.Lock()
        self._armed = [_Armed(s, seed) for s in specs]
        self._by_site: dict[str, list[_Armed]] = {}
        for a in self._armed:
            self._by_site.setdefault(a.spec.site, []).append(a)

    def due(self, site: str) -> Optional[FaultSpec]:
        armed = self._by_site.get(site)
        if not armed:
            return None
        with self._lock:
            for a in armed:
                if a.due():
                    return a.spec
        return None

    def stats(self) -> dict:
        with self._lock:
            return {
                "sites": sorted(self._by_site),
                "specs": [{"site": a.spec.site, "kind": a.spec.kind,
                           "calls": a.calls, "fired": a.fired}
                          for a in self._armed],
                "fired": sum(a.fired for a in self._armed),
            }


# the one module-global the disabled hot path reads (None = off) — the
# registry analog of the telemetry tracer's shared-nullcontext trick
_REGISTRY: Optional[_Registry] = None


def active() -> bool:
    """True when any fault is armed — THE cheap site guard."""
    return _REGISTRY is not None


def install(specs, *, seed: int = 0) -> None:
    """Arm ``specs`` (replacing any prior set).  Counts every armed
    spec into ``fault/armed``."""
    global _REGISTRY
    specs = list(specs)
    for s in specs:
        if not isinstance(s, FaultSpec):
            raise TypeError(f"want FaultSpec, got {type(s).__name__}")
    if not specs:
        _REGISTRY = None
        return
    _REGISTRY = _Registry(specs, int(seed))
    from hyperspace_torch.telemetry import registry as telem

    telem.inc("fault/armed", len(specs))


def clear() -> None:
    """Disarm everything (tests; end of a chaos run)."""
    global _REGISTRY
    _REGISTRY = None


def due(site: str) -> Optional[FaultSpec]:
    """The consumed-one-firing core: the spec due at this call of
    ``site`` (its ``fault/fired`` already counted), or None.  Callers
    with site-specific interpretations (``ckpt.save``'s crash_staged)
    use this directly; plain sites use :func:`hit` / :func:`poison`."""
    reg = _REGISTRY
    if reg is None:
        return None
    spec = reg.due(site)
    if spec is not None:
        import sys

        from hyperspace_torch.telemetry import registry as telem

        telem.inc("fault/fired")
        # stderr, NOT stdout: the serve loop's stdout is a strict
        # one-response-per-line protocol stream — a diagnostic line
        # there would corrupt a client's JSON parse
        print(f"[faults] fired {spec.kind} at {site}", file=sys.stderr,
              flush=True)
    return spec


def hit(site: str) -> None:
    """Error/latency site: raise :class:`InjectedIOError` or sleep when
    a fault is due; no-op otherwise (and when nothing is armed)."""
    spec = due(site)
    if spec is None:
        return
    if spec.kind == "latency":
        time.sleep(spec.ms / 1e3)
    elif spec.kind == "ioerror":
        raise InjectedIOError(f"injected IOError at {site}")
    else:
        raise InjectedCrash(f"injected {spec.kind} at {site}")


def poison(site: str) -> bool:
    """NaN site: True when THIS call's payload should be poisoned (the
    caller applies the NaN — the registry never touches device data)."""
    spec = due(site)
    return spec is not None and spec.kind == "nan"


def stats() -> dict:
    """Armed/fired detail for diagnostics ({} when nothing is armed)."""
    reg = _REGISTRY
    return {} if reg is None else reg.stats()


def parse_chaos(text: str) -> list[FaultSpec]:
    """Parse the ``chaos=`` CLI grammar (module docstring) into specs.

    Raises ``ValueError`` with a usage-shaped message on any malformed
    entry — the CLIs convert that to a clean ``SystemExit``."""
    specs = []
    for entry in text.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"chaos entry {entry!r}: want site:kind[:key=value...]")
        site, kind = parts[0].strip(), parts[1].strip()
        kw: dict = {}
        for p in parts[2:]:
            if "=" not in p:
                raise ValueError(
                    f"chaos entry {entry!r}: want key=value, got {p!r}")
            k, v = (t.strip() for t in p.split("=", 1))
            if k in ("times", "after"):
                kw[k] = int(v)
            elif k in ("ms", "prob"):
                kw[k] = float(v)
            else:
                raise ValueError(
                    f"chaos entry {entry!r}: unknown key {k!r} "
                    "(want times/after/ms/prob)")
        try:
            specs.append(FaultSpec(site=site, kind=kind, **kw))
        except ValueError as e:
            raise ValueError(f"chaos entry {entry!r}: {e}") from None
    if not specs:
        raise ValueError(f"chaos={text!r}: no fault specs parsed")
    return specs


def install_chaos(text: Optional[str], seed: int = 0) -> bool:
    """CLI helper: parse + install ``chaos=`` (False when unset/empty).

    The two CLIs share this one entry so the grammar and the armed
    counter behave identically for train and serve."""
    if not text:
        return False
    install(parse_chaos(text), seed=seed)
    return True

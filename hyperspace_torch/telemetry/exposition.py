"""Prometheus text exposition of the registry (counterpart of
``hyperspace_tpu/telemetry/exposition.py``): the live scrape plane.

The HTTP front door serves :func:`render_prometheus` at ``GET /metrics``;
:class:`MetricsFileWriter` writes it to a file atomically on a cadence.
The format is the JAX package's, byte for byte:

- names sanitize as ``hyperspace_`` + the registry name with every rune
  outside ``[a-zA-Z0-9_:]`` replaced by ``_``; the original name rides
  the ``# HELP`` line;
- every sample carries a ``process_index`` label (always 0 here: the
  port runs one process) plus the caller's extras;
- counters render as ``counter``, gauges as ``gauge``, histograms as
  Prometheus histograms whose cumulative ``_bucket{le=...}`` lines are
  emitted only where the cumulative count changes (plus each populated
  run's lower edge and ``+Inf``);
- per-tenant names (``serve/e2e_ms@tenant=en``) fold into their base
  family as ``tenant``-labelled samples.
"""

from __future__ import annotations

import os
import re
import time
from typing import Optional

from hyperspace_torch.telemetry.histogram import HistogramSnapshot
from hyperspace_torch.telemetry.registry import Registry, default_registry

PREFIX = "hyperspace_"
_BAD_RUNE_RX = re.compile(r"[^a-zA-Z0-9_:]")

# Per-tenant registry names embed the tenant as a suffix the exposition
# re-renders as a real Prometheus ``tenant`` label: the registry stays a
# flat name→value dict (no label machinery on the hot inc path), while a
# scrape sees one family per BASE name with tenant-labeled samples —
# ``serve/e2e_ms@tenant=en`` joins the ``serve/e2e_ms`` family as
# ``hyperspace_serve_e2e_ms{tenant="en",...}``.  The HELP line carries
# the base name.
TENANT_SEP = "@tenant="


def split_tenant(name: str) -> tuple:
    """``(base_name, tenant_or_None)`` for a registry metric name."""
    base, sep, tenant = name.partition(TENANT_SEP)
    return (base, tenant) if sep else (name, None)


def tenant_metric(name: str, tenant) -> str:
    """The per-tenant twin of registry metric ``name`` (see
    :data:`TENANT_SEP`); ``tenant=None`` returns the base name."""
    return f"{name}{TENANT_SEP}{tenant}" if tenant else name


def sanitize_name(name: str) -> str:
    """Registry name → Prometheus metric family name.

    ``serve/e2e_ms`` → ``hyperspace_serve_e2e_ms``; a leading digit
    after the prefix is fine (the prefix itself starts the name)."""
    return PREFIX + _BAD_RUNE_RX.sub("_", name)


def escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(text: str) -> str:
    return (text.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v) -> str:
    """Sample values: integers render bare (counters stay readable),
    floats via repr at full precision.  Non-finite values render as
    the format's ``NaN``/``+Inf``/``-Inf`` literals — one poisoned
    gauge (or an inf observation's histogram sum) must break that one
    sample's usefulness, never every future scrape."""
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


def _labels_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(str(v))}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def _process_index() -> int:
    """The sample's ``process_index`` label: the port runs one process."""
    return 0


def _hist_lines(san: str, labels: dict, snap: HistogramSnapshot) -> list:
    """Cumulative-bucket lines for one histogram snapshot.

    Bucket ``i`` (1-based within the finite range) spans
    ``[lo*g^(i-1), lo*g^i)``, so the cumulative count at
    ``le = lo*g^i`` includes the underflow bucket plus buckets
    ``1..i``.  Runs of edges where the cumulative count does not
    change are compressed to their LAST edge — the one immediately
    below the next populated bucket — so every emitted bucket keeps
    its true lower bound (PromQL's ``histogram_quantile`` interpolates
    linearly inside a bucket: dropping the lower-bound edge would
    stretch the bucket down to the previously emitted edge and pull
    quantile estimates far below the scheme's ~4.9 % error bound).
    Cumulative monotonicity and totals are preserved exactly; a live
    histogram emits ≤ 2 lines per populated run instead of ~285."""
    out = []

    def emit(i: int, c: int) -> None:
        edge = snap.lo * snap.growth ** i
        lab = dict(labels, le=f"{edge:.6g}")
        out.append(f"{san}_bucket{_labels_str(lab)} {c}")

    n = len(snap.counts) - 2
    cum = snap.counts[0]
    last_emitted = 0  # bucket-edge index of the last emitted line
    for i in range(1, n + 1):
        new_cum = cum + snap.counts[i]
        if new_cum != cum:
            if i - 1 >= 1 and last_emitted != i - 1:
                emit(i - 1, cum)  # the populated bucket's lower bound
            emit(i, new_cum)
            last_emitted = i
        cum = new_cum
    lab = dict(labels, le="+Inf")
    out.append(f"{san}_bucket{_labels_str(lab)} {snap.count}")
    out.append(f"{san}_sum{_labels_str(labels)} {_fmt(snap.sum)}")
    out.append(f"{san}_count{_labels_str(labels)} {snap.count}")
    return out


def render_prometheus(registry: Optional[Registry] = None,
                      labels: Optional[dict] = None) -> str:
    """The whole registry as Prometheus text (module docstring).

    ``labels`` are extra labels on every sample; ``process_index`` is
    always present (the caller's value wins).  Families render in
    sorted registry-name order, so two scrapes of an idle process are
    byte-identical."""
    reg = default_registry() if registry is None else registry
    return render_export(*reg.export(), labels=labels)


def render_export(counters: dict, gauges: dict, hists: dict,
                  labels: Optional[dict] = None) -> str:
    """Render one raw ``Registry.export()`` tuple as Prometheus text —
    the registry-free half of :func:`render_prometheus`."""
    base = {"process_index": str(_process_index())}
    if labels:
        base.update({str(k): str(v) for k, v in labels.items()})
    lines: list[str] = []

    def _families(entries: dict) -> list:
        """[(base_name, [(labels, value), ...])] — tenant-suffixed names
        fold into their base family as tenant-labeled samples; within a
        family the unlabeled sample sorts first, tenants alphabetically
        (sorted() on the suffixed names gives exactly that order)."""
        fams: dict = {}
        for name in sorted(entries):
            bname, tenant = split_tenant(name)
            lab = dict(base, tenant=tenant) if tenant else base
            fams.setdefault(bname, []).append((lab, entries[name]))
        return sorted(fams.items())

    for name, samples in _families(counters):
        san = sanitize_name(name)
        lines.append(f"# HELP {san} {escape_help(name)}")
        lines.append(f"# TYPE {san} counter")
        for lab, v in samples:
            lines.append(f"{san}{_labels_str(lab)} {_fmt(v)}")
    for name, samples in _families(gauges):
        san = sanitize_name(name)
        lines.append(f"# HELP {san} {escape_help(name)}")
        lines.append(f"# TYPE {san} gauge")
        for lab, v in samples:
            lines.append(f"{san}{_labels_str(lab)} {_fmt(v)}")
    for name, samples in _families(hists):
        san = sanitize_name(name)
        lines.append(f"# HELP {san} {escape_help(name)}")
        lines.append(f"# TYPE {san} histogram")
        for lab, snap in samples:
            lines.extend(_hist_lines(san, lab, snap))
    return "\n".join(lines) + "\n"


class MetricsFileWriter:
    """Periodic exposition-to-file snapshotter.

    ``maybe_write()`` costs one ``time.monotonic`` read until the
    cadence expires, then renders and writes ATOMICALLY (temp file +
    rename in the target directory) — a scraper's textfile collector
    never reads a torn snapshot.  ``write()`` forces one (run end —
    the final counters must land whatever the cadence)."""

    def __init__(self, path: str, every_s: float = 30.0, *,
                 registry: Optional[Registry] = None,
                 labels: Optional[dict] = None):
        if every_s <= 0:
            raise ValueError(f"metrics_every must be > 0; got {every_s}")
        self.path = path
        self.every_s = float(every_s)
        self._registry = registry
        self._labels = labels
        self.writes = 0
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._next = time.monotonic()  # first maybe_write() emits

    def maybe_write(self) -> bool:
        if time.monotonic() < self._next:
            return False
        self.write()
        return True

    def write(self) -> None:
        self._next = time.monotonic() + self.every_s
        text = render_prometheus(self._registry, labels=self._labels)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, self.path)
        self.writes += 1

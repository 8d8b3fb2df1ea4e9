"""Thread-safe metrics registry: Counter / Gauge / Histogram families.

Before this module, every serving component owned its own ad-hoc
counters (``InferenceEngine._n_requests``, ``StepScheduler._n_steps``,
``WholeSequenceScheduler._n_batches`` — all different names for the
same ideas) and the only way to read them was each component's private
``stats()`` dict. Clipper (NSDI '17) and Orca (OSDI '22) treat the
serving system's signal surface as a first-class output; this registry
is that layer for the serving stack: one namespace of labeled metric
families (``serve_batch_latency_seconds{family,profile,class}``) every
engine registers into, rendered in Prometheus text exposition format by
:func:`render_prometheus` (the ``GET /metrics`` endpoint) and re-read
by each engine's ``stats()`` — the dicts stay API-compatible but their
counters are now registry instruments.

Design constraints, in order:

* **Hot-path cheap.** A serving dispatch bumps ~6 counters; each bump
  is one short ``threading.Lock`` acquire + float add — the same cost
  as the per-engine stats locks it replaces. Children (one labeled
  instrument) are resolved ONCE at engine construction, never per
  request.
* **Pull-model gauges.** Values that already live somewhere (queue
  depth, slot occupancy, executable-cache size) are registered as
  callback gauges and read at collect time — no push bookkeeping on
  the hot path, no staleness.
* **Per-engine registries + one process-global.** Each engine owns a
  registry (tests and multi-engine processes never cross-pollute);
  process-wide signals (resilience fault-point fires) land in
  :func:`global_registry` and ``/metrics`` renders both.

Histograms use fixed log-spaced latency buckets (100 µs × 2ⁿ up to
~26 s) so bucket boundaries are identical across every engine and
profile — per-stage latency attribution compares like for like.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Callable, Iterable, Sequence

# Fixed log-spaced latency buckets (seconds): 100 µs · 2^n, n = 0..17
# (~26 s top bucket). One table for every latency histogram in the repo
# so /metrics quantiles compare across engines, profiles and versions.
LATENCY_BUCKETS: tuple[float, ...] = tuple(
    1e-4 * (2.0 ** i) for i in range(18))

_VALID_KINDS = ("counter", "gauge", "histogram")


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare (the common case
    for counters), floats via repr, non-finite per the text format."""
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(float(v))


def escape_help(text: str) -> str:
    r"""HELP line escaping per the exposition format: ``\`` and newline."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(text: str) -> str:
    r"""Label value escaping: ``\``, ``"`` and newline."""
    return (text.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class _Child:
    """One labeled instrument (a (family, label-values) pair). All
    mutation goes through the owning registry's lock — cheap, and it
    makes cross-field reads (histogram sum + count) consistent."""

    __slots__ = ("_lock", "value", "_fn", "_buckets", "bucket_counts",
                 "sum", "count")

    def __init__(self, lock: threading.Lock,
                 buckets: Sequence[float] | None = None):
        self._lock = lock
        self.value = 0.0
        self._fn: Callable[[], float] | None = None
        self._buckets = buckets
        if buckets is not None:
            self.bucket_counts = [0] * len(buckets)
            self.sum = 0.0
            self.count = 0

    # -- counter / gauge -------------------------------------------------
    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Pull-model gauge: ``fn`` is read at collect time (never on a
        serving hot path). The callback must be cheap and thread-safe."""
        self._fn = fn

    def get(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a dead callback reads 0
                return 0.0
        with self._lock:
            return self.value

    # -- histogram -------------------------------------------------------
    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.sum += value
            self.count += 1
            i = bisect.bisect_left(self._buckets, value)
            if i < len(self.bucket_counts):
                self.bucket_counts[i] += 1

    def observe_many(self, values: Sequence[float]) -> None:
        """Bulk observe under ONE lock acquire — the serving hot path
        records a whole micro-batch's request latencies in one call."""
        if not values:
            return
        buckets = self._buckets
        nb = len(buckets)
        with self._lock:
            counts = self.bucket_counts
            for v in values:
                v = float(v)
                self.sum += v
                i = bisect.bisect_left(buckets, v)
                if i < nb:
                    counts[i] += 1
            self.count += len(values)

    def snapshot_hist(self) -> tuple[list[int], float, int]:
        """(CUMULATIVE bucket counts, sum, count) under the lock — the
        rendering-side view (internal storage is per-bucket)."""
        with self._lock:
            cum = []
            running = 0
            for c in self.bucket_counts:
                running += c
                cum.append(running)
            return cum, self.sum, self.count


class MetricFamily:
    """One named metric family: a kind, a help string, ordered label
    names, and a child per distinct label-value tuple."""

    def __init__(self, name: str, help: str, kind: str,  # noqa: A002
                 labelnames: Sequence[str],
                 buckets: Sequence[float] | None,
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets is not None else None
        self._lock = lock
        self._children: dict[tuple[str, ...], _Child] = {}

    def labels(self, *values: Any, **kv: Any) -> _Child:
        """The child for one label-value tuple (positional in declared
        order, or by name). Created on first use; resolve once at setup,
        not per request."""
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "name, not both")
            values = tuple(kv[n] for n in self.labelnames)
        vals = tuple(str(v) for v in values)
        if len(vals) != len(self.labelnames):
            raise ValueError(
                f"{self.name} wants labels {self.labelnames}, got {vals}")
        with self._lock:
            child = self._children.get(vals)
            if child is None:
                child = _Child(self._lock, self.buckets)
                self._children[vals] = child
            return child

    def samples(self) -> list[tuple[tuple[str, ...], _Child]]:
        """(label values, child) pairs in insertion order."""
        with self._lock:
            return list(self._children.items())


class MetricsRegistry:
    """Thread-safe namespace of metric families.

    ``counter`` / ``gauge`` / ``histogram`` are idempotent get-or-create
    (the same name returns the same family; a kind mismatch raises), so
    components can declare their instruments independently.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # one shared child lock per registry: increments are short and a
        # registry belongs to one engine — contention is negligible, and
        # it keeps cross-field histogram reads consistent
        self._child_lock = threading.Lock()
        self._families: dict[str, MetricFamily] = {}

    def _get_or_create(self, name: str, help: str, kind: str,  # noqa: A002
                       labelnames: Sequence[str],
                       buckets: Sequence[float] | None) -> MetricFamily:
        assert kind in _VALID_KINDS
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, not {kind}")
                return fam
            fam = MetricFamily(name, help, kind, labelnames, buckets,
                               self._child_lock)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",  # noqa: A002
                labels: Sequence[str] = ()) -> MetricFamily:
        return self._get_or_create(name, help, "counter", labels, None)

    def gauge(self, name: str, help: str = "",  # noqa: A002
              labels: Sequence[str] = ()) -> MetricFamily:
        return self._get_or_create(name, help, "gauge", labels, None)

    def histogram(self, name: str, help: str = "",  # noqa: A002
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS
                  ) -> MetricFamily:
        return self._get_or_create(name, help, "histogram", labels,
                                   buckets)

    def collect(self) -> list[MetricFamily]:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)


def _label_str(names: Sequence[str], values: Sequence[str],
               extra: tuple[str, str] | None = None) -> str:
    pairs = [(n, v) for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    body = ",".join(f'{n}="{escape_label_value(v)}"' for n, v in pairs)
    return "{" + body + "}"


def render_prometheus(*registries: MetricsRegistry) -> str:
    """Prometheus text exposition (format 0.0.4) for one or more
    registries. Same-name families across registries merge under ONE
    ``# HELP``/``# TYPE`` header (the format forbids repeats); label
    order is each family's declared order; histogram buckets render
    CUMULATIVE with the ``+Inf`` bucket equal to ``_count``."""
    merged: dict[str, list[MetricFamily]] = {}
    for reg in registries:
        for fam in reg.collect():
            merged.setdefault(fam.name, []).append(fam)
    lines: list[str] = []
    for name in sorted(merged):
        fams = merged[name]
        kind = fams[0].kind
        lines.append(f"# HELP {name} {escape_help(fams[0].help)}")
        lines.append(f"# TYPE {name} {kind}")
        for fam in fams:
            if fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} registered as both {kind} and "
                    f"{fam.kind}")
            for vals, child in fam.samples():
                if kind == "histogram":
                    cum, total, count = child.snapshot_hist()
                    for b, c in zip(fam.buckets, cum):
                        lab = _label_str(fam.labelnames, vals,
                                         ("le", _fmt(b)))
                        lines.append(f"{name}_bucket{lab} {c}")
                    lab = _label_str(fam.labelnames, vals, ("le", "+Inf"))
                    lines.append(f"{name}_bucket{lab} {count}")
                    plain = _label_str(fam.labelnames, vals)
                    lines.append(f"{name}_sum{plain} {_fmt(total)}")
                    lines.append(f"{name}_count{plain} {count}")
                else:
                    lab = _label_str(fam.labelnames, vals)
                    lines.append(f"{name}{lab} {_fmt(child.get())}")
    return "\n".join(lines) + "\n" if lines else ""


# Process-global registry: signals that belong to the process, not one
# engine — today the resilience fault-point counters (resilience/inject
# increments fire/visit counts here while a plan is active). GET /metrics
# renders this alongside the engine's own registry.
_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _GLOBAL


def percentile(sorted_vals: Iterable[float], q: float) -> float:
    """Nearest-rank percentile over an ALREADY SORTED sequence — the one
    percentile definition every stats() surface shares (moved here from
    serve/engine so obs tooling and engines agree bit-for-bit)."""
    vals = list(sorted_vals)
    if not vals:
        return 0.0
    idx = min(int(q * (len(vals) - 1) + 0.5), len(vals) - 1)
    return vals[idx]

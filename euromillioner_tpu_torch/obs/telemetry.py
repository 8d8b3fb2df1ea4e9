"""ServeTelemetry: the one observability bundle every serving engine owns
(the JAX package's ``obs/telemetry.py``).

Ties the three obs pieces together for a serving engine:

* a :class:`~euromillioner_tpu_torch.obs.metrics.MetricsRegistry` with the
  standard serving instrument set (labeled ``{family, profile}``, the
  per-class ones additionally ``{class}``) — engines bump these instead
  of private counters, and ``stats()`` reads them back, so the pinned
  stats surface and ``GET /metrics`` are two views of ONE store;
* a :class:`~euromillioner_tpu_torch.obs.trace.TraceBuffer` of per-request
  spans (``GET /trace``), stamped through :meth:`span_stage` which
  wraps every stamp in the ``serve.trace`` fault point + a catch-all:
  telemetry is best-effort by construction — a fault in span recording
  or the JSONL emitter can never fail a request;
* the shared :class:`Emitter` — the ONE best-effort JSONL wiring that
  previously existed three times (engine.py + both schedulers in
  continuous.py): a write failure disables the sink with a one-shot
  warning and serving continues. With a sink attached it also emits a
  ``{"event": "stats"}`` snapshot at most once a second — the record
  ``obs-top`` tails.

**SLO attainment** (the judgment metric of the serving stack): every
completed request is judged against its effective deadline — the
explicit ``max_wait_s`` deadline when the request carried one, else the
class's default target from ``serve.obs.slo_ms`` — and lands in the
``serve_slo_met_total`` / ``serve_slo_missed_total{class}`` counters.
A request with no deadline of either kind is NOT judged (there was
nothing to miss — attainment stays 1.0 for deadline-free traffic and
met+missed counts only judged requests). The explicit deadline judged
is the client's RAW ``max_wait_s`` ask, not the engine's flush-clamped
coalescing deadline. ``attainment()`` derives the per-class fraction;
``serve_slo_attainment_ratio{class}`` exposes it as a callback gauge,
which is what ``/healthz`` composes from.

``enabled=False`` (``serve.obs.enabled``) turns off the EXTRAS — span
recording, attainment judging, stats-snapshot emission — while the
registry instruments stay live (they ARE the engines' stats counters).
Every stamp is a host-clock read: telemetry adds no device sync.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Mapping, Sequence

from euromillioner_tpu_torch.obs.metrics import (MetricsRegistry, global_registry,
                                           render_prometheus)
from euromillioner_tpu_torch.obs.trace import Span, TraceBuffer
from euromillioner_tpu_torch.resilience import fault_point
from euromillioner_tpu_torch.utils.logging_utils import (JsonlMetricsWriter,
                                                   get_logger)

logger = get_logger("obs.telemetry")

# Minimum seconds between {"event": "stats"} snapshot records in the
# JSONL stream (the obs-top feed) — piggybacked on regular emission.
_STATS_EVERY_S = 1.0


class Emitter:
    """Best-effort JSONL metrics sink shared by every serving engine.

    One write failure (ENOSPC, yanked volume, injected ``serve.trace``
    fault) disables the sink with a single warning — observability must
    never take a dispatcher thread (and with it the engine) down, and a
    dead sink must not log per batch. This is the one implementation of
    the wiring that engine.py and both continuous.py schedulers used to
    duplicate; tests pin the disable-once behavior.
    """

    def __init__(self, path: str | None):
        self.writer: JsonlMetricsWriter | None = (
            JsonlMetricsWriter(path) if path else None)

    def emit(self, record: dict) -> None:
        if self.writer is None:
            return
        try:
            fault_point("serve.trace", surface="jsonl",
                        event=record.get("event"))
            self.writer.write(record)
        except Exception as e:  # noqa: BLE001 — observability only
            logger.warning("metrics JSONL sink failed (%r); disabling "
                           "observability, serving continues", e)
            self.writer = None

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
            self.writer = None


def _memo_gauges(gauge, family: str, stats, counts_fn) -> None:
    """One gauge per stat of ``counts_fn()``'s snapshot; a scrape's reads
    within 50 ms share one snapshot (one call serves all the stats)."""
    snap: dict[str, Any] = {"t": -1.0, "counts": {}}
    lock = threading.Lock()

    def read(stat: str) -> float:
        now = time.monotonic()
        with lock:
            if now - snap["t"] > 0.05:
                snap["counts"] = counts_fn()
                snap["t"] = now
            return snap["counts"].get(stat, 0)

    for stat in stats:
        gauge.labels(family=family, stat=stat).set_function(
            lambda s=stat: read(s))


class ServeTelemetry:
    """Per-engine metrics registry + trace ring + shared JSONL emitter.

    ``family``/``profile`` become constant labels on every instrument
    (children are resolved once here, never on the hot path);
    ``classes`` are the engine's SLO classes in priority order, and
    ``slo_ms`` (aligned by position, ``serve.obs.slo_ms``) gives a class
    a default deadline for attainment judging when a request carries no
    explicit ``max_wait_s``. The pull-model gauges take callables
    (``queue_depth_fn`` etc.) evaluated only at collect time. The JAX
    package's executable-cache and AOT-store gauges have no counterpart:
    the port runs its programs eagerly.
    """

    def __init__(self, *, kind: str, family: str, profile: str,
                 classes: Sequence[str], enabled: bool = True,
                 trace_capacity: int = 512,
                 slo_ms: Sequence[float] = (),
                 metrics_jsonl: str | None = None,
                 capture_path: str | None = None,
                 queue_depth_fn: Callable[[], float] | None = None,
                 evicted_depth_fn: Callable[[], float] | None = None,
                 pool_slots_fn: Callable[[], float] | None = None,
                 pool_bytes_fn: Callable[[], float] | None = None,
                 ram_bytes_fn: Callable[[], float] | None = None,
                 disk_bytes_fn: Callable[[], float] | None = None,
                 pages_fn: Callable[[], Mapping[str, float]] | None
                 = None,
                 tree_counts_fn: Callable[[], Mapping[str, float]] | None
                 = None,
                 aot_counts_fn: Callable[[], Mapping[str, float]] | None
                 = None):
        self.kind = kind
        self.family = family
        self.profile = profile
        self.classes = tuple(classes)
        self.enabled = bool(enabled)
        self.registry = MetricsRegistry()
        # registries of satellite engines merged into this telemetry's
        # /metrics render (per-request precision tiers: each child
        # scheduler keeps its own registry — distinct profile labels —
        # and the parent serves ONE scrape surface for all of them)
        self.extra_registries: tuple = ()
        self.trace = TraceBuffer(trace_capacity)
        self.emitter = Emitter(metrics_jsonl)
        # workload capture (serve.obs.capture_path): every admitted
        # request becomes a replayable trace line — obs/workload.py.
        # Same best-effort discipline as the emitter; None = off (the
        # default: one attribute load + is-None test on the submit path)
        self.capture = None
        if capture_path:
            from euromillioner_tpu_torch.obs.workload import TraceCapture

            self.capture = TraceCapture(capture_path, family=family,
                                        classes=self.classes)
        # engine.stats is attached after construction (the engine needs
        # the telemetry to build its stats) — feeds the 1 Hz snapshot
        self.stats_fn: Callable[[], dict] | None = None
        self._t_start = time.monotonic()
        self._stats_last = 0.0
        # per-class default SLO deadline (seconds), aligned by position;
        # a PREFIX is valid (remaining classes judge explicit max_wait_s
        # deadlines only), but extra entries would be silently dropped
        # by zip — that misconfiguration must be loud (exit 2)
        if len(slo_ms) > len(self.classes):
            raise ValueError(
                f"serve.obs.slo_ms has {len(slo_ms)} entries for "
                f"{len(self.classes)} classes {list(self.classes)}: "
                "give at most one deadline per class")
        self._slo_default: dict[str, float] = {
            cls: float(ms) / 1e3
            for cls, ms in zip(self.classes, slo_ms)}

        reg = self.registry
        lab = {"family": family, "profile": profile}
        lf = ("family", "profile")
        lc = ("family", "profile", "class")

        def _c(name, help):  # noqa: A002 — counter child bound to lab
            return reg.counter(name, help, lf).labels(**lab)

        # -- core counters (the engines' stats() store) -----------------
        self.requests = _c("serve_requests_total",
                           "Requests admitted by the engine")
        self.completed = _c("serve_requests_completed_total",
                            "Requests completed successfully")
        self.failed = _c("serve_requests_failed_total",
                         "Requests failed (faults, readback errors)")
        self.rows = _c("serve_rows_total", "Rows served")
        self.errors = _c("serve_errors_total",
                         "Engine-level errors (failed batches/steps)")
        # gated by kind like the slots-only block below: a family an
        # engine never increments must not render as permanently zero
        # (kind="slots" counts steps, not batches; only the row engine
        # has bucket fill ratios — sequences use serve_seq_fill_*)
        if kind in ("rows", "sequence"):
            self.batches = _c("serve_batches_total",
                              "Micro-batches dispatched to completion")
        if kind == "rows":
            self.fill_sum = _c("serve_batch_fill_ratio_total",
                               "Sum of per-batch bucket fill ratios")
        self.batch_latency = reg.histogram(
            "serve_batch_latency_seconds",
            "Dispatch-to-done latency per micro-batch/step",
            lf).labels(**lab)
        # -- per-class request latency + SLO attainment -----------------
        req_lat = reg.histogram(
            "serve_request_latency_seconds",
            "End-to-end request latency (submit to reply)", lc)
        met = reg.counter("serve_slo_met_total",
                          "Requests that met their class deadline", lc)
        miss = reg.counter("serve_slo_missed_total",
                           "Requests that missed their class deadline",
                           lc)
        att = reg.gauge("serve_slo_attainment_ratio",
                        "Fraction of judged requests meeting their "
                        "class deadline (1.0 when none judged)", lc)
        self._req_latency = {c: req_lat.labels(**lab, **{"class": c})
                             for c in self.classes}
        self._slo_met = {c: met.labels(**lab, **{"class": c})
                         for c in self.classes}
        self._slo_missed = {c: miss.labels(**lab, **{"class": c})
                            for c in self.classes}
        for c in self.classes:
            att.labels(**lab, **{"class": c}).set_function(
                lambda c=c: self._attainment_of(c))
        # -- trace ring (pull-model: the ring already counts; no _total
        # suffix — that's reserved for TYPE counter in the exposition
        # conventions and these render as gauges) -----------------------
        reg.gauge("serve_trace_spans",
                  "Completed request trace spans recorded",
                  lf).labels(**lab).set_function(
            lambda: self.trace.pushed)
        reg.gauge("serve_trace_dropped", "Spans evicted from the "
                  "bounded trace ring", lf).labels(**lab).set_function(
            lambda: self.trace.dropped)
        # -- pull gauges -------------------------------------------------
        reg.gauge("serve_uptime_seconds", "Engine uptime",
                  lf).labels(**lab).set_function(
            lambda: time.monotonic() - self._t_start)
        if queue_depth_fn is not None:
            reg.gauge("serve_queue_depth",
                      "Requests queued, not yet cut into a batch",
                      lf).labels(**lab).set_function(queue_depth_fn)
        # chunked ensemble dispatch (serve.trees.chunk): the chunk counter
        # and figure gauges exist only while the chunked path is active —
        # the chunk=0 default grows no permanently-zero families. One
        # tree_counts_fn() snapshot serves a scrape's five gauges.
        self.tree_chunks = None
        if tree_counts_fn is not None:
            self.tree_chunks = _c(
                "serve_tree_chunks_total",
                "Chunk dispatches of the chunked tree-ensemble path (one "
                "per chunk per micro-batch)")
            _memo_gauges(reg.gauge(
                "serve_trees", "Chunked-ensemble figures (chunk, n_chunks, "
                "chunks, dispatches, chunk_h2d_ms)", ("family", "stat")),
                family, ("chunk", "n_chunks", "chunks", "dispatches",
                         "chunk_h2d_ms"), tree_counts_fn)
        # the AOT program store (serve.aot): its counters only while a
        # store is bound, so the default grows no permanently-zero family
        if aot_counts_fn is not None:
            _memo_gauges(reg.gauge(
                "serve_aot", "AOT program store counters (hits, misses, "
                "saves, errors, load_ms)", ("family", "stat")),
                family, ("hits", "misses", "saves", "errors", "load_ms"),
                aot_counts_fn)
        # -- slot-pool (continuous scheduler) extras --------------------
        # kind="slots" — the whole-sequence scheduler is kind="sequence"
        # and must NOT grow permanently-zero step/readback/occupancy
        # families it never increments
        if kind == "slots":
            self.steps = _c("serve_steps_total",
                            "Slot-pool step-block dispatches")
            self.readbacks = _c("serve_readbacks_total",
                                "Coalesced device-to-host readbacks")
            self.occupancy_sum = _c("serve_slot_occupancy_total",
                                    "Sum of per-step slot occupancy")
            self.step_latency = reg.histogram(
                "serve_step_latency_seconds",
                "Per-step-block dispatch-to-done latency",
                lf).labels(**lab)
            self.block_dispatch = reg.counter(
                "serve_step_block_dispatch_total",
                "Dispatches per step-block rung",
                ("family", "profile", "block"))
            # preemption + elastic-capacity surface (serve.preempt):
            # counters for the three lifecycle events (evict, restore,
            # deadline-shed), pool resizes, eviction-to-restore latency,
            # and pull gauges for ledger depth + live pool size — the
            # figures /healthz and obs-top --fleet read per host
            self.preempted = _c(
                "serve_preempted_total",
                "Slot preemptions (victim state evicted to host)")
            self.restored = _c(
                "serve_preempt_restored_total",
                "Preempted sequences restored into a slot")
            self.preempt_shed = _c(
                "serve_preempt_shed_total",
                "Evicted sequences failed loudly past their deadline")
            self.resizes = _c(
                "serve_pool_resizes_total",
                "Elastic slot-pool resizes (grow + shrink)")
            self.restore_latency = reg.histogram(
                "serve_restore_latency_seconds",
                "Eviction-to-restore latency per preempted sequence",
                lf).labels(**lab)
            if evicted_depth_fn is not None:
                reg.gauge("serve_evicted_depth",
                          "Host-parked evicted sequences (ledger depth)",
                          lf).labels(**lab).set_function(evicted_depth_fn)
            if pool_slots_fn is not None:
                reg.gauge("serve_pool_slots",
                          "Live slot-pool size (elastic capacity)",
                          lf).labels(**lab).set_function(pool_slots_fn)
            # byte-accounted memory governance (serve.budget): spill
            # tier counters + latency histograms, governor deferral
            # counter, and the bytes gauges /healthz + obs-top read
            self.spills = _c(
                "serve_spill_total",
                "Eviction blobs spilled to the disk tier")
            self.spill_restored = _c(
                "serve_spill_restored_total",
                "Spilled blobs read back (crc32-verified) for restore")
            self.budget_deferred = _c(
                "serve_budget_deferred_total",
                "Admissions/preemptions deferred by the memory "
                "governor (heap parks, never a drop)")
            self.spill_latency = reg.histogram(
                "serve_spill_latency_seconds",
                "Blob write latency per spill to the disk tier",
                lf).labels(**lab)
            self.spill_restore_latency = reg.histogram(
                "serve_spill_restore_latency_seconds",
                "Blob read-back latency per disk-tier restore",
                lf).labels(**lab)
            if pool_bytes_fn is not None:
                reg.gauge("serve_pool_bytes",
                          "Device bytes held by the slot pool's h/c "
                          "state arrays", lf).labels(**lab).set_function(
                    pool_bytes_fn)
            if ram_bytes_fn is not None or disk_bytes_fn is not None:
                lg = reg.gauge(
                    "serve_ledger_bytes",
                    "Eviction-ledger bytes per tier (tier=ram|disk)",
                    ("family", "tier"))
                if ram_bytes_fn is not None:
                    lg.labels(family=family,
                              tier="ram").set_function(ram_bytes_fn)
                if disk_bytes_fn is not None:
                    lg.labels(family=family,
                              tier="disk").set_function(disk_bytes_fn)
            # paged slot state (serve.paging): lifecycle counters +
            # geometry/occupancy gauges, registered only when the paged
            # store is active — the disabled default must not grow
            # permanently-zero families
            if pages_fn is not None:
                self.page_demoted = _c(
                    "serve_pages_demoted_total",
                    "Cold live sequences demoted from a page row to "
                    "the host ledger (LRU by last-dispatched block)")
                self.page_promoted = _c(
                    "serve_pages_promoted_total",
                    "Parked sequences promoted back into a page row "
                    "for their next scheduled block")
                self.page_shed = _c(
                    "serve_pages_shed_total",
                    "Sequences shed by a failed page promotion "
                    "(serve.page fault / corrupt blob)")
                pg = reg.gauge(
                    "serve_pages",
                    "Paged slot-state figures (pages, rows, free_rows, "
                    "live)", ("family", "stat"))
                psnap: dict[str, Any] = {"t": -1.0, "counts": {}}
                psnap_lock = threading.Lock()

                def _page_stat(stat: str) -> float:
                    now = time.monotonic()
                    with psnap_lock:  # one snapshot per scrape
                        if now - psnap["t"] > 0.05:
                            psnap["counts"] = pages_fn()
                            psnap["t"] = now
                        return psnap["counts"].get(stat, 0)

                for stat in ("pages", "rows", "free_rows", "live"):
                    pg.labels(family=family, stat=stat).set_function(
                        lambda s=stat: _page_stat(s))
        if kind in ("rows", "slots"):
            # the governor's loudest rung: requests shed at the front
            # door naming the exhausted budget (never silent). The
            # whole-sequence scheduler has no budget surface — the
            # family must not render permanently zero there
            self.budget_shed = _c(
                "serve_budget_shed_total",
                "Requests shed loudly by an exhausted serve.budget")

    # -- drift (quantized-profile) gauges ---------------------------------
    def register_drift(self, drift) -> None:
        """Expose a DriftStats (serve/engine.py) as registry gauges —
        last/max sampled rel error, checks, and envelope breaches (the
        /healthz breach figure reads the breach gauge)."""
        lab = {"family": self.family, "profile": self.profile}
        g = self.registry.gauge(
            "serve_precision_drift",
            "Sampled rel error vs the f32 oracle (stat=last|max) and "
            "check/breach counts", ("family", "profile", "stat"))
        for stat, fn in (("last", lambda: drift.last),
                         ("max", lambda: drift.max),
                         ("checks", lambda: drift.checks),
                         ("breaches", lambda: drift.breaches)):
            g.labels(**lab, stat=stat).set_function(fn)
        self._drift = drift

    # -- span recording (best-effort by construction) ---------------------
    #
    # Two rates, two APIs. Sequence engines (hundreds of requests/sec,
    # many steps each) stamp a Span object incrementally. The row engine
    # (tens of thousands of requests/sec) gets the bulk path: a bare
    # trace id per request at admit, then ONE record_batch call per
    # completed micro-batch that materializes every span from the
    # batch's shared mid-pipeline timestamps — per-request cost is a
    # tuple build + a GIL-atomic deque append, which keeps the
    # telemetry's cost a small share of a request in Python.
    def trace_id(self, cls: str) -> int | None:  # noqa: ARG002 — parity
        """A trace id for one admitted request (the row-engine span
        handle), or None when tracing is off. Never raises. Kept to a
        single C call — this sits on the submit hot path; the fault
        point for span recording lives in :meth:`record_batch`, which
        is where spans actually materialize."""
        if not self.enabled:
            return None
        try:
            return self.trace.new_id()
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            return None

    def record_batch(self, batch, mid: tuple, t_reply: float) -> None:
        """Materialize + push one span per request of a completed
        micro-batch: ``admit``/``batch_cut`` are per-request
        (``r.t_submit``/``r.t_cut``), ``mid`` is the batch's shared
        (stage, t) tail, ``t_reply`` the shared reply time. One fault
        point + one catch-all covers the whole batch."""
        if not self.enabled:
            return
        try:
            fault_point("serve.trace", surface="span", stage="batch")
            push = self.trace.push
            tail = mid + (("reply", t_reply),)
            for r in batch:
                tid = r.span
                if tid is None:
                    continue
                # stages as a tuple: spans from this path are complete
                # on construction, never stamped again
                t_cut = r.t_cut
                stages = ((("admit", r.t_submit), ("batch_cut", t_cut))
                          if t_cut else (("admit", r.t_submit),)) + tail
                push(Span(tid, r.cls, stages))
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            pass

    def span_start(self, cls: str) -> Span | None:
        """A new span stamped ``admit``, or None when tracing is off.
        Never raises — telemetry must not fail the request being
        admitted."""
        if not self.enabled:
            return None
        try:
            fault_point("serve.trace", surface="span", stage="admit")
            span = self.trace.new_span(cls)
            span.stamp("admit")
            return span
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            return None

    def span_stage(self, span: Span | None, stage: str,
                   t: float | None = None) -> None:
        if span is None:
            return
        try:
            fault_point("serve.trace", surface="span", stage=stage)
            span.stamp(stage, t)
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            pass

    def span_end(self, span: Span | None) -> None:
        """Stamp the terminal ``reply`` stage and push into the ring."""
        if span is None:
            return
        try:
            fault_point("serve.trace", surface="span", stage="reply")
            span.stamp("reply")
            self.trace.push(span)
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            pass

    # -- workload capture (serve.obs.capture_path) -------------------------
    def capture_request(self, cls: str, *, rows: int = 0, steps: int = 0,
                        deadline_s: float | None = None) -> None:
        """Record one ADMITTED request as a replayable trace line (rows
        for row engines, steps for sequence engines, the client's raw
        ``max_wait_s`` as the deadline). No-op without a capture path;
        never raises — a request is never failed by its own capture."""
        cap = self.capture
        if cap is not None:
            cap.record(cls, family=self.family, rows=rows, steps=steps,
                       deadline_s=deadline_s)

    # -- request completion + SLO attainment ------------------------------
    def observe_batch(self, items, now: float) -> None:
        """Bulk completion accounting for one micro-batch/readback:
        ``items`` is a sequence of ``(cls, wait_s, deadline, t_submit)``
        (deadline = absolute monotonic, None/inf = none). Per-class
        latency histograms take ONE locked bulk observe; attainment
        counters take one aggregated inc per class. A request with
        neither an explicit deadline nor a class default is not judged
        — attainment only counts requests that had a deadline to meet."""
        by_cls: dict[str, list[float]] = {}
        met: dict[str, int] = {}
        missed: dict[str, int] = {}
        judge = self.enabled
        defaults = self._slo_default
        inf = math.inf
        for cls, wait, deadline, t_submit in items:
            lats = by_cls.get(cls)
            if lats is None:
                lats = by_cls[cls] = []
            lats.append(wait)
            if not judge:
                continue
            eff = deadline
            if eff is None or eff == inf:
                d = defaults.get(cls)
                if d is None:
                    continue  # nothing to judge against
                eff = t_submit + d
            if now <= eff:
                met[cls] = met.get(cls, 0) + 1
            else:
                missed[cls] = missed.get(cls, 0) + 1
        for cls, lats in by_cls.items():
            child = self._req_latency.get(cls)
            if child is not None:
                child.observe_many(lats)
        for target, counts in ((self._slo_met, met),
                               (self._slo_missed, missed)):
            for cls, n in counts.items():
                child = target.get(cls)
                if child is not None:
                    child.inc(n)

    def _attainment_of(self, cls: str) -> float:
        met_c = self._slo_met.get(cls)
        miss_c = self._slo_missed.get(cls)
        met = met_c.get() if met_c else 0.0
        miss = miss_c.get() if miss_c else 0.0
        return met / (met + miss) if met + miss else 1.0

    def attainment(self) -> dict:
        """Per-class met/missed counts + attainment fraction — the
        ``stats()["slo"]`` surface, re-derived from the registry."""
        return {c: {"met": int(self._slo_met[c].get()),
                    "missed": int(self._slo_missed[c].get()),
                    "attainment": round(self._attainment_of(c), 4)}
                for c in self.classes}

    def trace_snapshot(self) -> dict:
        return {"spans": self.trace.pushed, "buffered": len(self.trace),
                "dropped": self.trace.dropped}

    # -- health + exposition ----------------------------------------------
    def health(self) -> dict:
        """The registry-gauge view /healthz composes: attainment per
        class, drift breaches, span counts, uptime."""
        out: dict[str, Any] = {
            "attainment": {c: round(self._attainment_of(c), 4)
                           for c in self.classes},
            "trace_spans": self.trace.pushed,
            "uptime_s": round(time.monotonic() - self._t_start, 3),
        }
        drift = getattr(self, "_drift", None)
        if drift is not None:
            out["drift_breaches"] = drift.breaches
        return out

    def render(self) -> str:
        """Prometheus text: this engine's registry, any merged satellite
        registries (per-profile child schedulers), + the process-global
        one (resilience fault counters)."""
        return render_prometheus(self.registry, *self.extra_registries,
                                 global_registry())

    # -- JSONL emission ----------------------------------------------------
    def emit(self, record: dict) -> None:
        """Best-effort JSONL record via the shared emitter; with the
        sink live (and telemetry enabled) a ``{"event": "stats"}``
        snapshot rides along at most once a second — the obs-top feed."""
        self.emitter.emit(record)
        if (not self.enabled or self.emitter.writer is None
                or self.stats_fn is None):
            return
        now = time.monotonic()
        if now - self._stats_last >= _STATS_EVERY_S:
            self._stats_last = now
            try:
                self.emitter.emit({"event": "stats", **self.stats_fn()})
            except Exception:  # noqa: BLE001 — telemetry is best-effort
                pass

    def close(self) -> None:
        self.emitter.close()
        if self.capture is not None:
            self.capture.close()

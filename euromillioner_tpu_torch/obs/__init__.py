"""Unified serving telemetry (the JAX package's ``obs/``; the
Clipper/Orca-style signal surface).

Three pieces, one per module:

* :mod:`metrics` — thread-safe registry of labeled Counter / Gauge /
  Histogram families with Prometheus text rendering (``GET /metrics``);
  each engine's pinned ``stats()`` dict is re-derived from it.
* :mod:`trace` — per-request trace spans (admit → batch-cut → H2D put →
  dispatch → compute → readback → reply) in a bounded lock-free ring
  (``GET /trace?n=K``).
* :mod:`telemetry` — :class:`~euromillioner_tpu_torch.obs.telemetry.ServeTelemetry`,
  the per-engine bundle wiring both to the serving engines, plus the ONE
  shared best-effort JSONL emitter and per-class SLO-attainment
  accounting (met/missed deadline counters).
* :mod:`workload` and :mod:`replay` — seeded, arrival-timestamped trace
  files and their open-loop replay against live engines.

:mod:`top` is the live console view (``python -m euromillioner_tpu_torch
obs-top``): one line per second of rps / p50 / p99 / attainment /
occupancy from a metrics JSONL tail or a polled ``/stats`` endpoint.

Telemetry is best-effort by construction: every span stamp and JSONL
write sits behind the ``serve.trace`` fault point and a catch-all — a
telemetry fault never fails a request (chaos-tested bit-identical).
"""

from euromillioner_tpu_torch.obs.metrics import (LATENCY_BUCKETS, MetricsRegistry,
                                           global_registry, percentile,
                                           render_prometheus)
from euromillioner_tpu_torch.obs.telemetry import Emitter, ServeTelemetry
from euromillioner_tpu_torch.obs.trace import (STAGES, TERMINAL_STAGE, Span,
                                         TraceBuffer)

__all__ = ["LATENCY_BUCKETS", "MetricsRegistry", "Emitter",
           "ServeTelemetry", "Span", "STAGES", "TERMINAL_STAGE",
           "TraceBuffer", "global_registry", "percentile",
           "render_prometheus"]

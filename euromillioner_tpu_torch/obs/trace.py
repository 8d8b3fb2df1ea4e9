"""Per-request trace spans: stage timestamps through the serving pipeline.

Every request/sequence admitted by a serving engine carries a trace id
and a :class:`Span` that is stamped at each pipeline stage::

    admit → batch_cut → h2d_put → dispatch → compute → readback → reply

(the row engine's stages; sequence engines stamp the same names at the
analogous points — ``batch_cut`` is slot admission for the continuous
scheduler, ``h2d_put``/``dispatch`` its first step-block dispatch).
Stamps append in pipeline order, so a well-formed span's timestamps are
monotonically non-decreasing and its LAST stage is the terminal
``reply`` — the property the bench soak asserts. Completed spans land
in a bounded ring buffer (:class:`TraceBuffer`) read by ``GET
/trace?n=K`` for latency attribution: which stage ate the p99.

Telemetry is best-effort BY CONSTRUCTION: every stamp goes through the
owning :class:`~euromillioner_tpu_torch.obs.telemetry.ServeTelemetry`, which
wraps it in the ``serve.trace`` fault point + a catch-all — a fault in
span recording can NEVER fail a request (chaos-tested bit-identical).
The ring itself is lock-free on the write path: ``deque.append`` with a
``maxlen`` is a single atomic operation under CPython's GIL, so the
dispatcher thread never takes a lock to record a span.
"""

from __future__ import annotations

import collections
import itertools
import time

# Pipeline stage names, in order. A span stamps a subset (a row engine
# has no slot admission; a smoke request may skip the mesh put) but
# always in this relative order, ending with "reply".
STAGES = ("admit", "batch_cut", "h2d_put", "dispatch", "compute",
          "readback", "reply")
TERMINAL_STAGE = STAGES[-1]


class Span:
    """One request's trace: id, SLO class, and (stage, timestamp) pairs
    in stamp order (``time.monotonic`` seconds).

    Two construction shapes, matched to engine rate: sequence engines
    stamp incrementally over a request's lifetime (:meth:`stamp`); the
    row engine materializes the whole span in ONE shot at completion
    (``stages=`` prebuilt, sharing the batch's mid-pipeline timestamps)
    because at tens of thousands of requests/sec per-stage method calls
    are the telemetry overhead budget."""

    __slots__ = ("trace_id", "cls", "stages")

    def __init__(self, trace_id: int, cls: str = "",
                 stages=None):
        self.trace_id = trace_id
        self.cls = cls
        # (stage, t) pairs: a mutable list when built incrementally via
        # stamp(); prebuilt spans may pass a tuple (never stamped again)
        self.stages = [] if stages is None else stages

    def stamp(self, stage: str, t: float | None = None) -> None:
        """Record ``stage`` at ``t`` (now by default). First-wins per
        stage name: a sequence that spans many step-block dispatches
        keeps its FIRST h2d_put/dispatch stamp, so spans stay bounded
        at one entry per stage. Only valid on incrementally-built
        (list-backed) spans."""
        if any(s == stage for s, _ in self.stages):
            return
        self.stages.append((stage, time.monotonic() if t is None else t))

    @property
    def complete(self) -> bool:
        return bool(self.stages) and self.stages[-1][0] == TERMINAL_STAGE

    def monotonic_ok(self) -> bool:
        ts = [t for _, t in self.stages]
        return all(a <= b for a, b in zip(ts, ts[1:]))

    def to_dict(self) -> dict:
        """JSON shape for /trace: absolute monotonic start + per-stage
        offsets in ms (offsets are what latency attribution reads)."""
        if not self.stages:
            return {"trace_id": self.trace_id, "cls": self.cls,
                    "stages": {}}
        t0 = self.stages[0][1]
        return {
            "trace_id": self.trace_id,
            "cls": self.cls,
            "t0": round(t0, 6),
            "stages": {s: round((t - t0) * 1e3, 3)
                       for s, t in self.stages},
            "total_ms": round((self.stages[-1][1] - t0) * 1e3, 3),
        }


class TraceBuffer:
    """Bounded ring of completed spans.

    ``push`` is the dispatcher-thread hot path: one GIL-atomic
    ``deque.append`` (the ``maxlen`` discards the oldest span), no
    lock. ``last(n)`` (the /trace read side) snapshots the deque —
    iteration races an append at worst by one element, which is fine
    for an observability dump."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"trace capacity must be >= 1, got "
                             f"{capacity}")
        self.capacity = capacity
        self._ring: collections.deque[Span] = collections.deque(
            maxlen=capacity)
        self._ids = itertools.count()
        self._pushed = 0

    def new_id(self) -> int:
        """A fresh trace id — cheap enough to hand EVERY request one
        (itertools.count is a single C call), independent of whether a
        full span gets recorded."""
        return next(self._ids)

    def new_span(self, cls: str = "") -> Span:
        return Span(next(self._ids), cls)

    def push(self, span: Span) -> None:
        self._pushed += 1  # benign race: observability-only counter
        self._ring.append(span)

    @property
    def pushed(self) -> int:
        return self._pushed

    @property
    def dropped(self) -> int:
        """Spans the ring has discarded (pushed beyond capacity)."""
        return max(0, self._pushed - self.capacity)

    def last(self, n: int) -> list[dict]:
        """The most recent ``n`` spans, oldest first, as /trace dicts.
        ``n <= 0`` returns none (a ``-0`` slice would return ALL)."""
        if n <= 0:
            return []
        spans = list(self._ring)
        return [s.to_dict() for s in spans[-n:]]

    def __len__(self) -> int:
        return len(self._ring)

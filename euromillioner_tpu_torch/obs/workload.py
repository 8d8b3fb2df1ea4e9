"""Replayable workload traces: format, seeded generators, live capture.

Every serve bench before this drove the engines with synthetic uniform
or fixed-pattern arrivals; production traffic is bursty, diurnal, and
occasionally a flash crowd. Clipper (NSDI '17) and Orca (OSDI '22) both
evaluate on arrival-timestamped traces and report deadline attainment
rather than mean throughput — this module makes that methodology a
first-class artifact instead of ad-hoc bench loops.

**Trace format** (versioned JSONL). Line 1 is the header::

    {"trace_version": 1, "name": "flash_crowd", "generator": ...,
     "seed": 0, "classes": ["interactive", "bulk"], "events": 186, ...}

every following line is one arrival event::

    {"t": 1.503214, "class": "interactive", "family": "lstm",
     "steps": 4, "seed": 1188136569, "deadline_ms": 1500.0}

``t`` is the arrival offset in seconds from trace start, ``class`` the
SLO class (``serve.classes``), ``family`` the serving family the event
targets (``nn`` / ``wide_deep`` / ``gbt`` / ``rf`` / ``classic`` carry
``rows``, the sequence family ``lstm`` carries ``steps``), ``seed``
pins the request payload (the replay loop regenerates it from a
seeded RNG — same trace, bit-identical requests), and ``deadline_ms``
is the request's explicit ``max_wait_s`` SLO ask (absent = judged only
against ``serve.obs.slo_ms`` class defaults). Unknown keys are
tolerated (capture tags events ``"event": "request"`` so a trace line
and a telemetry-stream line are the same shape); malformed lines and
traces written by a NEWER format version are rejected with an error
naming the offending line — a replay workload is a pinned artifact, so
a half-understood trace must never half-replay.

**Generators** (:data:`GENERATORS`): :func:`poisson_burst` (periodic
rate bursts over a Poisson base), :func:`diurnal` (a smooth
low↔high-rate curve), :func:`flash_crowd` (steady base with one sudden
multi-x spike). All arrivals come from one seeded Lewis-thinning draw
(non-homogeneous Poisson), so the same ``seed`` produces a
BYTE-identical trace file — replay workloads are data, not code.

**Capture** (:class:`TraceCapture`, ``serve.obs.capture_path``): the
telemetry layer optionally records every admitted request as a trace
line, so any live engine run — production debugging included — becomes
a replayable workload. Captured events carry synthetic payload seeds
(the original request bytes are not recorded): a captured trace
reproduces the arrival pattern, class mix, shapes, and deadlines, not
the payload values. Capture is best-effort exactly like the JSONL
emitter: one write failure disables it with a single warning and
serving continues. :func:`export_trace` normalizes any JSONL containing
request events (a capture file, or a telemetry stream that interleaved
one) into a canonical versioned trace.
"""

from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from euromillioner_tpu_torch.utils.errors import ServeError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("obs.workload")

# Format version this build writes and the NEWEST version it reads.
TRACE_VERSION = 1

# Families whose events carry ``steps`` (one ordered sequence) instead
# of ``rows`` (a batch of independent feature rows).
SEQ_FAMILIES = ("lstm",)


@dataclass
class TraceEvent:
    """One arrival: offset, SLO class, family, shape, payload seed."""

    t: float
    cls: str
    family: str
    rows: int = 0
    steps: int = 0
    seed: int = 0
    deadline_ms: float | None = None

    @property
    def size(self) -> int:
        """Rows for row families, steps for sequence families."""
        return self.steps if self.steps else self.rows


@dataclass
class Trace:
    """A parsed/generated workload trace: header meta + sorted events."""

    meta: dict
    events: list[TraceEvent] = field(default_factory=list)

    @property
    def name(self) -> str:
        return str(self.meta.get("name", "trace"))

    @property
    def classes(self) -> tuple[str, ...]:
        return tuple(self.meta.get("classes", ()))

    @property
    def families(self) -> tuple[str, ...]:
        return tuple(sorted({e.family for e in self.events}))

    @property
    def duration_s(self) -> float:
        return self.events[-1].t if self.events else 0.0

    def class_mix(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.events:
            out[e.cls] = out.get(e.cls, 0) + 1
        return out


def _event_obj(ev: TraceEvent) -> dict:
    # fixed key order + fixed rounding = deterministic serialization
    # (same seed ⇒ byte-identical trace file, pinned by tests)
    o: dict = {"t": round(float(ev.t), 6), "class": ev.cls,
               "family": ev.family}
    if ev.rows:
        o["rows"] = int(ev.rows)
    if ev.steps:
        o["steps"] = int(ev.steps)
    o["seed"] = int(ev.seed)
    if ev.deadline_ms is not None:
        o["deadline_ms"] = round(float(ev.deadline_ms), 3)
    return o


def trace_lines(trace: Trace) -> list[str]:
    """The trace's canonical serialized lines (header first) — the
    byte-determinism surface :func:`write_trace` persists."""
    head = {"trace_version": TRACE_VERSION, **trace.meta}
    lines = [json.dumps(head, separators=(",", ":"))]
    lines.extend(json.dumps(_event_obj(e), separators=(",", ":"))
                 for e in trace.events)
    return lines


def write_trace(path: str, trace: Trace) -> str:
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(trace_lines(trace)) + "\n")
    return path


def _parse_event(obj: dict, where: str) -> TraceEvent:
    t = obj.get("t")
    if isinstance(t, bool) or not isinstance(t, (int, float)) or t < 0 \
            or not math.isfinite(t):
        raise ServeError(f"{where}: event needs a finite arrival offset "
                         f"t >= 0 seconds, got {t!r}")
    cls = obj.get("class")
    if not isinstance(cls, str) or not cls.strip():
        raise ServeError(f"{where}: event needs a non-empty string "
                         f"'class', got {cls!r}")
    family = obj.get("family")
    if not isinstance(family, str) or not family.strip():
        raise ServeError(f"{where}: event needs a non-empty string "
                         f"'family', got {family!r}")
    rows = obj.get("rows", 0)
    steps = obj.get("steps", 0)
    for k, v in (("rows", rows), ("steps", steps)):
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            raise ServeError(f"{where}: {k} must be an int >= 0, "
                             f"got {v!r}")
    if (rows > 0) == (steps > 0):
        raise ServeError(f"{where}: event needs exactly one of rows/"
                         f"steps > 0, got rows={rows} steps={steps}")
    seed = obj.get("seed", 0)
    if isinstance(seed, bool) or not isinstance(seed, int) or seed < 0:
        raise ServeError(f"{where}: seed must be an int >= 0, "
                         f"got {seed!r}")
    dl = obj.get("deadline_ms")
    if dl is not None and (isinstance(dl, bool)
                           or not isinstance(dl, (int, float)) or dl < 0):
        raise ServeError(f"{where}: deadline_ms must be a number >= 0, "
                         f"got {dl!r}")
    return TraceEvent(t=float(t), cls=cls, family=family, rows=rows,
                      steps=steps, seed=seed,
                      deadline_ms=None if dl is None else float(dl))


def _check_header(obj: dict, where: str) -> dict:
    ver = obj.get("trace_version")
    if isinstance(ver, bool) or not isinstance(ver, int) or ver < 1:
        raise ServeError(f"{where}: trace_version must be an int >= 1, "
                         f"got {ver!r}")
    if ver > TRACE_VERSION:
        raise ServeError(
            f"{where}: trace_version {ver} is newer than this build "
            f"supports ({TRACE_VERSION}) — regenerate the trace with "
            f"this build, or upgrade")
    return obj


def read_trace(path: str) -> Trace:
    """Parse + validate a trace file. The first line must be the
    versioned header; every further non-empty line must be a valid
    event — a bad line is a :class:`ServeError` naming ``path:line``.
    Events are sorted by arrival offset on read (capture offsets from
    concurrent submit threads may interleave by microseconds)."""
    meta: dict | None = None
    events: list[TraceEvent] = []
    with open(path, encoding="utf-8") as fh:
        for lineno, raw in enumerate(fh, 1):
            line = raw.strip()
            if not line:
                continue
            where = f"{path}:{lineno}"
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise ServeError(f"{where}: not valid JSON ({e})")
            if not isinstance(obj, dict):
                raise ServeError(f"{where}: trace lines must be JSON "
                                 f"objects, got {type(obj).__name__}")
            if meta is None:
                if "trace_version" not in obj:
                    raise ServeError(
                        f"{where}: missing trace header — the first "
                        f"line must carry trace_version (this build "
                        f"writes {TRACE_VERSION})")
                meta = _check_header(obj, where)
                continue
            events.append(_parse_event(obj, where))
    if meta is None:
        raise ServeError(f"{path}: empty trace (no header line)")
    events.sort(key=lambda e: e.t)
    return Trace(meta=meta, events=events)


# ---------------------------------------------------------------------------
# seeded generators (non-homogeneous Poisson via Lewis thinning)
# ---------------------------------------------------------------------------

def _poisson_arrivals(rng, duration_s: float,
                      rate_fn: Callable[[float], float],
                      rate_max: float) -> list[float]:
    """Lewis thinning: candidate arrivals at the envelope rate, each
    kept with probability rate(t)/rate_max — one deterministic draw
    sequence per seed, whatever the rate curve."""
    out: list[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate_max))
        if t >= duration_s:
            return out
        if float(rng.random()) * rate_max <= rate_fn(t):
            out.append(t)


def _make(name: str, rate_fn, rate_max: float, *, seed: int, family: str,
          duration_s: float, classes: Sequence[str],
          interactive_every: int, deadline_ms,
          interactive_shape: tuple[int, int],
          bulk_shape: tuple[int, int], params: dict) -> Trace:
    if duration_s <= 0:
        raise ServeError(f"duration_s must be > 0, got {duration_s}")
    if rate_max <= 0:
        raise ServeError(f"arrival rates must be > 0, got {rate_max}")
    classes = tuple(classes)
    if not classes:
        raise ServeError("generators need at least one SLO class")
    rng = np.random.default_rng(seed)
    seq = family in SEQ_FAMILIES
    events: list[TraceEvent] = []
    for i, t in enumerate(_poisson_arrivals(rng, duration_s, rate_fn,
                                            rate_max)):
        # every Nth arrival is interactive;
        # interactive = the FIRST (highest-priority) class, bulk the last
        interactive = (interactive_every > 0
                       and i % interactive_every == interactive_every - 1)
        cls = classes[0] if interactive else classes[-1]
        lo, hi = interactive_shape if interactive else bulk_shape
        size = int(rng.integers(lo, hi + 1))
        dl = None
        if deadline_ms:
            dl = float(deadline_ms[0] if interactive else deadline_ms[-1])
        events.append(TraceEvent(
            t=round(float(t), 6), cls=cls, family=family,
            rows=0 if seq else size, steps=size if seq else 0,
            seed=int(rng.integers(0, 2**31 - 1)), deadline_ms=dl))
    meta = {"name": name, "generator": name, "seed": int(seed),
            "family": family, "classes": list(classes),
            "duration_s": float(duration_s), "events": len(events),
            "params": params}
    return Trace(meta=meta, events=events)


def poisson_burst(*, seed: int = 0, family: str = "lstm",
                  duration_s: float = 5.0, base_rps: float = 30.0,
                  burst_rps: float = 120.0, burst_every_s: float = 2.0,
                  burst_len_s: float = 0.5,
                  classes: Sequence[str] = ("interactive", "bulk"),
                  interactive_every: int = 4,
                  deadline_ms=(1500.0, 60000.0),
                  interactive_shape: tuple[int, int] = (2, 8),
                  bulk_shape: tuple[int, int] = (24, 48)) -> Trace:
    """Poisson base load with periodic rate bursts: ``burst_len_s`` at
    ``burst_rps`` opening every ``burst_every_s`` window."""
    def rate(t: float) -> float:
        return burst_rps if (t % burst_every_s) < burst_len_s else base_rps

    return _make("poisson_burst", rate, max(base_rps, burst_rps),
                 seed=seed, family=family, duration_s=duration_s,
                 classes=classes, interactive_every=interactive_every,
                 deadline_ms=deadline_ms,
                 interactive_shape=interactive_shape,
                 bulk_shape=bulk_shape,
                 params={"base_rps": base_rps, "burst_rps": burst_rps,
                         "burst_every_s": burst_every_s,
                         "burst_len_s": burst_len_s})


def diurnal(*, seed: int = 0, family: str = "lstm",
            duration_s: float = 6.0, low_rps: float = 8.0,
            high_rps: float = 60.0, period_s: float = 3.0,
            classes: Sequence[str] = ("interactive", "bulk"),
            interactive_every: int = 4,
            deadline_ms=(1500.0, 60000.0),
            interactive_shape: tuple[int, int] = (2, 8),
            bulk_shape: tuple[int, int] = (24, 48)) -> Trace:
    """Smooth diurnal rate curve: cosine ramp trough→peak→trough every
    ``period_s`` (a day compressed to seconds), rate in
    [low_rps, high_rps]."""
    def rate(t: float) -> float:
        return low_rps + (high_rps - low_rps) * 0.5 * (
            1.0 - math.cos(2.0 * math.pi * t / period_s))

    return _make("diurnal", rate, high_rps, seed=seed, family=family,
                 duration_s=duration_s, classes=classes,
                 interactive_every=interactive_every,
                 deadline_ms=deadline_ms,
                 interactive_shape=interactive_shape,
                 bulk_shape=bulk_shape,
                 params={"low_rps": low_rps, "high_rps": high_rps,
                         "period_s": period_s})


def flash_crowd(*, seed: int = 0, family: str = "lstm",
                duration_s: float = 6.0, base_rps: float = 15.0,
                crowd_x: float = 8.0, at_s: float = 2.0,
                crowd_len_s: float = 1.5,
                classes: Sequence[str] = ("interactive", "bulk"),
                interactive_every: int = 4,
                deadline_ms=(1500.0, 60000.0),
                interactive_shape: tuple[int, int] = (2, 8),
                bulk_shape: tuple[int, int] = (24, 48)) -> Trace:
    """Steady base load with ONE sudden ``crowd_x``× spike of
    ``crowd_len_s`` starting at ``at_s`` — the scenario SLO gates are
    judged under (can interactive traffic survive the stampede?)."""
    def rate(t: float) -> float:
        return base_rps * crowd_x if at_s <= t < at_s + crowd_len_s \
            else base_rps

    return _make("flash_crowd", rate, base_rps * max(1.0, crowd_x),
                 seed=seed, family=family, duration_s=duration_s,
                 classes=classes, interactive_every=interactive_every,
                 deadline_ms=deadline_ms,
                 interactive_shape=interactive_shape,
                 bulk_shape=bulk_shape,
                 params={"base_rps": base_rps, "crowd_x": crowd_x,
                         "at_s": at_s, "crowd_len_s": crowd_len_s})


GENERATORS = {"poisson_burst": poisson_burst, "diurnal": diurnal,
              "flash_crowd": flash_crowd}


def generate(name: str, **kw) -> Trace:
    """One seeded workload by generator name — the CLI/bench front door.
    Unknown names are a :class:`ServeError` listing the valid ones."""
    fn = GENERATORS.get(name)
    if fn is None:
        raise ServeError(f"unknown workload generator {name!r}; known: "
                         f"{sorted(GENERATORS)}")
    return fn(**kw)


# ---------------------------------------------------------------------------
# live capture (serve.obs.capture_path) + telemetry-JSONL export
# ---------------------------------------------------------------------------

class TraceCapture:
    """Best-effort per-admitted-request trace writer owned by
    :class:`~euromillioner_tpu_torch.obs.telemetry.ServeTelemetry`.

    Writes the versioned header at open and one ``{"event": "request",
    ...}`` trace line per admitted request (offset from engine start,
    class, family, shape, deadline, synthetic payload seed) — the file
    IS a valid replayable trace (:func:`read_trace` accepts it
    directly). Same failure discipline as the JSONL emitter: one write
    failure disables capture with a single warning; a request is never
    failed by its own capture line."""

    def __init__(self, path: str, *, family: str,
                 classes: Sequence[str]):
        self._lock = threading.Lock()
        self._n = 0
        self._t0 = time.monotonic()
        try:
            self._fh = open(path, "w", encoding="utf-8")
            head = {"trace_version": TRACE_VERSION, "name": "capture",
                    "generator": "capture", "family": family,
                    "classes": list(classes), "captured": True}
            self._fh.write(json.dumps(head, separators=(",", ":")) + "\n")
            self._fh.flush()
        except OSError as e:
            logger.warning("trace capture open failed for %s (%r); "
                           "capture disabled, serving continues", path, e)
            self._fh = None

    def record(self, cls: str, *, family: str, rows: int = 0,
               steps: int = 0, deadline_s: float | None = None) -> None:
        """Record one admitted request. Never raises — capture is
        observability, not the request path."""
        if self._fh is None:
            return
        try:
            t = max(0.0, time.monotonic() - self._t0)
            with self._lock:
                if self._fh is None:
                    return
                # seed assignment lives under the lock: concurrent
                # submit threads must not capture duplicate seeds (the
                # trace pins payload BYTES, so seeds must be unique)
                ev = TraceEvent(
                    t=t, cls=cls, family=family, rows=int(rows),
                    steps=int(steps), seed=self._n,
                    deadline_ms=None if deadline_s is None
                    else float(deadline_s) * 1e3)
                self._n += 1
                line = json.dumps({"event": "request", **_event_obj(ev)},
                                  separators=(",", ":"))
                self._fh.write(line + "\n")
                self._fh.flush()
        except Exception as e:  # noqa: BLE001 — observability only
            logger.warning("trace capture write failed (%r); capture "
                           "disabled, serving continues", e)
            self.close()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def export_trace(src_path: str, out_path: str) -> int:
    """Normalize a JSONL stream containing request events (a capture
    file, or a telemetry metrics JSONL that interleaved one) into a
    canonical versioned trace at ``out_path``: request events are
    extracted, shifted so the first arrival is t=0, sorted, and written
    under a fresh header. Non-request telemetry records (batch / step /
    stats lines) are skipped. Returns the exported event count."""
    meta: dict = {}
    events: list[TraceEvent] = []
    skipped = 0
    with open(src_path, encoding="utf-8") as fh:
        for lineno, raw in enumerate(fh, 1):
            line = raw.strip()
            if not line:
                continue
            where = f"{src_path}:{lineno}"
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if not isinstance(obj, dict):
                skipped += 1
                continue
            if "trace_version" in obj:
                meta = dict(_check_header(obj, where))
                continue
            ev = obj.get("event")
            if ev == "request" or (ev is None and "t" in obj
                                   and "class" in obj):
                events.append(_parse_event(obj, where))
            else:
                skipped += 1
    if not events:
        raise ServeError(f"{src_path}: no request events to export — "
                         "was the run captured (serve.obs.capture_path)?")
    events.sort(key=lambda e: e.t)
    t0 = events[0].t
    for e in events:
        e.t = round(e.t - t0, 6)
    meta.pop("trace_version", None)
    meta.update({"name": meta.get("name", "capture"),
                 "generator": meta.get("generator", "capture"),
                 "classes": meta.get(
                     "classes", sorted({e.cls for e in events})),
                 "events": len(events), "exported_from": src_path,
                 "skipped_records": skipped})
    write_trace(out_path, Trace(meta=meta, events=events))
    return len(events)

"""Open-loop trace replay against live serving engines (the JAX
package's ``obs/replay.py``).

The serve benches before this were CLOSED-loop: the submitting thread
waits on results, so a slow engine back-pressures the arrival clock and
the workload silently degrades to whatever the engine can absorb —
exactly the methodology error the serving literature warns about
(coordinated omission). :func:`replay_trace` is open-loop: every event
of a :class:`~euromillioner_tpu_torch.obs.workload.Trace` is submitted at its
RECORDED arrival time (scaled by ``speed``), whether or not earlier
requests have completed; results resolve on their own threads and the
clock never waits for them. The one thing the replay loop measures about
itself is how faithfully it kept that clock (``lag_*`` — scheduling
delay between an event's target time and its actual submit).

Payloads are regenerated from each event's ``seed`` (a per-event
``np.random.default_rng``), so the same (trace, engine config) replays
with bit-identical requests — the chaos tier pins that a fault-free
rerun produces bit-identical outputs.

``engines`` maps each trace family to the engine serving it (a single
engine serves every family — the single-model case); events are routed
by family, rows to row engines, whole sequences to sequence engines.

Failure model: the ``serve.replay`` fault point covers each event's
submission — a fired fault (or an engine-side rejection) fails ONLY
that event, lands in the report's ``errors``, and never wedges the
replay clock; the remaining events still submit on time and the engine
ends leak-free (chaos-tested).

The report is rendered from two sources: per-event completion times
the replay loop records itself (per-class p50/p99 — available even for the
classless FIFO baseline), and each engine's telemetry registry
(per-class SLO attainment, read through ``telemetry.attainment()``) and
``stats()`` (occupancy, error counters) — the report has the JAX
package's keys.
"""

from __future__ import annotations

import time
from typing import Any, Mapping

import numpy as np

from euromillioner_tpu_torch.obs.metrics import percentile
from euromillioner_tpu_torch.obs.workload import Trace, TraceEvent
from euromillioner_tpu_torch.resilience import fault_point
from euromillioner_tpu_torch.utils.errors import ServeError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("obs.replay")


def payload_for(event: TraceEvent, engine: Any) -> np.ndarray:
    """The event's request payload, regenerated from its seed: a
    ``(steps, feat_dim)`` sequence for sequence engines, ``(rows,
    *feat_shape)`` independent rows otherwise. Deterministic — the
    trace pins the workload's bytes, not just its shape."""
    rng = np.random.default_rng(event.seed)
    if getattr(engine, "kind", "rows") == "sequence":
        steps = event.steps or event.rows
        return rng.normal(size=(steps, engine.backend.feat_dim)).astype(
            np.float32)
    rows = event.rows or event.steps
    feat = tuple(engine.session.backend.feat_shape)
    return rng.normal(size=(rows, *feat)).astype(np.float32)


def _lag_stats(lags: list[float]) -> dict:
    s = sorted(lags)
    return {"lag_p50_ms": round(percentile(s, 0.50) * 1e3, 3),
            "lag_p99_ms": round(percentile(s, 0.99) * 1e3, 3),
            "lag_max_ms": round((s[-1] if s else 0.0) * 1e3, 3)}


def replay_trace(engines, trace: Trace, *, speed: float = 1.0,
                 fifo: bool = False, collect: bool = False,
                 timeout_s: float = 300.0) -> dict:
    """Replay ``trace`` open-loop and return the attainment report.

    ``engines`` is one engine or a ``{family: engine}`` mapping (a bare
    engine serves every family in the trace). ``speed`` scales the
    clock (2.0 = twice as fast). ``fifo=True`` strips class tags AND
    explicit deadlines from every submit — the classless baseline a
    class-aware run compares against, on byte-identical arrivals.
    ``collect=True`` adds per-event ``outputs`` (None for failed
    events) for bit-identity pins. ``timeout_s`` bounds the post-replay
    drain wait per event."""
    if speed <= 0:
        raise ServeError(f"replay speed must be > 0, got {speed}")
    if isinstance(engines, Mapping):
        emap = dict(engines)
        missing = [f for f in trace.families if f not in emap]
        if missing:
            raise ServeError(
                f"trace mixes families {list(trace.families)} but no "
                f"engine serves {missing} — pass an engine per family")
    else:
        emap = {f: engines for f in trace.families}
    events = trace.events
    n = len(events)
    done_t: list[float | None] = [None] * n
    sub_t: list[float] = [0.0] * n
    futures: list[Any] = [None] * n
    lags: list[float] = []
    submit_errors = 0

    def _mark(i: int):
        def cb(_f) -> None:
            done_t[i] = time.monotonic()
        return cb

    t0 = time.monotonic()
    for i, ev in enumerate(events):
        target = t0 + ev.t / speed
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        now = time.monotonic()
        lags.append(max(0.0, now - target))
        sub_t[i] = now
        eng = emap[ev.family]
        cls = None if fifo else ev.cls
        mws = None if fifo or ev.deadline_ms is None \
            else ev.deadline_ms / 1e3
        try:
            # the chaos hook: a fire fails ONLY this event — the loop
            # (and with it the clock) continues to the next arrival
            fault_point("serve.replay", event=i, family=ev.family,
                        cls=ev.cls)
            x = payload_for(ev, eng)
            fut = eng.submit(x, max_wait_s=mws, cls=cls)
        except Exception as e:  # noqa: BLE001 — fail the event, keep the clock
            submit_errors += 1
            logger.warning("replay event %d (%s/%s) failed to submit: "
                           "%r", i, ev.family, ev.cls, e)
            continue
        fut.add_done_callback(_mark(i))
        futures[i] = fut
    submit_wall = time.monotonic() - t0

    # drain: wait out every in-flight future (open loop ends here)
    outputs: list[Any] = [None] * n
    ok = [False] * n
    future_errors = 0
    completed = 0
    for i, fut in enumerate(futures):
        if fut is None:
            continue
        try:
            out = fut.result(timeout=timeout_s)
        except Exception:  # noqa: BLE001 — engine-side failure: count it
            future_errors += 1
            continue
        ok[i] = True
        completed += 1
        if collect:
            outputs[i] = out
    wall = time.monotonic() - t0

    by_cls: dict[str, dict[str, list[float]]] = {}
    for i, ev in enumerate(events):
        slot = by_cls.setdefault(ev.cls, {"lat": [], "n": []})
        slot["n"].append(i)
        # only SUCCESSFUL completions feed the per-class latencies —
        # an exception-resolved future also fires the done callback,
        # and its error-resolution time must not pollute the p99s
        if ok[i] and done_t[i] is not None:
            slot["lat"].append(done_t[i] - sub_t[i])
    classes = {}
    for cls, slot in sorted(by_cls.items()):
        lat = sorted(slot["lat"])
        classes[cls] = {"events": len(slot["n"]),
                        "completed": len(lat),
                        "p50_ms": round(percentile(lat, 0.50) * 1e3, 3),
                        "p99_ms": round(percentile(lat, 0.99) * 1e3, 3)}

    # the obs-registry view per engine: SLO attainment (the judgment
    # signal), engine error counters, occupancy where the engine has it
    engines_out: dict[str, dict] = {}
    seen: dict[int, str] = {}
    for fam, eng in emap.items():
        if id(eng) in seen:
            engines_out[fam] = {"same_as": seen[id(eng)]}
            continue
        seen[id(eng)] = fam
        st = eng.stats()
        entry: dict = {"slo": eng.telemetry.attainment(),
                       "errors": int(st.get("errors", 0))}
        if "mean_occupancy" in st:
            entry["mean_occupancy"] = st["mean_occupancy"]
        engines_out[fam] = entry

    report: dict = {
        "trace": trace.name,
        "generator": trace.meta.get("generator"),
        "events": n, "speed": speed, "fifo": fifo,
        "submitted": n - submit_errors,
        "completed": completed,
        "errors": submit_errors + future_errors,
        "duration_s": round(trace.duration_s / speed, 3),
        "submit_wall_s": round(submit_wall, 3),
        "wall_s": round(wall, 3),
        "clock": _lag_stats(lags),
        "classes": classes,
        "engines": engines_out,
    }
    if collect:
        report["outputs"] = outputs
    return report

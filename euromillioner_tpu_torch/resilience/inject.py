"""Deterministic fault injection: seeded schedules, named injection points.

The reference cannot be failure-tested at all — every error collapses into
one catch-all that logs "Could not access URL" and exits 0
(Main.java:36,144-147), so no failure path is distinguishable from any
other. SURVEY.md §5 specifies the opposite (structured errors, heartbeats,
restart-from-checkpoint); this module is the harness that *exercises* those
paths under controlled, reproducible faults.

Model
-----
Host-side control paths declare **named injection points**::

    fault_point("checkpoint.save.post", step=step, path=target)

A test activates a :class:`FaultPlan` — a list of :class:`FaultSpec`
schedules — with the :func:`inject` context manager. Each spec selects a
point by name and fires at explicit 1-based hit ordinals (``hits=(2, 3)``),
or on every hit, optionally thinned by a **seeded** Bernoulli draw
(``probability``) so stochastic storms replay identically for a given seed
and call sequence. Firing raises a caller-supplied exception (transient
crash), runs a side-effect ``action`` against the call context (e.g.
truncate the checkpoint file just written), or both.

Zero-cost when disabled: :func:`fault_point` is a module-global ``None``
check and immediate return — no allocation, no locking, no logging — so the
points can live on per-step training and serving paths.

Registered points (grep ``fault_point(`` for ground truth), the JAX
package's 31:

========================  ====================================================
``fetch.request``         before each HTTP attempt (``data/fetch.py``)
``pipeline.from_url``     entry of the URL pipeline (``data/pipeline.py``)
``pipeline.cache_write``  before the stale-cache snapshot write
``checkpoint.save.write`` before this process writes its array shard
``checkpoint.save.post``  after the atomic rename; ctx carries ``path``
``checkpoint.load``       before restore reads the manifest
``train.step``            before each train step (host loop)
``train.epoch_end``       after each epoch's batch loop
``heartbeat.beat``        inside ``Heartbeat.beat`` (background thread)
``supervisor.attempt``    each ``run_with_restart`` attempt
``serve.request``         each engine ``submit`` (serve/engine.py)
``serve.dispatch``        before each micro-batch dispatch (dispatcher
                          thread); a fire fails that batch's futures and
                          the engine keeps serving
``serve.admit``           each admission from the step scheduler's heap
                          into a slot or the paged live set; a fire fails
                          ONLY that request and admission goes on
``serve.step``            before each slot-pool step of the continuous
                          sequence scheduler (serve/continuous.py); a
                          fire fails ONLY the sequences holding slots —
                          queued sequences admit afterwards and complete,
                          and the pool rebuilds leak-free
``serve.quant``           before the restore-time cast/quantize of a
                          non-f32 ``serve.precision`` profile
                          (serve/session.py, serve/continuous.py); a
                          fire falls the session back to the f32 params,
                          logged once — requests still complete,
                          bit-equal to the f32 oracle
``serve.trace``           inside telemetry recording — span creation/
                          stamping, per-batch span materialization
                          (``record_batch``), AND JSONL emitter writes
                          (obs/telemetry.py); telemetry is best-effort
                          by construction, so a fire NEVER fails a
                          request:
                          a span fault is swallowed, an emitter fault
                          disables the sink with a one-shot warning.
                          Chaos-tested: a storm of trace faults leaves
                          serving outputs bit-identical and the engine
                          leak-free
``serve.preempt``         around the victim's device→host state gather
                          when a slot is preempted or a shrinking pool
                          evicts an occupied slot
                          (serve/continuous.py); a fire loses ONLY the
                          victim (its future carries the exception) —
                          the slot is freed, the pool keeps serving,
                          and a fault-free rerun is bit-identical
``serve.shard``           before a meshed session's or step scheduler's
                          per-shard upload of a micro-batch or block
                          (serve/session.py ``ModelSession.put_rows``,
                          serve/continuous.py, only with ``serve.mesh``);
                          a fire fails ONLY that batch (the step
                          scheduler: the slot-holding sequences, and the
                          pool rebuilds) and serving goes on
``serve.resize``          before an elastic slot-pool resize commits
                          (serve/continuous.py); a fire aborts ONLY
                          that resize — the pool keeps serving at its
                          old size and the policy retries at a later
                          block boundary
``serve.spill``           around the spill-tier blob write when the
                          budget governor moves a cold parked eviction
                          blob to disk (serve/continuous.py); a fire
                          loses ONLY that victim (counted, its RAM is
                          freed) — the pool keeps serving. A CORRUPTED
                          spill blob is the read-side failure: the
                          crc32 verify fails at restore and that
                          sequence is shed loudly
``serve.page``            before a parked sequence's promotion scatter
                          into its page row (serve/continuous.py
                          ``_schedule_rows``, only while
                          ``serve.paging.enabled``); a fire sheds ONLY
                          that sequence (its future carries the error,
                          its row frees, its parked bytes — RAM or
                          spill file — unpark) and the block
                          dispatches without it; the page store stays
                          leak-free and a fault-free rerun is
                          bit-identical
``serve.budget``          inside the memory governor's front-door
                          admission check (serve/engine.py submit +
                          serve/continuous.py submit, only while
                          serve.budget.enabled); a fire rejects ONLY
                          the request being admitted — the engine keeps
                          serving and a fault-free rerun is
                          bit-identical
``serve.aot``             on each AOT store load and save
                          (serve/aotstore.py); a fire on load is a
                          counted miss (the program compiles afresh, the
                          healthy blob stays), on save the entry is
                          skipped — serving goes on either way
``serve.chunk``           before each chunk of the chunked tree-ensemble
                          dispatch (serve/session.py
                          ``_TreeBackend._dispatch_chunked``, only while
                          ``serve.trees.chunk`` routes a backend
                          chunked); a fire fails ONLY that micro-batch's
                          requests — the device carry is dropped, the
                          ``tree_tables`` window unwinds and the engine
                          keeps serving
``serve.replay``          around each trace event's submission in the
                          open-loop replay loop (obs/replay.py); a
                          fire fails ONLY that event — the clock keeps
                          running
``fleet.probe``           each health-probe attempt of the router's
                          probe loop (serve/fleet.py HealthMonitor); a
                          fire is a failed probe — it counts toward the
                          staleness ejection and the loop keeps running
``fleet.route``           each dispatch attempt of the fleet router
                          (serve/router.py); a fire fails only that
                          attempt — the request re-routes like any host
                          failure (up to max_route_attempts)
``fleet.rollout``         around the candidate submit of the versioned
                          rollout (serve/rollout.py), shadow and canary;
                          a fire is a candidate error (a gate breach
                          rolls back) and the client request completes
                          on the stable version
``fleet.spawn``           each host-spawn attempt of the fleet supervisor
                          (serve/supervisor.py), respawn and scale-up; a
                          fire fails only that attempt (retried with
                          backoff; an exhausted cycle is a crash-loop
                          strike)
``fleet.scale``           before a committed autoscale decision of the
                          supervisor; a fire aborts only that decision —
                          the next tick decides afresh
``fleet.migrate``         around the ship step of one live migration
                          (serve/router.py migrate, after the export,
                          before the destination's import); a fire loses
                          only that migration — the source re-imports its
                          blob and the sequence finishes where it was,
                          bit-identical
========================  ====================================================

While a plan is active, every visit and fire also lands in the obs
global registry (``resilience_fault_visits_total`` /
``resilience_faults_fired_total{point=...}``, obs/metrics.py) so
``GET /metrics`` exposes chaos activity; the disabled path stays the
same single load + is-None test — zero bookkeeping when no plan runs.
"""

from __future__ import annotations

import random
import threading
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Sequence

from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("resilience.inject")

# Exception class/instance, or a zero-arg factory returning an instance.
Raisable = Any


# (metric, point) → resolved counter child: fault points sit on serving
# hot paths, so the family/labels resolution happens once per pair, not
# per visit (the obs registry's resolve-children-once contract).
_REGISTRY_CHILDREN: dict[tuple[str, str], Any] = {}


def _registry_count(metric: str, point: str) -> None:
    """Count a fault-point visit/fire in the obs GLOBAL registry (GET
    /metrics renders it next to the engine's own families). Only runs
    while a plan is active — the disabled fault_point path never gets
    here — and never raises into the instrumented code path."""
    try:
        child = _REGISTRY_CHILDREN.get((metric, point))
        if child is None:
            from euromillioner_tpu_torch.obs.metrics import global_registry

            child = global_registry().counter(
                metric, "Fault-injection point activity while a "
                        "FaultPlan is active", ("point",)).labels(point)
            _REGISTRY_CHILDREN[(metric, point)] = child
        child.inc()
    except Exception:  # noqa: BLE001 — observability must not fault the fault
        pass


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    point        injection-point name (exact match).
    raises       exception to raise when firing: a BaseException subclass
                 (instantiated with an "injected fault" message), an
                 instance (raised as-is), or a zero-arg factory.
    action       side-effect run with the point's context dict before any
                 raise — e.g. ``lambda ctx: _truncate(ctx["path"])``.
    hits         1-based visit ordinals (counted per point, across the
                 plan's whole lifetime) at which to fire; ``None`` fires on
                 every visit, subject to ``probability`` and ``times``.
    probability  seeded Bernoulli thinning for ``hits=None`` storms.
    times        cap on total fires for this spec; ``None`` = unbounded.
    """

    point: str
    raises: Raisable | None = None
    action: Callable[[dict[str, Any]], None] | None = None
    hits: tuple[int, ...] | None = None
    probability: float = 1.0
    times: int | None = None

    def build_exception(self, hit: int) -> BaseException | None:
        r = self.raises
        if r is None:
            return None
        if isinstance(r, BaseException):
            return r
        if isinstance(r, type) and issubclass(r, BaseException):
            return r(f"injected fault at {self.point} (hit {hit})")
        return r()  # factory


class FaultPlan:
    """A seeded, deterministic fault schedule.

    Bookkeeping is lock-protected (heartbeat points fire from background
    threads); given the same specs, seed, and per-point visit sequence, the
    fired set is identical across runs. ``fired`` records ``(point, hit)``
    pairs for test assertions; ``fired_count(point)`` is the usual query.
    """

    def __init__(self, specs: Sequence[FaultSpec], *, seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.visits: Counter[str] = Counter()
        self.fired: list[tuple[str, int]] = []
        self._spec_fires = [0] * len(self.specs)

    def fired_count(self, point: str) -> int:
        with self._lock:
            return sum(1 for p, _ in self.fired if p == point)

    def visit(self, point: str, ctx: dict[str, Any]) -> None:
        """Record a visit to ``point`` and fire any matching spec.

        At most one spec fires per visit (first match in plan order), so a
        raise cannot mask a later spec's bookkeeping mid-visit.
        """
        _registry_count("resilience_fault_visits_total", point)
        with self._lock:
            self.visits[point] += 1
            hit = self.visits[point]
            chosen: FaultSpec | None = None
            for i, spec in enumerate(self.specs):
                if spec.point != point:
                    continue
                if spec.times is not None and self._spec_fires[i] >= spec.times:
                    continue
                if spec.hits is not None and hit not in spec.hits:
                    continue
                if spec.probability < 1.0 and self._rng.random() >= spec.probability:
                    continue
                self._spec_fires[i] += 1
                self.fired.append((point, hit))
                chosen = spec
                break
        if chosen is None:
            return
        _registry_count("resilience_faults_fired_total", point)
        # Side effects and raises run outside the lock: an action may itself
        # traverse code containing fault points.
        if chosen.action is not None:
            chosen.action(dict(ctx))
        exc = chosen.build_exception(hit)
        if exc is not None:
            logger.warning("FAULT injected at %s (hit %d): %r", point, hit, exc)
            raise exc
        logger.warning("FAULT injected at %s (hit %d): action ran", point, hit)


# The active plan. Plain module global read without a lock: fault_point is on
# per-train-step host paths and must stay a single load + is-None test when
# injection is off.
_PLAN: FaultPlan | None = None


def fault_point(name: str, /, **ctx: Any) -> None:
    """Declare a named injection point. No-op unless a plan is active.
    ``name`` is positional-only so context keys (``name=``, ``step=``…)
    never collide with it."""
    plan = _PLAN
    if plan is None:
        return
    plan.visit(name, ctx)


def active_plan() -> FaultPlan | None:
    return _PLAN


@contextmanager
def inject(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Activate ``plan`` for the dynamic extent of the block.

    Plans do not nest — chaos scenarios compose by listing specs in one
    plan, keeping the fired schedule a single deterministic sequence.
    """
    global _PLAN
    if _PLAN is not None:
        raise RuntimeError("a FaultPlan is already active; plans do not nest")
    _PLAN = plan
    try:
        yield plan
    finally:
        _PLAN = None

"""FleetRouter: one front end over many serving hosts (the JAX package's
``serve/router.py``).

The router owns admission for the whole fleet — the (class priority,
deadline, arrival) heap the schedulers use — and three duties no single
host can have:

* **Placement with per-sequence affinity.** Each sequence is routed to one
  host at dispatch (slot pools are per host), round-robin over the
  admitted hosts; row requests load-balance freely. :meth:`migrate` moves
  affinity mid-sequence: it exports the live state as a stamped blob and
  re-admits it on another host (serve.fleet.migrate; the drain, eject and
  respawn paths below use it). With no host admitted, requests wait in
  the admission heap and dispatch the moment one recovers.
* **Drain and re-route.** A host ejection (serve/fleet.py HealthMonitor:
  SLO-attainment collapse or probe staleness) drains every incomplete
  request on that host: a reachable host's live sequences migrate first
  (``migrate_on_eject``); the rest are re-dispatched to another host
  through the same client future (``_finish`` absorbs the race when a
  presumed-dead host answers after the re-route). A host-side failure
  re-routes the same way, up to ``max_route_attempts`` attempts; SLO
  judging always uses the original admission time. Every host serves the
  same checkpoint through the same programs, so a re-routed sequence
  completes bit-identical to an unfaulted run — on hosts whose pools step
  at the same row count (``max_slots``): on the card the block program is
  not bit-equal across row counts.
* **Restart without loss.** The ledger of admitted, incomplete requests
  snapshots (:meth:`snapshot`); a router built with ``resume=`` re-admits
  every entry against the same client futures.

The ``fleet.route`` fault point covers each dispatch attempt: a fire fails
only that attempt and the request re-routes like any host failure. The
router's telemetry (serve/fleet.py ``FleetTelemetry``) serves
``/metrics``, ``/healthz`` (per host: admitted, attainment, queue) and
``/stats`` through the unchanged transport: ``make_server(router, host,
port)`` is the fleet front end.
"""

from __future__ import annotations

import collections
import heapq
import itertools
import math
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from euromillioner_tpu_torch.obs.metrics import percentile
from euromillioner_tpu_torch.resilience import fault_point
from euromillioner_tpu_torch.serve.batcher import (LATENCY_WINDOW,
                                                   resolve_future)
from euromillioner_tpu_torch.serve.engine import (ClassStats,
                                                  resolve_classes,
                                                  resolve_request_class)
from euromillioner_tpu_torch.serve.fleet import (FleetHost,
                                                 FleetTelemetry,
                                                 HealthMonitor, HostState,
                                                 ProbePolicy)
from euromillioner_tpu_torch.utils.errors import ServeError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("serve.router")


@dataclass
class _Entry:
    """One admitted request in the router ledger. ``attempt`` guards the
    done-callback against stale resolutions: a drain bumps it, so a
    presumed-dead host's late answer for an old attempt is ignored."""

    rid: int
    x: np.ndarray
    cls: str
    priority: int
    max_wait_s: float | None
    deadline: float                 # absolute monotonic; inf = none
    future: Future
    t_submit: float
    host: str | None = None
    hfut: Future | None = None      # the serving host's engine future
    attempt: int = 0
    attempts_used: int = 0
    done: bool = False


class FleetRouter:
    """Route requests over a fleet of :class:`~euromillioner_tpu_torch.
    serve.fleet.FleetHost` s with health-keyed ejection and re-route.

    ``hosts`` must serve the SAME model kind (all sequence or all row
    engines — the fleet is homogeneous by construction; a heterogeneous
    fleet is two routers). ``slo_ms`` gives per-class default deadlines
    for router-side attainment judging, aligned by position with
    ``classes`` exactly like ``serve.obs.slo_ms``.

    ``start=False`` defers the probe loop — the deterministic hook
    chaos tests use (drive rounds via ``monitor.probe_once()``)."""

    def __init__(self, hosts: Sequence[FleetHost], *,
                 classes: Sequence[str] = ("interactive", "bulk"),
                 policy: ProbePolicy | None = None,
                 slo_ms: Sequence[float] = (),
                 max_route_attempts: int = 3,
                 max_pending: int = 4096,
                 migrate_on_eject: bool = True,
                 migrate_export_timeout_s: float = 30.0,
                 resume: Sequence[dict] | None = None,
                 start: bool = True):
        if not hosts:
            raise ServeError("a fleet needs at least one host")
        names = [h.name for h in hosts]
        if len(set(names)) != len(names):
            raise ServeError(f"duplicate host names: {names}")
        kinds = {h.kind for h in hosts}
        if len(kinds) > 1:
            raise ServeError(
                f"fleet hosts must serve one model kind, got {sorted(kinds)}"
                " — run one router per kind")
        if max_route_attempts < 1:
            raise ServeError("max_route_attempts must be >= 1, got "
                             f"{max_route_attempts}")
        if max_pending < 1:
            raise ServeError(f"max_pending must be >= 1, got "
                             f"{max_pending}")
        self._class_priority = resolve_classes(classes)
        self.classes = tuple(self._class_priority)
        if len(slo_ms) > len(self.classes):
            raise ServeError(
                f"slo_ms has {len(slo_ms)} entries for "
                f"{len(self.classes)} classes — at most one per class")
        self._slo_default = {c: float(ms) / 1e3
                             for c, ms in zip(self.classes, slo_ms)}
        self.kind = hosts[0].kind
        self.max_route_attempts = int(max_route_attempts)
        self.max_pending = int(max_pending)
        # serve.fleet.migrate.eject: an SLO ejection of a REACHABLE host
        # migrates its live sequences bit-exact instead of restarting
        # them from step 0 (stale-probe ejections cannot — the host
        # does not answer its export surface)
        self.migrate_on_eject = bool(migrate_on_eject)
        self.migrate_export_timeout_s = float(migrate_export_timeout_s)
        self.policy = policy or ProbePolicy()
        self.telemetry = FleetTelemetry(self.classes)
        self.telemetry.health_fn = self._health
        self._states = {h.name: HostState(host=h) for h in hosts}
        self._order = list(self._states)          # round-robin order
        self._rr = itertools.count()
        self._lock = threading.Lock()
        self._ledger: dict[int, _Entry] = {}
        self._next_rid = 0
        self._heap: list[tuple[int, float, int, int]] = []  # admission heap
        self._heap_seq = 0
        self._closed = False
        # a FleetSupervisor (serve/supervisor.py) attaches itself here:
        # its lifecycle view rides /healthz and `release_host` reaches it
        self.supervisor = None
        self._latencies: collections.deque = collections.deque(
            maxlen=LATENCY_WINDOW)
        self._cls_stats = ClassStats(self.classes)
        self._t_start = time.monotonic()
        self.telemetry.registry.gauge(
            "fleet_pending", "Requests waiting in the admission heap "
            "(no admitted host)").labels().set_function(
            lambda: self.pending)
        self.telemetry.registry.gauge(
            "fleet_hosts_admitted", "Hosts currently admitted").labels(
            ).set_function(lambda: len(self._admitted_names()))
        self.monitor = HealthMonitor(
            list(self._states.values()), self.policy, self.telemetry,
            self.classes, on_eject=self._on_eject,
            on_readmit=self._on_readmit)
        if resume:
            self._resume(resume)
        if start:
            self.monitor.start()

    # -- engine-surface passthroughs (transport/replay compatibility) ----
    @property
    def backend(self):
        """The first host engine's backend — what the replay driver
        reads payload shapes from (in-process fleets only)."""
        eng = self._states[self._order[0]].host.engine
        return getattr(eng, "backend", None)

    @property
    def session(self):
        eng = self._states[self._order[0]].host.engine
        return getattr(eng, "session", None)

    @property
    def slo_desc(self) -> dict:
        return {"classes": list(self.classes)}

    @property
    def load_desc(self) -> dict:
        return {"pending": self.pending,
                "hosts_admitted": len(self._admitted_names()),
                "hosts": len(self._states)}

    # -- request side -----------------------------------------------------
    def submit(self, x: np.ndarray, max_wait_s: float | None = None,
               cls: str | None = None) -> Future:
        """Admit one request and route it. The client future resolves
        with the serving host's result — or, after a host failure or
        ejection, with a re-routed attempt's (same future; the client
        never sees the re-route)."""
        cls, prio = resolve_request_class(self._class_priority, cls)
        x = np.asarray(x, np.float32)
        now = time.monotonic()
        deadline = math.inf
        if max_wait_s is not None:
            deadline = now + max(0.0, float(max_wait_s))
        elif cls in self._slo_default:
            deadline = now + self._slo_default[cls]
        entry = _Entry(rid=0, x=x, cls=cls, priority=prio,
                       max_wait_s=max_wait_s, deadline=deadline,
                       future=Future(), t_submit=now)
        with self._lock:
            if self._closed:
                raise ServeError("router is closed; request rejected")
            entry.rid = self._next_rid
            self._next_rid += 1
            self._ledger[entry.rid] = entry
        self.telemetry.requests.inc()
        self._dispatch(entry)
        return entry.future

    def predict(self, x: np.ndarray, max_wait_s: float | None = None,
                cls: str | None = None) -> np.ndarray:
        return self.submit(x, max_wait_s=max_wait_s, cls=cls).result()

    # -- placement --------------------------------------------------------
    def _admitted_names(self) -> list[str]:
        # snapshot + .get: callers include lock-free readers (gauges,
        # load_desc, _health) that can race a supervisor-driven
        # finish_retire removing a host at runtime
        states = self._states
        out = []
        for n in list(self._order):
            hs = states.get(n)
            if hs is not None and hs.admitted:
                out.append(n)
        return out

    def _pick_host(self, exclude: str | None) -> HostState | None:
        """Round-robin over admitted hosts, skipping ``exclude`` (the
        host a re-route just failed on) unless it is the only one."""
        avail = self._admitted_names()
        if exclude is not None and len(avail) > 1:
            avail = [n for n in avail if n != exclude]
        if not avail:
            return None
        return self._states[avail[next(self._rr) % len(avail)]]

    def _dispatch(self, entry: _Entry, exclude: str | None = None) -> None:
        """Route one ledger entry to a host, or park it in the admission
        heap when no host is admitted — the heap is BOUNDED
        (``max_pending``): past the bound a new arrival is shed loudly
        (its future fails, ``fleet_shed_total`` counts it) instead of
        growing without limit through a long outage. Runs WITHOUT the
        router lock held around host.submit — engine submit paths take
        their own locks and their done-callbacks re-enter this
        router."""
        while True:
            with self._lock:
                if entry.done:
                    return
                hs = self._pick_host(exclude)
                if hs is None:
                    if len(self._heap) >= self.max_pending:
                        attempt = entry.attempt
                        shed = True
                    else:
                        heapq.heappush(self._heap,
                                       (entry.priority, entry.deadline,
                                        self._heap_seq, entry.rid))
                        self._heap_seq += 1
                        return
                else:
                    shed = False
                    entry.host = hs.name
                    entry.attempt += 1
                    entry.attempts_used += 1
                    attempt = entry.attempt
            if shed:
                logger.warning(
                    "shedding request %d (%s): admission queue full "
                    "(max_pending=%d) during a fleet-wide outage",
                    entry.rid, entry.cls, self.max_pending)
                self.telemetry.shed.inc()
                self._finish(entry, attempt, exc=ServeError(
                    f"admission queue full (max_pending="
                    f"{self.max_pending}) during a fleet-wide outage; "
                    "request shed"))
                return
            try:
                # the chaos hook: a fired fault fails only THIS attempt
                fault_point("fleet.route", host=hs.name, cls=entry.cls,
                            attempt=entry.attempts_used)
                hfut = hs.host.submit(entry.x,
                                      max_wait_s=entry.max_wait_s,
                                      cls=entry.cls)
            except Exception as e:  # noqa: BLE001 — try the next host
                if entry.attempts_used >= self.max_route_attempts:
                    self._finish(entry, attempt, exc=e)
                    return
                self.telemetry.rerouted.inc()
                exclude = hs.name
                continue
            entry.hfut = hfut  # the migrate surface exports by this handle
            hfut.add_done_callback(self._on_host_done(entry.rid, attempt))
            return

    def _on_host_done(self, rid: int, attempt: int):
        def cb(fut: Future) -> None:
            with self._lock:
                entry = self._ledger.get(rid)
                if entry is None or entry.done or entry.attempt != attempt:
                    return  # resolved, or re-routed past this attempt
            exc = fut.exception()
            if exc is None:
                self._finish(entry, attempt, value=fut.result())
                return
            if (entry.attempts_used < self.max_route_attempts
                    and not self._closed):
                logger.warning("host %s failed request %d (%r); "
                               "re-routing", entry.host, rid, exc)
                self.telemetry.rerouted.inc()
                self._dispatch(entry, exclude=entry.host)
            else:
                self._finish(entry, attempt, exc=exc)
        return cb

    def _finish(self, entry: _Entry, attempt: int, value=None,
                exc: BaseException | None = None) -> None:
        now = time.monotonic()
        with self._lock:
            if entry.done or entry.attempt != attempt:
                return
            entry.done = True
            self._ledger.pop(entry.rid, None)
            if exc is None:
                self._latencies.append(now - entry.t_submit)
                self._cls_stats.observe(entry.cls, now - entry.t_submit)
        tm = self.telemetry
        if exc is None:
            # SLO judged at the ROUTER's admission clock: a re-routed
            # request that blew its deadline is a miss, not a restart
            if entry.deadline != math.inf:
                tm.judge(entry.cls, now <= entry.deadline)
            tm.completed.inc()
            resolve_future(entry.future, value)
        else:
            if entry.deadline != math.inf:
                tm.judge(entry.cls, False)
            tm.failed.inc()
            resolve_future(entry.future, exc=exc)

    # -- live migration (serve.fleet.migrate) ------------------------------
    def migrate(self, rid: int, dst: str | None = None,
                reason: str = "drain") -> bool:
        """Move one in-flight sequence to another admitted host as a
        bit-exact state transfer: export-and-pack on the source, ship
        the stamped wire blob, import under the sequence's ORIGINAL
        (class, deadline, arrival) ordering on the destination. Returns
        True when the request now runs on ``dst``. False is never a
        client-visible failure: the sequence either completed during
        the export, keeps running where it is (no destination, no
        export surface), re-parks on the SOURCE after a failed ship
        (the ``fleet.migrate`` loss model — a fire loses only the
        in-flight migration), or re-dispatches from step 0 as the last
        resort."""
        t0 = time.monotonic()
        with self._lock:
            entry = self._ledger.get(rid)
            if (entry is None or entry.done or entry.host is None
                    or entry.hfut is None):
                return False
            src = self._states.get(entry.host)
            if src is None:
                return False
            if dst is not None:
                dst_hs = self._states.get(dst)
                if (dst_hs is None or not dst_hs.admitted
                        or dst_hs.name == entry.host):
                    return False
            else:
                avail = [n for n in self._admitted_names()
                         if n != entry.host]
                if not avail:
                    return False
                dst_hs = self._states[avail[next(self._rr) % len(avail)]]
            # invalidate the source-attempt callback: from here on the
            # source future resolves with the export shed, not a result
            entry.attempt += 1
            attempt = entry.attempt
            hfut = entry.hfut
        try:
            blob = src.host.export_sequence(
                hfut, reason=reason,
                timeout_s=self.migrate_export_timeout_s)
        except Exception as e:  # noqa: BLE001 — export is best-effort
            logger.warning("migrate: export of request %d off host %s "
                           "failed (%r); it stays put", rid, src.name, e)
            blob = None
        if blob is None:
            # completed mid-export, no export surface, or export timed
            # out — re-hook the (possibly already-resolved) source
            # future under the bumped attempt so its outcome still
            # reaches the client
            hfut.add_done_callback(self._on_host_done(rid, attempt))
            return False
        try:
            # the chaos hook: a fired fault loses ONLY this in-flight
            # migration (the blob re-parks on the source below)
            fault_point("fleet.migrate", src=src.name, dst=dst_hs.name,
                        reason=reason, nbytes=len(blob))
            nfut = dst_hs.host.import_sequence(blob)
        except Exception as e:  # noqa: BLE001 — ship/import failed
            logger.warning(
                "migrate: shipping request %d %s->%s failed (%r); "
                "re-parking the blob on the source", rid, src.name,
                dst_hs.name, e)
            try:
                nfut = src.host.import_sequence(blob)
            except Exception as e2:  # noqa: BLE001 — last resort
                logger.warning(
                    "migrate: source re-import of request %d also "
                    "failed (%r); re-dispatching from step 0", rid, e2)
                self.telemetry.rerouted.inc()
                self._dispatch(entry, exclude=dst_hs.name)
                return False
            with self._lock:
                entry.hfut = nfut  # entry.host unchanged: still src
            nfut.add_done_callback(self._on_host_done(rid, attempt))
            return False
        with self._lock:
            entry.host = dst_hs.name
            entry.hfut = nfut
        nfut.add_done_callback(self._on_host_done(rid, attempt))
        tm = self.telemetry
        tm.migrations(reason).inc()
        tm.migration_latency.observe(time.monotonic() - t0)
        tm.migration_bytes.inc(len(blob))
        return True

    def migrate_host(self, name: str, dst: str | None = None,
                     reason: str = "drain") -> int:
        """Migrate every incomplete request assigned to ``name`` onto
        other admitted hosts (supervisor scale-down drain; SLO
        ejection). Returns the number moved — a request that could not
        move keeps running on ``name`` and drains the slow way."""
        with self._lock:
            rids = [e.rid for e in self._ledger.values()
                    if e.host == name and not e.done]
        moved = 0
        for rid in rids:
            if self.migrate(rid, dst=dst, reason=reason):
                moved += 1
        if moved:
            logger.info("migrated %d live sequence(s) off host %s (%s)",
                        moved, name, reason)
        return moved

    def export_host_entries(self, name: str, *,
                            reason: str = "respawn"
                            ) -> list[tuple[int, bytes]]:
        """Export every incomplete request assigned to ``name`` into
        ``(rid, blob)`` pairs WITHOUT re-routing them — the single-host
        restart path (supervisor ``restart_host``), where no admitted
        peer exists to :meth:`migrate` to. Each export bumps the
        entry's attempt exactly like ``migrate`` (the old engine's
        callback is invalidated, so the export-shed error never
        reaches the client nor triggers a step-0 re-dispatch beside
        the restored run). The paired
        :meth:`reimport_host_entries` re-hooks each entry onto its
        restored sequence in the respawned engine; an entry whose
        export returned None (finished mid-drain, no surface) re-hooks
        its old future and is not returned."""
        with self._lock:
            hs = self._states.get(name)
            entries = [e for e in self._ledger.values()
                       if e.host == name and not e.done
                       and e.hfut is not None]
        if hs is None:
            return []
        out: list[tuple[int, bytes]] = []
        for e in entries:
            with self._lock:
                if e.done or e.hfut is None:
                    continue
                e.attempt += 1
                attempt = e.attempt
                hfut = e.hfut
            try:
                blob = hs.host.export_sequence(
                    hfut, reason=reason,
                    timeout_s=self.migrate_export_timeout_s)
            except Exception as exc:  # noqa: BLE001 — best-effort
                logger.warning("restart export of request %d off host "
                               "%s failed (%r); it re-routes", e.rid,
                               name, exc)
                blob = None
            if blob is None:
                hfut.add_done_callback(
                    self._on_host_done(e.rid, attempt))
                continue
            out.append((e.rid, blob))
        return out

    def reimport_host_entries(self, name: str,
                              exported: Sequence[tuple[int, bytes]]
                              ) -> int:
        """Restore :meth:`export_host_entries` blobs into the (freshly
        respawned) engine behind ``name`` and re-hook each request's
        client future onto its resumed sequence — these rids are
        therefore EXCLUDED from any step-0 re-route: the restored run
        is the only compute. A rejected import (header mismatch, dead
        engine) falls back to a normal re-dispatch. Returns the number
        re-hooked."""
        with self._lock:
            hs = self._states.get(name)
        restored = 0
        for rid, blob in exported:
            with self._lock:
                e = self._ledger.get(rid)
                if e is None or e.done:
                    continue
                attempt = e.attempt
            nfut = None
            if hs is not None:
                try:
                    nfut = hs.host.import_sequence(blob)
                except Exception as exc:  # noqa: BLE001 — fall back
                    logger.warning(
                        "restart re-import of request %d into host %s "
                        "failed (%r); re-dispatching from step 0", rid,
                        name, exc)
            if nfut is None:
                self.telemetry.rerouted.inc()
                self._dispatch(e)
                continue
            with self._lock:
                e.host = name
                e.hfut = nfut
            nfut.add_done_callback(self._on_host_done(rid, attempt))
            restored += 1
        return restored

    # -- ejection / drain / recovery --------------------------------------
    def _on_eject(self, hs: HostState, reason: str) -> None:
        # a reachable-but-SLO-collapsed host still answers its export
        # surface: move its live sequences bit-exact first; drain
        # re-dispatches (from step 0) only what could not move. A
        # stale-probe ejection skips straight to drain — the host is
        # presumed unreachable.
        if (self.migrate_on_eject and not hs.host.killed
                and not reason.startswith("stale")):
            self.migrate_host(hs.name, reason="eject")
        self.drain(hs.name)

    def _on_readmit(self, hs: HostState) -> None:
        self._drain_heap()

    def drain(self, host_name: str) -> int:
        """Re-dispatch every incomplete request assigned to ``host_name``
        elsewhere (the ejected host may be gone — its in-flight futures
        may never resolve, so drain does not wait for them). Returns the
        number of re-routed requests."""
        with self._lock:
            victims = [e for e in self._ledger.values()
                       if e.host == host_name and not e.done]
            for e in victims:
                e.attempt += 1  # invalidate the dead host's callback
        for e in victims:
            self.telemetry.rerouted.inc()
            self._dispatch(e, exclude=host_name)
        if victims:
            logger.warning("drained %d in-flight request(s) off host %s",
                           len(victims), host_name)
        return len(victims)

    def eject_host(self, name: str, reason: str = "admin") -> None:
        """Administrative ejection (ops surface — the probe policy is
        the normal path). Drains like any ejection; the host re-admits
        through the same recovery probation."""
        hs = self._states[name]
        if not hs.admitted:
            return
        hs.admitted = False
        hs.ejected_reason = reason
        hs.ejections += 1
        self.telemetry.ejections(name, "admin").inc()
        self.drain(name)

    # -- runtime host lifecycle (the supervisor's surface) ----------------
    def add_host(self, host: FleetHost, *, admitted: bool = False) -> None:
        """Register a host at RUNTIME (supervisor scale-up). By default
        the new host enters un-admitted — admission comes exclusively
        from the probe policy observing ``probation_probes`` healthy
        probes, the same door a recovering host walks through (no
        scale-up backdoor past the health policy)."""
        if host.kind != self.kind:
            raise ServeError(
                f"host {host.name!r} serves kind {host.kind!r}; this "
                f"fleet is {self.kind!r}")
        hs = HostState(host=host, admitted=admitted)
        if not admitted:
            hs.ejected_reason = "probation (new host)"
        with self._lock:
            if self._closed:
                raise ServeError("router is closed; host rejected")
            if host.name in self._states:
                raise ServeError(f"duplicate host name: {host.name!r}")
            self._states[host.name] = hs
            self._order.append(host.name)
        self.monitor.add_state(hs)
        logger.info("host %s added to the fleet (%s)", host.name,
                    "admitted" if admitted else "awaiting probation")
        if admitted:
            self._drain_heap()

    def begin_retire(self, name: str) -> None:
        """Start a scale-down DRAIN of ``name``: no new admissions land
        on it (and probation will not re-admit it), but every in-flight
        request it holds completes normally — shrink is never a kill.
        ``finish_retire`` removes it once ``retire_ready``."""
        hs = self._states[name]
        hs.draining = True
        if hs.admitted:
            hs.admitted = False
            hs.ejected_reason = "draining (scale-down)"

    def retire_ready(self, name: str) -> bool:
        """True when no admitted-but-incomplete request is still
        assigned to ``name`` — the drain has fully run out."""
        with self._lock:
            return not any(e.host == name and not e.done
                           for e in self._ledger.values())

    def finish_retire(self, name: str) -> FleetHost:
        """Remove a drained host from the fleet and return it (the
        caller owns closing its engine). Refuses while requests are
        still in flight on it — retiring must never strand work."""
        if not self.retire_ready(name):
            raise ServeError(
                f"host {name} still holds in-flight requests; drain "
                "must run out before retirement")
        with self._lock:
            hs = self._states.pop(name)
            self._order.remove(name)
        self.monitor.remove_state(name)
        logger.info("host %s retired from the fleet", name)
        return hs.host

    def release_host(self, name: str) -> bool:
        """Operator surface (``POST /admin/release`` + the ``fleet
        release`` CLI): lift a supervisor quarantine so the next
        dead-host detection respawns ``name`` again."""
        if self.supervisor is None:
            raise ServeError("this fleet has no supervisor; nothing is "
                             "quarantined")
        return self.supervisor.release(name)

    def _drain_heap(self) -> None:
        """Dispatch parked requests now that a host is admitted, in
        (class priority, deadline, arrival) order — the router-level
        admission moment for requests that arrived during an outage."""
        while True:
            with self._lock:
                if not self._heap or not self._admitted_names():
                    return
                _p, _d, _s, rid = heapq.heappop(self._heap)
                entry = self._ledger.get(rid)
            if entry is not None and not entry.done:
                self._dispatch(entry)

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._heap)

    # -- restart ----------------------------------------------------------
    def snapshot(self) -> list[dict]:
        """Every admitted-but-incomplete request, carrying its ORIGINAL
        submit time and client future — the ledger a restarted router
        resumes from (``FleetRouter(..., resume=snapshot)``)."""
        with self._lock:
            return [{"x": e.x, "cls": e.cls, "max_wait_s": e.max_wait_s,
                     "deadline": e.deadline, "future": e.future,
                     "t_submit": e.t_submit}
                    for e in self._ledger.values() if not e.done]

    def _resume(self, snapshot: Sequence[dict]) -> None:
        entries = []
        with self._lock:
            for item in snapshot:
                cls, prio = resolve_request_class(self._class_priority,
                                                  item["cls"])
                entry = _Entry(
                    rid=self._next_rid, x=np.asarray(item["x"], np.float32),
                    cls=cls, priority=prio,
                    max_wait_s=item.get("max_wait_s"),
                    deadline=item.get("deadline", math.inf),
                    future=item["future"],
                    t_submit=item.get("t_submit", time.monotonic()))
                self._next_rid += 1
                self._ledger[entry.rid] = entry
                entries.append(entry)
        self.telemetry.requests.inc(len(entries))
        for e in entries:
            self._dispatch(e)
        if entries:
            logger.info("resumed %d in-flight request(s) from a router "
                        "snapshot", len(entries))

    def abandon(self) -> list[dict]:
        """Simulate router-process death (the restart chaos tier): take
        a snapshot, then neutralize this router — probe loop stopped,
        every ledger entry invalidated so a host-side callback from the
        dead router can resolve NOTHING. The returned snapshot is what
        ``FleetRouter(..., resume=snap)`` rebuilds from; the client
        futures inside it resolve only through the restarted router."""
        snap = self.snapshot()
        with self._lock:
            self._closed = True
            for e in self._ledger.values():
                e.done = True
                e.attempt += 1
            self._ledger.clear()
            self._heap.clear()
        self.monitor.stop()
        return snap

    # -- introspection / lifecycle ----------------------------------------
    def _health(self) -> dict:
        hosts = {}
        # snapshot + .get (see _admitted_names): /healthz and stats()
        # run lock-free and must survive a concurrent retirement
        for name in list(self._order):
            hs = self._states.get(name)
            if hs is None:
                continue
            h: dict[str, Any] = {"admitted": hs.admitted,
                                 "ejections": hs.ejections}
            if not hs.admitted:
                h["ejected_reason"] = hs.ejected_reason
                # the bounded probation gap (optional-field discipline:
                # new informational keys, absent on admitted hosts)
                h["probes_since_eject"] = hs.probes_since_eject
            if hs.draining:
                h["draining"] = True
            if hs.last is not None:
                h["attainment"] = hs.last.attainment
                h["queued"] = hs.last.queued
                if hs.last.occupancy is not None:
                    h["occupancy"] = round(hs.last.occupancy, 4)
                # preemption figures (serve.preempt) — optional probe
                # keys, surfaced only for hosts that report them
                if hs.last.preempted is not None:
                    h["preempted"] = hs.last.preempted
                if hs.last.evicted_depth is not None:
                    h["evicted_depth"] = hs.last.evicted_depth
            hosts[name] = h
        out = {"fleet": {"hosts": hosts,
                         "admitted": len(self._admitted_names()),
                         "size": len(self._states)},
               "attainment": {c: round(self.telemetry.attainment_of(c), 4)
                              for c in self.classes},
               # tolerant-optional probe field (ProbeView discipline):
               # live sequence moves across the fleet, all reasons
               "migrations": self.telemetry.migrations_total(),
               "uptime_s": round(time.monotonic() - self._t_start, 3)}
        if self.supervisor is not None:
            # lifecycle rider (serve/supervisor.py): per-host state,
            # quarantine records by name, the last scaling decision
            out["supervisor"] = self.supervisor.describe()
        return out

    def stats(self) -> dict:
        tm = self.telemetry
        with self._lock:
            lat = sorted(self._latencies)
            cls_snap = self._cls_stats.snapshot()
            inflight = len(self._ledger)
        out = {
            "router": "fleet",
            "kind": self.kind,
            "hosts": self._health()["fleet"]["hosts"],
            "requests": int(tm.requests.get()),
            "completed": int(tm.completed.get()),
            "failed": int(tm.failed.get()),
            "errors": int(tm.failed.get()),
            "rerouted": int(tm.rerouted.get()),
            "migrated": int(tm.migrations_total()),
            "shed": int(tm.shed.get()),
            "in_flight": inflight,
            "pending": self.pending,
            "classes": cls_snap,
            "slo": tm.attainment(),
            "uptime_s": round(time.monotonic() - self._t_start, 3),
        }
        out["p50_ms"] = round(percentile(lat, 0.50) * 1e3, 3)
        out["p99_ms"] = round(percentile(lat, 0.99) * 1e3, 3)
        return out

    def close(self, drain_s: float = 30.0) -> None:
        """Stop the probe loop, (best-effort) wait out in-flight
        requests, then FAIL whatever is still unresolved — a request
        parked in the admission heap during a fleet-wide outage (or one
        whose host never answers) must not leave its client blocked on
        a future nothing will ever resolve. Host engines are
        caller-owned and NOT closed here."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            inflight = [e.future for e in self._ledger.values()]
        self.monitor.stop()
        deadline = time.monotonic() + drain_s
        for fut in inflight:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                fut.result(timeout=left)
            except Exception:  # noqa: BLE001 — drain is best-effort
                pass
        with self._lock:
            leftovers = [e for e in self._ledger.values() if not e.done]
            for e in leftovers:
                e.done = True
                e.attempt += 1  # a late host answer resolves nothing
            self._ledger.clear()
            self._heap.clear()
        for e in leftovers:
            self.telemetry.failed.inc()
            resolve_future(e.future, exc=ServeError(
                "router closed before this request completed"))
        if leftovers:
            logger.warning("router close: failed %d unresolved "
                           "request(s)", len(leftovers))

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()

"""Fleet substrate: serving hosts, SLO-keyed health probing, ejection (the
JAX package's ``serve/fleet.py``).

Many hosts behind one front end (serve/router.py), with each host's
structured ``/healthz`` as the health signal:

* :class:`FleetHost` — one serving host behind the router: an engine-like
  ``submit`` plus a structured health probe. The in-process form wraps a
  live engine (the probe is ``transport.healthz_body``, which reads
  counters and never waits on the dispatcher or the device);
  :class:`HttpServeHost` speaks to a ``serve`` process over HTTP
  (``GET /healthz``, ``POST /predict``, ``/admin/export``,
  ``/admin/migrate``), so one router fronts engines in this process or
  across machines.
* :func:`parse_probe` — the versioned view of a ``/healthz`` body the
  ejection policy keys on: ``ok``, per-class ``attainment``,
  ``drift_breaches``, the queue depth, occupancy. A body missing a keyed
  field, or written by a newer schema, is a :class:`ServeError`: the probe
  counts as failed, so a telemetry change blinds the router loudly.
* :class:`HealthMonitor` — the probe loop. Each round probes every host
  concurrently on a bounded pool with a per-probe timeout, each probe
  wrapped in ``retry_with_backoff`` with jitter; a host whose probe still
  hangs from the previous round is skipped (counted stale), not queued
  again. Ejection keys on SLO-attainment collapse or staleness:
  ``eject_breach_probes`` consecutive bodies whose keyed-class attainment
  is below ``eject_attainment`` (or ``ok`` false), or
  ``eject_stale_probes`` consecutive failed probes. An ejected host keeps
  being probed and is re-admitted after ``probation_probes`` healthy
  probes. The ``fleet.probe`` fault point covers every probe attempt: a
  fire is a failed probe and the loop keeps running.

:class:`FleetTelemetry` is the router's counters and gauges (requests,
re-routes, per-host ejections, re-admissions and probe failures, per-class
SLO met/missed judged at the router's admission clock) with the
``render()``/``health()``/``trace`` surface the transport reads, so
``make_server(router, ...)`` serves ``/metrics``, ``/healthz``,
``/stats`` and ``/trace`` unchanged.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from euromillioner_tpu_torch.obs.metrics import (MetricsRegistry,
                                                 global_registry,
                                                 render_prometheus)
from euromillioner_tpu_torch.obs.trace import TraceBuffer
from euromillioner_tpu_torch.resilience import fault_point
# the one schema constant writer and parser share: a body from a newer
# schema is refused, never half-understood
from euromillioner_tpu_torch.serve.transport import (HEALTHZ_VERSION,
                                                     healthz_body)
from euromillioner_tpu_torch.utils.errors import ServeError
from euromillioner_tpu_torch.utils.logging_utils import get_logger
from euromillioner_tpu_torch.utils.retry import (RetryPolicy,
                                                 retry_with_backoff)

logger = get_logger("serve.fleet")

# The /healthz fields the ejection and placement policy keys on (pinned by
# the tests for every engine kind)
PROBE_KEYS = ("ok", "attainment", "drift_breaches")
PROBE_QUEUE_KEYS = ("queued", "queue_depth")  # one of these must exist


@dataclass
class ProbeView:
    """One parsed health probe. Every field after ``occupancy`` is
    optional: the preemption figures of a slot host, the memory ledger's
    parked bytes and spills, AOT store hits, chunked-tree dispatches, live
    migrations, a paged pool's live set — absent on hosts without them,
    never a failed probe (only the keyed fields are required)."""

    ok: bool
    attainment: dict[str, float]
    drift_breaches: int
    queued: int
    occupancy: float | None = None
    preempted: int | None = None
    evicted_depth: int | None = None
    ledger_bytes: int | None = None
    spilled: int | None = None
    aot_hits: int | None = None
    tree_chunks: int | None = None
    migrations: int | None = None
    pages_live: int | None = None


_OPTIONAL_INT_KEYS = ("preempted", "evicted_depth", "ledger_bytes",
                      "spilled", "aot_hits", "tree_chunks", "migrations",
                      "pages_live")


def parse_probe(body: Mapping[str, Any]) -> ProbeView:
    """Validate one ``/healthz`` body and project it onto the fields the
    ejection policy reads. A missing keyed field or a newer
    ``healthz_version`` raises :class:`ServeError`, which the caller
    counts as a failed probe."""
    ver = body.get("healthz_version", 1)
    if not isinstance(ver, int) or ver < 1:
        raise ServeError(f"healthz_version must be an int >= 1, got {ver!r}")
    if ver > HEALTHZ_VERSION:
        raise ServeError(
            f"healthz_version {ver} is newer than this router supports "
            f"({HEALTHZ_VERSION}) — upgrade the router")
    missing = [k for k in PROBE_KEYS if k not in body]
    if not any(k in body for k in PROBE_QUEUE_KEYS):
        missing.append("|".join(PROBE_QUEUE_KEYS))
    if missing:
        raise ServeError(
            f"healthz body is missing fields the ejection policy keys "
            f"on: {missing} (schema v{HEALTHZ_VERSION} wants "
            f"{list(PROBE_KEYS) + ['queued|queue_depth']})")
    att = body["attainment"]
    if not isinstance(att, Mapping):
        raise ServeError(f"healthz attainment must be a per-class "
                         f"mapping, got {type(att).__name__}")
    queued = body.get("queued", body.get("queue_depth", 0))
    occ = body.get("mean_occupancy")
    if occ is None and body.get("slots"):
        occ = body.get("active", 0) / body["slots"]
    extra = {k: (None if body.get(k) is None else int(body[k]))
             for k in _OPTIONAL_INT_KEYS}
    return ProbeView(ok=bool(body["ok"]),
                     attainment={str(k): float(v) for k, v in att.items()},
                     drift_breaches=int(body["drift_breaches"]),
                     queued=int(queued), occupancy=occ, **extra)


class FleetHost:
    """One serving host: a name, an engine-like submit surface, a
    structured health probe, and a kill switch for chaos tests.

    ``FleetHost("h0", engine)`` wraps a live engine: probe =
    ``transport.healthz_body(engine)``, submit = the engine's own.
    ``submit_fn``/``probe_fn`` replace both for other transports.

    :meth:`kill` simulates process death: every further submit and probe
    raises. The router never calls it — ejection comes from the probe
    policy observing the death."""

    def __init__(self, name: str, engine: Any = None, *,
                 submit_fn: Callable[..., Future] | None = None,
                 probe_fn: Callable[[], Mapping[str, Any]] | None = None):
        if engine is None and (submit_fn is None or probe_fn is None):
            raise ServeError(
                f"host {name!r} needs an engine or explicit "
                "submit_fn + probe_fn")
        self.name = str(name)
        self.engine = engine
        self._submit_fn = submit_fn
        self._probe_fn = probe_fn
        self._killed = False

    @property
    def kind(self) -> str:
        return getattr(self.engine, "kind", "rows")

    @property
    def killed(self) -> bool:
        return self._killed

    def _check_alive(self) -> None:
        if self._killed:
            raise ServeError(f"host {self.name} is down")

    def kill(self) -> None:
        """Simulate host death: probes and submits fail from now on. Work
        already on the host is not resolved here; the router's drain on
        ejection re-routes it, as with a dead process."""
        self._killed = True

    def revive(self) -> None:
        """Undo :meth:`kill`."""
        self._killed = False

    def respawn(self, engine: Any,
                sequences: Sequence[bytes] = ()) -> list[Future]:
        """Put a freshly spawned engine behind this name (with the AOT
        store, its warmup loads the ladder instead of compiling it).
        Re-admission still comes only from the router's probation.

        ``sequences`` are migration blobs a draining predecessor exported
        (``StepScheduler.drain_export``): each is imported into the new
        engine, so a planned restart loses no slot holder. A blob the new
        engine refuses (a header mismatch) is logged and skipped. Returns
        the imported sequences' futures."""
        if engine is None:
            raise ServeError(f"host {self.name} respawn needs an engine")
        self.engine = engine
        self._submit_fn = None
        self._probe_fn = None
        self._killed = False
        futures: list[Future] = []
        for blob in sequences:
            try:
                futures.append(self.import_sequence(blob))
            except ServeError as e:
                logger.warning("host %s respawn: one exported sequence "
                               "was not restored (%s)", self.name, e)
        return futures

    def export_sequence(self, target, *, reason: str = "migrate",
                        timeout_s: float = 30.0) -> bytes | None:
        """Evict and pack one live sequence off this host's engine (None
        when the engine cannot migrate or no longer holds it)."""
        self._check_alive()
        export = getattr(self.engine, "export_sequence", None)
        if export is None:
            return None
        return export(target, reason=reason, timeout_s=timeout_s)

    def drain_export(self, *, reason: str = "respawn") -> list[bytes]:
        """Export every live sequence off this host's engine; [] when the
        engine cannot migrate."""
        self._check_alive()
        drain = getattr(self.engine, "drain_export", None)
        if drain is None:
            return []
        return drain(reason=reason)

    def import_sequence(self, blob: bytes) -> Future:
        """Admit one migration blob into this host's engine; a
        ServeError when the engine cannot import or the header does not
        fit its pool (naming the field)."""
        self._check_alive()
        imp = getattr(self.engine, "import_sequence", None)
        if imp is None:
            raise ServeError(
                f"host {self.name} cannot import migrated sequences "
                f"(engine kind {self.kind!r} has no migration surface)")
        return imp(blob)

    def submit(self, x, max_wait_s: float | None = None,
               cls: str | None = None) -> Future:
        self._check_alive()
        if self._submit_fn is not None:
            return self._submit_fn(x, max_wait_s=max_wait_s, cls=cls)
        return self.engine.submit(x, max_wait_s=max_wait_s, cls=cls)

    def probe(self) -> ProbeView:
        """One health probe, parsed. Raises on an unreachable host or an
        unparseable body (both a failed probe upstream)."""
        self._check_alive()
        body = (self._probe_fn() if self._probe_fn is not None
                else healthz_body(self.engine))
        return parse_probe(body)


class HttpServeHost(FleetHost):
    """A ``serve`` process behind its HTTP surface: probes
    ``GET /healthz`` and submits by ``POST /predict`` on a small thread
    pool of its own (one blocking request per worker; the engine on the
    far side batches across them)."""

    def __init__(self, name: str, url: str, *, kind: str = "rows",
                 timeout_s: float = 5.0,
                 request_timeout_s: float | None = None, workers: int = 8):
        self.name = str(name)
        self.url = url.rstrip("/")
        self.engine = None
        self._kind = kind
        self._timeout_s = float(timeout_s)
        # /predict has its own, larger timeout: a probe answers in probe
        # time, but a request may queue behind a spike for seconds
        self._request_timeout_s = (max(30.0, self._timeout_s)
                                   if request_timeout_s is None
                                   else float(request_timeout_s))
        self._killed = False
        self._submit_fn = None
        self._probe_fn = None
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix=f"fleet-{name}")
        # every sequence submit carries a tag of this host's making, the
        # handle /admin/export names it by later (future id -> tag)
        self._tag_lock = threading.Lock()
        self._tag_n = 0
        self._tags: dict[int, str] = {}

    @property
    def kind(self) -> str:
        return self._kind

    def probe(self) -> ProbeView:
        self._check_alive()
        with urllib.request.urlopen(self.url + "/healthz",
                                    timeout=self._timeout_s) as resp:
            return parse_probe(json.loads(resp.read()))

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(
                req, timeout=self._request_timeout_s) as resp:
            return json.loads(resp.read())

    def _predictions(self, body: dict) -> np.ndarray:
        if "error" in body:
            raise ServeError(f"host {self.name}: {body['error']}")
        return np.asarray(body["predictions"], np.float32)

    def _post_predict(self, x, max_wait_s, cls, tag=None):
        payload: dict[str, Any] = {"rows": np.asarray(x).tolist()}
        if max_wait_s is not None:
            payload["max_wait_s"] = max_wait_s
        if cls is not None:
            payload["class"] = cls
        if tag is not None:
            payload["tag"] = tag
        return self._predictions(self._post("/predict", payload))

    def submit(self, x, max_wait_s: float | None = None,
               cls: str | None = None) -> Future:
        self._check_alive()
        tag = None
        if self._kind == "sequence":
            # row requests have no exportable mid-flight state
            with self._tag_lock:
                self._tag_n += 1
                tag = f"{self.name}-{self._tag_n}"
        fut = self._pool.submit(self._post_predict, x, max_wait_s, cls,
                                tag)
        if tag is not None:
            with self._tag_lock:
                self._tags[id(fut)] = tag
            fut.add_done_callback(self._forget_tag)
        return fut

    def _forget_tag(self, fut: Future) -> None:
        with self._tag_lock:
            self._tags.pop(id(fut), None)

    def _post_migrate(self, blob: bytes):
        payload = {"blob": base64.b64encode(bytes(blob)).decode("ascii")}
        return self._predictions(self._post("/admin/migrate", payload))

    def import_sequence(self, blob: bytes) -> Future:
        """Ship one migration blob by ``POST /admin/migrate``; the future
        resolves with the migrated sequence's prediction (the remote
        handler blocks until it finishes). A remote header mismatch comes
        back as the engine's error naming the field."""
        self._check_alive()
        return self._pool.submit(self._post_migrate, blob)

    def export_sequence(self, target, *, reason: str = "migrate",
                        timeout_s: float = 30.0) -> bytes | None:
        """Evict and pack one live sequence off the remote engine by
        ``POST /admin/export``, by the tag this host attached at submit
        (``target`` is that tag or the submit's future). None when there
        is no tag (a row request, or a future not submitted here), the
        remote has no export surface, or it no longer holds the
        sequence; the router then re-dispatches."""
        self._check_alive()
        if isinstance(target, str):
            tag = target
        else:
            with self._tag_lock:
                tag = self._tags.get(id(target))
        if tag is None:
            return None
        try:
            body = self._post("/admin/export", {"target": tag})
        except urllib.error.HTTPError as e:
            # 404 (no export surface) or 400: not exportable
            logger.warning("host %s: /admin/export %s for %r",
                           self.name, e.code, tag)
            return None
        blob64 = body.get("blob")
        return None if blob64 is None else base64.b64decode(blob64)

    def drain_export(self, *, reason: str = "respawn") -> list[bytes]:
        """Export every live sequence off the remote engine by
        ``POST /admin/export {"all": true}``; [] without the surface."""
        self._check_alive()
        try:
            body = self._post("/admin/export", {"all": True})
        except urllib.error.HTTPError as e:
            logger.warning("host %s: /admin/export drain %s",
                           self.name, e.code)
            return []
        return [base64.b64decode(b) for b in body.get("blobs", [])]

    def close(self) -> None:
        self._pool.shutdown(wait=False)


@dataclass
class HostState:
    """The router's health bookkeeping for one host (mutated under the
    router lock or by the probe loop)."""

    host: FleetHost
    admitted: bool = True
    stale: int = 0          # consecutive probe failures
    breaches: int = 0       # consecutive unhealthy bodies
    ok_streak: int = 0      # consecutive healthy probes (probation)
    ejected_reason: str = ""
    ejections: int = 0
    last: ProbeView | None = None
    probing: bool = False   # the previous round's probe still runs
    # probes recorded since the ejection without re-admission: the
    # supervisor declares a host dead at a bound of these with no healthy
    # streak (a host slow to recover keeps a non-zero ok_streak)
    probes_since_eject: int = 0
    # scale-down (the supervisor's): no new admissions and no probation
    # re-admission; in-flight work completes
    draining: bool = False
    # quarantine (the supervisor's): never re-admitted by probation, only
    # by an operator release
    barred: bool = False

    @property
    def name(self) -> str:
        return self.host.name


@dataclass(frozen=True)
class ProbePolicy:
    """The ejection and probation knobs (``serve.fleet.*``)."""

    interval_s: float = 0.2
    timeout_s: float = 1.0
    retries: int = 2          # retry_with_backoff attempts per probe
    jitter_s: float = 0.01    # pre-probe jitter
    eject_attainment: float = 0.5
    eject_class: str = ""     # "" = the first (most urgent) class
    eject_breach_probes: int = 2
    eject_stale_probes: int = 3
    probation_probes: int = 3


class HealthMonitor:
    """The probe loop: one daemon thread, one bounded pool, a per-probe
    timeout. Owned by the router; ``on_eject``/``on_readmit`` are its
    drain and heap-drain hooks."""

    def __init__(self, states: Sequence[HostState], policy: ProbePolicy,
                 telemetry: "FleetTelemetry", classes: Sequence[str], *,
                 on_eject: Callable[[HostState, str], None],
                 on_readmit: Callable[[HostState], None]):
        self.states = list(states)
        self.policy = policy
        self.telemetry = telemetry
        self._eject_class = policy.eject_class or (
            classes[0] if classes else "")
        self._on_eject = on_eject
        self._on_readmit = on_readmit
        self._stop = threading.Event()
        # +2: a hung probe holds a worker until its call ends (the
        # skip-while-probing guard keeps it from starving the rest); the
        # floor of 8 leaves room for hosts a supervisor adds
        self._pool_size = max(len(self.states) + 2, 8)
        self._pool = ThreadPoolExecutor(
            max_workers=self._pool_size, thread_name_prefix="fleet-probe")
        attempts = max(1, policy.retries)
        self._retry = RetryPolicy(
            max_attempts=attempts, base_delay_s=0.02,
            max_delay_s=0.1, pre_jitter_s=max(0.0, policy.jitter_s))
        # one round waits for every attempt of its probes: timeout_s is
        # the per-attempt budget, and the retries run inside the future
        self._round_budget_s = (policy.timeout_s * attempts
                                + 0.1 * (attempts - 1)
                                + max(0.0, policy.jitter_s) * attempts)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-health")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        self._pool.shutdown(wait=False)

    def probe_once(self) -> None:
        """One synchronous probe round (what the tests drive)."""
        self._round()

    def add_state(self, hs: HostState) -> None:
        """Register a host added at run time. The probe pool grows with
        the host set, so probes never queue behind a full pool (where
        they would read as staleness)."""
        self.states = self.states + [hs]
        want = len(self.states) + 2
        if want > self._pool_size:
            # the old pool's in-flight probes still run to their end
            old = self._pool
            self._pool = ThreadPoolExecutor(
                max_workers=want, thread_name_prefix="fleet-probe")
            self._pool_size = want
            old.shutdown(wait=False)

    def remove_state(self, name: str) -> None:
        self.states = [hs for hs in self.states if hs.name != name]

    def dead_hosts(self, min_probes: int) -> list[HostState]:
        """Hosts ejected for ``min_probes`` or more recorded probes with
        no healthy streak (draining hosts leave on purpose)."""
        return [hs for hs in list(self.states)
                if not hs.admitted and not hs.draining
                and hs.ok_streak == 0
                and hs.probes_since_eject >= min_probes]

    def _probe_host(self, hs: HostState) -> ProbeView:
        def attempt() -> ProbeView:
            # a fired fault is a failed probe attempt
            fault_point("fleet.probe", host=hs.name)
            return hs.host.probe()

        return retry_with_backoff(attempt, policy=self._retry,
                                  description=f"probe {hs.name}")

    def _round(self) -> None:
        pending: list[tuple[HostState, Future]] = []
        # a snapshot: a supervisor may add or remove hosts mid-round
        for hs in list(self.states):
            if hs.probing:
                self._record(hs, None, ServeError("probe still pending"))
                continue
            hs.probing = True
            try:
                fut = self._pool.submit(self._probe_host, hs)
            except RuntimeError:
                # add_state swapped the pool between the read and submit
                try:
                    fut = self._pool.submit(self._probe_host, hs)
                except RuntimeError as e:
                    hs.probing = False
                    self._record(hs, None, e)
                    continue
            pending.append((hs, fut))
        # one deadline for the whole round: the probes run concurrently
        round_deadline = time.monotonic() + self._round_budget_s
        for hs, fut in pending:
            try:
                view = fut.result(
                    timeout=max(0.0, round_deadline - time.monotonic()))
                err: BaseException | None = None
            except Exception as e:  # noqa: BLE001 — timeout or failure
                view, err = None, e
            if not isinstance(err, (_FutureTimeout, TimeoutError)):
                hs.probing = False
            else:
                # the worker is still in the probe: clear the flag when
                # it ends
                fut.add_done_callback(
                    lambda _f, hs=hs: setattr(hs, "probing", False))
            self._record(hs, view, err)

    def _record(self, hs: HostState, view: ProbeView | None,
                err: BaseException | None) -> None:
        tm = self.telemetry
        tm.probes(hs.name).inc()
        if not hs.admitted:
            hs.probes_since_eject += 1
        if view is None:
            tm.probe_failures(hs.name).inc()
            hs.stale += 1
            hs.ok_streak = 0
            if hs.admitted and hs.stale >= self.policy.eject_stale_probes:
                self._eject(hs, f"stale ({hs.stale} failed probes: "
                                f"{err!r})")
            return
        hs.stale = 0
        hs.last = view
        att = view.attainment.get(self._eject_class, 1.0)
        if view.ok and att >= self.policy.eject_attainment:
            hs.breaches = 0
            hs.ok_streak += 1
            if (not hs.admitted and not hs.draining and not hs.barred
                    and hs.ok_streak >= self.policy.probation_probes):
                self._readmit(hs)
        else:
            hs.breaches += 1
            hs.ok_streak = 0
            if hs.admitted and hs.breaches >= self.policy.eject_breach_probes:
                self._eject(
                    hs, f"attainment collapse ({self._eject_class}="
                        f"{att:.3f} < {self.policy.eject_attainment})"
                    if view.ok else "healthz ok=false")

    def _eject(self, hs: HostState, reason: str) -> None:
        hs.admitted = False
        hs.ejected_reason = reason
        hs.ejections += 1
        hs.ok_streak = 0
        hs.probes_since_eject = 0
        kind = "stale" if reason.startswith("stale") else "slo"
        self.telemetry.ejections(hs.name, kind).inc()
        logger.warning("ejecting host %s: %s", hs.name, reason)
        self._on_eject(hs, reason)

    def _readmit(self, hs: HostState) -> None:
        hs.admitted = True
        hs.ejected_reason = ""
        hs.stale = 0
        hs.breaches = 0
        hs.probes_since_eject = 0
        self.telemetry.readmissions(hs.name).inc()
        logger.info("re-admitting host %s after %d healthy probation "
                    "probes", hs.name, self.policy.probation_probes)
        self._on_readmit(hs)

    def _run(self) -> None:
        while not self._stop.wait(self.policy.interval_s):
            try:
                self._round()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                logger.warning("probe round failed (%r); loop continues", e)


class FleetTelemetry:
    """The router's counters and gauges, with the ``render``/``health``/
    ``trace`` surface the transport reads (so ``make_server(router)``
    serves /metrics, /healthz and /trace)."""

    def __init__(self, classes: Sequence[str]):
        self.classes = tuple(classes)
        self.registry = MetricsRegistry()
        self.trace = TraceBuffer(16)  # the transport's surface; no spans
        self.enabled = True
        # the router composes health() (it owns the host states)
        self.health_fn: Callable[[], dict] | None = None
        reg = self.registry
        self.requests = reg.counter(
            "fleet_requests_total", "Requests admitted by the router").labels()
        self.completed = reg.counter(
            "fleet_completed_total", "Requests completed via the fleet").labels()
        self.failed = reg.counter(
            "fleet_failed_total",
            "Requests failed after exhausting route attempts").labels()
        self.rerouted = reg.counter(
            "fleet_reroutes_total",
            "Request re-dispatches after a host failure or drain").labels()
        self.shed = reg.counter(
            "fleet_shed_total",
            "Requests shed because the outage admission queue hit its "
            "bound (serve.fleet.max_pending)").labels()
        self._probes = reg.counter(
            "fleet_probes_total", "Health probes per host", ("host",))
        self._probe_failures = reg.counter(
            "fleet_probe_failures_total",
            "Failed/timed-out health probes per host", ("host",))
        self._ejections = reg.counter(
            "fleet_ejections_total",
            "Host ejections (reason=slo|stale|admin)", ("host", "reason"))
        self._readmissions = reg.counter(
            "fleet_readmissions_total",
            "Hosts re-admitted after recovery probation", ("host",))
        self._migrations = reg.counter(
            "fleet_migrations_total",
            "Live sequence migrations (reason=drain|eject|respawn)",
            ("reason",))
        self.migration_latency = reg.histogram(
            "fleet_migration_latency_seconds",
            "Per-sequence export->import wall time").labels()
        self.migration_bytes = reg.counter(
            "fleet_migration_bytes_total",
            "Migration wire-blob bytes shipped").labels()
        met = reg.counter("fleet_slo_met_total",
                          "Requests meeting their deadline, judged at "
                          "the router's admission clock", ("class",))
        miss = reg.counter("fleet_slo_missed_total",
                           "Requests missing their deadline, judged at "
                           "the router's admission clock", ("class",))
        self._met = {c: met.labels(c) for c in self.classes}
        self._missed = {c: miss.labels(c) for c in self.classes}
        att = reg.gauge("fleet_slo_attainment_ratio",
                        "Router-judged per-class attainment", ("class",))
        for c in self.classes:
            att.labels(c).set_function(lambda c=c: self.attainment_of(c))

    def probes(self, host: str):
        return self._probes.labels(host)

    def probe_failures(self, host: str):
        return self._probe_failures.labels(host)

    def ejections(self, host: str, reason: str):
        return self._ejections.labels(host, reason)

    def readmissions(self, host: str):
        return self._readmissions.labels(host)

    def migrations(self, reason: str):
        return self._migrations.labels(reason)

    def migrations_total(self) -> int:
        return int(sum(self._migrations.labels(r).get()
                       for r in ("drain", "eject", "respawn")))

    def judge(self, cls: str, met: bool) -> None:
        child = (self._met if met else self._missed).get(cls)
        if child is not None:
            child.inc()

    def attainment_of(self, cls: str) -> float:
        met_c, miss_c = self._met.get(cls), self._missed.get(cls)
        met = met_c.get() if met_c else 0.0
        miss = miss_c.get() if miss_c else 0.0
        return met / (met + miss) if met + miss else 1.0

    def attainment(self) -> dict:
        return {c: {"met": int(self._met[c].get()),
                    "missed": int(self._missed[c].get()),
                    "attainment": round(self.attainment_of(c), 4)}
                for c in self.classes}

    def trace_snapshot(self) -> dict:
        return {"spans": self.trace.pushed, "buffered": len(self.trace),
                "dropped": self.trace.dropped}

    def health(self) -> dict:
        return self.health_fn() if self.health_fn is not None else {}

    def render(self) -> str:
        return render_prometheus(self.registry, global_registry())

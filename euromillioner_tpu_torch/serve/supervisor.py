"""Self-healing fleet supervisor: host lifecycle above the router (the
JAX package's ``serve/supervisor.py``).

* **Self-healing.** The :class:`~euromillioner_tpu_torch.serve.fleet.
  HealthMonitor` bounds the probation gap: an ejected host that records
  ``dead_after_probes`` probes with no healthy streak is dead
  (``monitor.dead_hosts``). The supervisor builds a warm replacement with
  its ``spawn_fn`` (an engine factory; against the shared AOT store,
  serve/aotstore.py, the programs load from disk with no compile), swaps
  it in with ``FleetHost.respawn``, and lets the router's own probation
  re-admit it. In-flight sequences were re-routed at the ejection, so
  traffic through a kill and respawn stays bit-identical to an unfaulted
  run on hosts of one ``max_slots``.
* **Autoscaling.** The target host count follows router-side signals —
  admission-heap depth (``fleet_pending``), mean admitted-host occupancy,
  recent attainment of the most urgent class — with ``scale_hysteresis``
  consecutive same-direction ticks and per-direction cooldowns. Scale-up
  spawns a warm host that enters through probation; scale-down drains its
  victim (``FleetRouter.begin_retire``: no new admissions, in-flight work
  completes, probation will not re-admit it) and retires it once the
  drain has run out — shrink never kills.
* **Crash-loop quarantine.** Every death (and every exhausted spawn retry
  cycle) is a strike; ``quarantine_strikes`` strikes inside
  ``strike_window_s`` quarantine the host — counted
  (``fleet_quarantines_total``), named in ``/healthz`` under the
  ``supervisor`` rider, never respawned again — until an operator lifts it
  with :meth:`release` (``fleet --release`` / ``POST /admin/release``).

Fault points: ``fleet.spawn`` covers each spawn attempt (a fire fails only
that attempt; retries back off, an exhausted cycle is a strike);
``fleet.scale`` covers each committed scaling decision (a fire aborts only
that decision; the next tick decides afresh). Supervisor state (quarantine
records, strike clocks, the last decision) snapshots and resumes beside
the router's ledger, so a front-end restart loses neither admitted
requests nor lifecycle history.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

from euromillioner_tpu_torch.resilience import fault_point
from euromillioner_tpu_torch.serve.fleet import FleetHost, HostState
from euromillioner_tpu_torch.utils.errors import ServeError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("serve.supervisor")


@dataclass(frozen=True)
class SupervisorPolicy:
    """The lifecycle knobs (``serve.fleet.autoscale.*`` — see
    config.py AutoscaleConfig for per-field semantics)."""

    interval_s: float = 0.2
    autoscale: bool = False
    min_hosts: int = 1
    max_hosts: int = 4
    up_pending: int = 1
    up_occupancy: float = 0.85
    up_attainment: float = 0.9
    down_occupancy: float = 0.25
    scale_hysteresis: int = 2
    up_cooldown_s: float = 2.0
    down_cooldown_s: float = 10.0
    dead_after_probes: int = 8
    spawn_retries: int = 3
    spawn_backoff_s: float = 0.05
    quarantine_strikes: int = 3
    strike_window_s: float = 300.0
    # serve.fleet.migrate.*: scale-down drains by bit-exact live
    # migration (O(blob-ship) shrink), and a planned restart_host
    # carries slot-holders across the engine swap
    drain_migrate: bool = True
    respawn_restore: bool = True

    def validate(self) -> None:
        if self.min_hosts < 1:
            raise ServeError(f"min_hosts must be >= 1, got {self.min_hosts}")
        if self.max_hosts < self.min_hosts:
            raise ServeError(
                f"max_hosts ({self.max_hosts}) must be >= min_hosts "
                f"({self.min_hosts})")
        if self.dead_after_probes < 1:
            raise ServeError("dead_after_probes must be >= 1, got "
                             f"{self.dead_after_probes}")
        if self.spawn_retries < 1:
            raise ServeError(
                f"spawn_retries must be >= 1, got {self.spawn_retries}")
        if self.quarantine_strikes < 1:
            raise ServeError("quarantine_strikes must be >= 1, got "
                             f"{self.quarantine_strikes}")
        if self.scale_hysteresis < 1:
            raise ServeError("scale_hysteresis must be >= 1, got "
                             f"{self.scale_hysteresis}")


def policy_from_config(az, migrate=None) -> SupervisorPolicy:
    """``serve.fleet.autoscale.*`` (+ optional ``serve.fleet.
    migrate.*``) → :class:`SupervisorPolicy` — the one config mapping
    the ``fleet`` CLI and tests share (the supervisor twin of
    cli._probe_policy)."""
    return SupervisorPolicy(
        interval_s=az.interval_ms / 1e3,
        autoscale=az.enabled,
        min_hosts=az.min_hosts, max_hosts=az.max_hosts,
        up_pending=az.up_pending, up_occupancy=az.up_occupancy,
        up_attainment=az.up_attainment,
        down_occupancy=az.down_occupancy,
        scale_hysteresis=az.scale_hysteresis,
        up_cooldown_s=az.up_cooldown_ms / 1e3,
        down_cooldown_s=az.down_cooldown_ms / 1e3,
        dead_after_probes=az.dead_after_probes,
        spawn_retries=az.spawn_retries,
        spawn_backoff_s=az.spawn_backoff_ms / 1e3,
        quarantine_strikes=az.quarantine_strikes,
        strike_window_s=az.strike_window_s,
        drain_migrate=(migrate.enabled and migrate.drain
                       if migrate is not None else True),
        respawn_restore=(migrate.enabled and migrate.respawn
                         if migrate is not None else True))


class FleetSupervisor:
    """Drive host lifecycle over a :class:`~euromillioner_tpu_torch.
    serve.router.FleetRouter`: warm respawn of dead hosts, load-driven
    scaling, crash-loop quarantine (see the module docstring).

    ``spawn_fn(name) -> engine`` builds one warm serving engine — point
    it at the shared AOT store (serve/aotstore.py) and a spawn loads its
    programs from disk instead of compiling them. ``spawn_fn=None`` is a
    watch-only supervisor: dead hosts are still detected and crash loops
    quarantined, but nothing is respawned or scaled (logged once per
    host; the front end cannot start ``serve`` processes).

    ``start=False`` defers the tick loop: tests drive rounds with
    :meth:`tick` after ``monitor.probe_once()``."""

    def __init__(self, router, spawn_fn: Callable[[str], Any] | None = None,
                 policy: SupervisorPolicy | None = None, *,
                 start: bool = True,
                 resume: dict | None = None):
        self.policy = policy or SupervisorPolicy()
        self.policy.validate()
        self.router = router
        self._spawn_fn = spawn_fn
        self._lock = threading.Lock()
        self._strikes: dict[str, deque] = {}
        self._quarantined: dict[str, dict] = {}
        self._spawning: set[str] = set()
        # hosts declared dead whose respawn has not yet SUCCEEDED: a
        # repeat detection (e.g. while a spawn storm exhausts retries)
        # is the same death — it must not accrue a fresh strike per tick
        self._dead: set[str] = set()
        self._owned_engines: list[Any] = []
        self._unhealable_logged: set[str] = set()
        self._next_spawn = 1
        # names THIS supervisor created via scale-up: the preferred
        # scale-down victims ("hand-started hosts are the operator's")
        # — tracked explicitly, never inferred from a name pattern an
        # operator's own hosts could collide with
        self._spawned_names: set[str] = set()
        self._scale_dir = 0
        self._scale_streak = 0
        self._cooldown_until = {"up": 0.0, "down": 0.0}
        # windowed attainment: the registry's met/missed counters are
        # LIFETIME totals — keying the up-trigger on them would let one
        # past incident drive permanent scale-up (and an idle fleet at
        # max_hosts into a drain/spawn churn loop). The supervisor
        # keeps per-tick (t, delta) samples over a TIME window instead:
        # an incident ages out even with no follow-on traffic, and no
        # judged samples in the window = healthy.
        self._att_window: deque = deque()
        self._att_window_s = 60.0
        self._att_last: tuple[float, float] | None = None
        self.last_decision = ""
        # plain counters mirrored into the router registry (describe()
        # and the smoke summary read these; /metrics the families)
        self.spawns = 0
        self.spawn_failures = 0
        self.quarantines = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.scale_aborts = 0
        self.retired = 0
        reg = router.telemetry.registry
        self._c_spawns = reg.counter(
            "fleet_spawns_total", "Warm host spawns by the supervisor "
            "(respawn of dead hosts + scale-up)", ("host",))
        self._c_spawn_failures = reg.counter(
            "fleet_spawn_failures_total",
            "Failed spawn attempts (fleet.spawn fires included)",
            ("host",))
        self._c_quarantines = reg.counter(
            "fleet_quarantines_total",
            "Hosts quarantined for crash-looping", ("host",))
        self._c_scale = reg.counter(
            "fleet_scale_total", "Committed scaling decisions",
            ("direction",))
        self._c_scale_aborts = reg.counter(
            "fleet_scale_aborted_total",
            "Scaling decisions aborted (fleet.scale fires)").labels()
        self._c_retired = reg.counter(
            "fleet_retired_total",
            "Hosts retired after a scale-down drain ran out").labels()
        reg.gauge(
            "fleet_hosts_quarantined",
            "Hosts currently quarantined (released only by an "
            "operator)").labels().set_function(
            lambda: len(self._quarantined))
        if resume:
            self._resume(resume)
        router.supervisor = self
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-supervisor")
        if start:
            self._thread.start()

    # -- lifecycle loop ---------------------------------------------------
    def start(self) -> None:
        if not self._thread.is_alive():
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def close(self) -> None:
        """Stop the loop and close every engine this supervisor spawned
        (caller-built host engines stay the caller's to close)."""
        self.stop()
        if self.router.supervisor is self:
            self.router.supervisor = None
        for eng in self._owned_engines:
            try:
                eng.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        self._owned_engines.clear()

    def _run(self) -> None:
        while not self._stop.wait(self.policy.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                logger.warning("supervisor tick failed (%r); loop "
                               "continues", e)

    def tick(self) -> None:
        """One supervision round — heal dead hosts, sweep finished
        drains, then evaluate scaling (sweep-before-decide: a drain a
        previous decision started resolves before a new one fires, so
        one tick never compounds two capacity moves). The deterministic
        entry the chaos tests drive directly."""
        self._heal()
        self._sweep_drains()
        if self.policy.autoscale:
            self._autoscale()

    # -- self-healing ------------------------------------------------------
    def _heal(self) -> None:
        # out-of-band recovery first: a host we hold dead that probation
        # re-admitted (an operator restarted its process — the watch-only
        # HTTP mode's healing path) is healed; its NEXT death must strike
        # fresh
        admitted = {hs.name for hs in self.router.monitor.states
                    if hs.admitted}
        with self._lock:
            self._dead -= admitted
        self._unhealable_logged -= admitted
        for hs in self.router.monitor.dead_hosts(
                self.policy.dead_after_probes):
            with self._lock:
                if hs.name in self._quarantined or hs.name in self._spawning:
                    continue
            self._declare_dead(hs)

    def _strike(self, name: str) -> int:
        """Record one crash-loop strike; returns the count inside the
        window (old strikes age out)."""
        now = time.monotonic()
        with self._lock:
            dq = self._strikes.setdefault(name, deque())
            dq.append(now)
            while dq and now - dq[0] > self.policy.strike_window_s:
                dq.popleft()
            return len(dq)

    def _strike_count(self, name: str) -> int:
        now = time.monotonic()
        with self._lock:
            dq = self._strikes.get(name)
            if not dq:
                return 0
            while dq and now - dq[0] > self.policy.strike_window_s:
                dq.popleft()
            return len(dq)

    def _declare_dead(self, hs: HostState) -> None:
        with self._lock:
            repeat = hs.name in self._dead
            self._dead.add(hs.name)
        if repeat:
            # the same death, still unhealed (a spawn storm exhausted
            # its retries last tick): retry the respawn, no new strike
            if self._spawn_fn is not None:
                self._respawn(hs, self._strike_count(hs.name))
            return
        strikes = self._strike(hs.name)
        if strikes >= self.policy.quarantine_strikes:
            # quarantine is spawn-independent: a watch-only supervisor
            # (HTTP hosts restarted out-of-band) still counts deaths
            # and quarantines crash-loopers — the lifecycle visibility
            # the CLI mode advertises
            self._quarantine(hs.name, strikes,
                             f"crash loop: {strikes} deaths within "
                             f"{self.policy.strike_window_s:.0f}s")
            return
        if self._spawn_fn is None:
            if hs.name not in self._unhealable_logged:
                self._unhealable_logged.add(hs.name)
                logger.warning(
                    "host %s is DEAD (%d probes without re-admission; "
                    "strike %d/%d) and this supervisor has no spawn_fn "
                    "— it cannot be respawned",
                    hs.name, hs.probes_since_eject, strikes,
                    self.policy.quarantine_strikes)
            return
        logger.warning("host %s declared DEAD (%d probes without "
                       "re-admission; strike %d/%d) — respawning warm",
                       hs.name, hs.probes_since_eject, strikes,
                       self.policy.quarantine_strikes)
        self._respawn(hs, strikes)

    def _bar(self, name: str, barred: bool) -> None:
        """Set/clear the probation bar on a host's router state (a
        quarantined host must never serve — probation would otherwise
        re-admit an operator-restarted process the supervisor still
        names quarantined)."""
        hs = self.router._states.get(name)
        if hs is not None:
            hs.barred = barred

    def _quarantine(self, name: str, strikes: int, reason: str) -> None:
        with self._lock:
            self._quarantined[name] = {"reason": reason,
                                       "strikes": strikes}
            self._dead.discard(name)  # quarantine supersedes the death
        self._bar(name, True)
        self.quarantines += 1
        self._c_quarantines.labels(name).inc()
        self._note(f"QUARANTINED {name}: {reason} — never respawned "
                   "again until `fleet release`", warning=True)

    def release(self, name: str) -> bool:
        """Operator surface: lift ``name``'s quarantine and clear its
        strike record, so the next dead-host detection respawns it.
        Returns False when nothing was quarantined under that name."""
        with self._lock:
            rec = self._quarantined.pop(name, None)
            self._strikes.pop(name, None)
            self._dead.discard(name)
        if rec is None:
            return False
        self._bar(name, False)
        self._note(f"released {name} from quarantine (operator)")
        return True

    def _spawn_engine(self, name: str) -> Any:
        """One spawn with bounded retry+backoff. Every attempt rides
        the ``fleet.spawn`` fault point — a fire fails only that
        attempt; exhausting the retries raises to the caller."""
        delay = self.policy.spawn_backoff_s
        for attempt in range(1, self.policy.spawn_retries + 1):
            try:
                fault_point("fleet.spawn", host=name, attempt=attempt)
                return self._spawn_fn(name)
            except Exception as e:  # noqa: BLE001 — retry with backoff
                self.spawn_failures += 1
                self._c_spawn_failures.labels(name).inc()
                if attempt >= self.policy.spawn_retries:
                    raise
                logger.warning("spawn of %s failed (attempt %d/%d: %r); "
                               "retrying in %.0f ms", name, attempt,
                               self.policy.spawn_retries, e, delay * 1e3)
                time.sleep(delay)
                delay *= 2

    def _respawn(self, hs: HostState, strikes: int) -> None:
        with self._lock:
            self._spawning.add(hs.name)
        try:
            engine = self._spawn_engine(hs.name)
        except Exception as e:  # noqa: BLE001 — an exhausted cycle strikes
            spawn_strikes = self._strike(hs.name)
            self._note(f"respawn of {hs.name} failed after "
                       f"{self.policy.spawn_retries} attempts ({e!r}); "
                       f"strike {spawn_strikes}/"
                       f"{self.policy.quarantine_strikes}", warning=True)
            if spawn_strikes >= self.policy.quarantine_strikes:
                self._quarantine(hs.name, spawn_strikes,
                                 f"crash loop: {spawn_strikes} "
                                 "deaths/spawn failures within "
                                 f"{self.policy.strike_window_s:.0f}s")
            return
        finally:
            with self._lock:
                self._spawning.discard(hs.name)
        old = hs.host.engine
        self._owned_engines.append(engine)
        hs.host.respawn(engine)
        with self._lock:
            self._dead.discard(hs.name)  # this death is healed
        if old is not None and old is not engine:
            # the replaced engine is garbage now — close it so its
            # dispatcher thread and device buffers don't leak one
            # engine per respawn in a long-running front end (engine
            # close is idempotent; a caller's teardown may close again)
            if old in self._owned_engines:
                self._owned_engines.remove(old)
            try:
                old.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        # restart the dead-host clock: the fresh engine gets a full
        # probation window before it can be declared dead again
        hs.probes_since_eject = 0
        hs.ejected_reason = "probation (respawned)"
        self.spawns += 1
        self._c_spawns.labels(hs.name).inc()
        self._note(f"respawned {hs.name} warm (strike {strikes}/"
                   f"{self.policy.quarantine_strikes}); awaiting "
                   "probation")

    def restart_host(self, name: str) -> int:
        """Planned warm restart — the in-process counterpart of a SIGTERM
        drain (``serve.fleet.migrate.respawn``). Live sequences first
        migrate bit-exact to admitted peers (the router path); what
        could not move (no peer admitted) is exported from the old
        engine, restored into the freshly spawned one and re-hooked onto
        its client future by :meth:`FleetRouter.reimport_host_entries`,
        so the restored run is the only compute (no step-0 re-route
        beside it). Engine-side sequences the router never admitted
        travel through :meth:`FleetHost.respawn`'s drain and restore. Returns the number of sequences carried
        across (migrated + re-hooked + drain-restored). With
        ``respawn_restore`` off this is a plain engine swap: in-flight
        work re-routes from step 0."""
        if self._spawn_fn is None:
            raise ServeError(
                "watch-only supervisor (no spawn_fn); cannot restart "
                f"host {name!r}")
        hs = next((s for s in self.router.monitor.states
                   if s.name == name), None)
        if hs is None:
            raise ServeError(f"unknown host {name!r}")
        moved = 0
        exported: list = []
        if self.policy.respawn_restore:
            moved = self.router.migrate_host(name, reason="respawn")
            # what could not migrate (no admitted peer) leaves the old
            # engine as (rid, blob) pairs with the router's callbacks
            # already detached — these re-hook after the respawn
            # instead of re-routing from step 0
            exported = self.router.export_host_entries(
                name, reason="respawn")
        old = hs.host.engine
        blobs: list = []
        if self.policy.respawn_restore and old is not None:
            # anything still live engine-side was never router-admitted
            # (direct submits); it rides the respawn drain/restore path
            drain = getattr(old, "drain_export", None)
            if drain is not None:
                try:
                    blobs = drain(reason="respawn")
                except Exception as e:  # noqa: BLE001 — best-effort
                    logger.warning(
                        "restart of %s: drain-export of the old engine "
                        "failed (%r); its slot-holders restart from "
                        "step 0", name, e)
                    blobs = []
        engine = self._spawn_engine(name)
        self._owned_engines.append(engine)
        hs.host.respawn(engine, sequences=blobs)
        restored = self.router.reimport_host_entries(name, exported)
        if old is not None and old is not engine:
            if old in self._owned_engines:
                self._owned_engines.remove(old)
            try:
                old.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        hs.probes_since_eject = 0
        hs.ejected_reason = "probation (restarted)"
        if hs.admitted:
            hs.admitted = False  # the fresh engine re-earns admission
        self.spawns += 1
        self._c_spawns.labels(name).inc()
        tm = self.router.telemetry
        for _ in range(restored + len(blobs)):
            tm.migrations("respawn").inc()
        self._note(f"restarted {name} warm: {moved} sequence(s) "
                   f"migrated to peers, {restored} re-hooked onto "
                   f"restored runs, {len(blobs)} drain-restored; "
                   "awaiting probation")
        return moved + restored + len(blobs)

    # -- autoscaling -------------------------------------------------------
    def _recent_attainment(self) -> float:
        """Attainment of the highest-priority class over the last
        window of ticks (counter DELTAS, not lifetime totals — see the
        window's construction note). 1.0 when nothing was judged
        recently."""
        cls = self.router.classes[0] if self.router.classes else ""
        snap = self.router.telemetry.attainment().get(cls, {})
        met = float(snap.get("met", 0))
        miss = float(snap.get("missed", 0))
        now = time.monotonic()
        if self._att_last is not None:
            d_met = met - self._att_last[0]
            d_miss = miss - self._att_last[1]
            if d_met or d_miss:
                self._att_window.append((now, d_met, d_miss))
        self._att_last = (met, miss)
        while (self._att_window
               and now - self._att_window[0][0] > self._att_window_s):
            self._att_window.popleft()
        w_met = sum(m for _, m, _x in self._att_window)
        w_miss = sum(x for _, _m, x in self._att_window)
        return w_met / (w_met + w_miss) if w_met + w_miss else 1.0

    def _signals(self) -> dict:
        """Router-side load signals one tick keys on."""
        states = list(self.router.monitor.states)
        admitted = [hs for hs in states if hs.admitted]
        live = [hs for hs in states
                if hs.name not in self._quarantined and not hs.draining]
        occs = [hs.last.occupancy for hs in admitted
                if hs.last is not None and hs.last.occupancy is not None]
        queued = sum(hs.last.queued for hs in admitted
                     if hs.last is not None)
        return {"pending": self.router.pending,
                "queued": queued,
                "occupancy": (sum(occs) / len(occs)) if occs else None,
                "attainment": self._recent_attainment(),
                "admitted": len(admitted), "live": len(live),
                "draining": sum(1 for hs in states if hs.draining)}

    def _autoscale(self) -> None:
        if self._spawn_fn is None:
            return
        p = self.policy
        sig = self._signals()
        occ = sig["occupancy"]
        want = 0
        if sig["live"] < p.max_hosts and (
                sig["pending"] >= p.up_pending
                or (occ is not None and occ >= p.up_occupancy)
                or sig["attainment"] < p.up_attainment):
            want = 1
        elif (sig["admitted"] > p.min_hosts and sig["draining"] == 0
                and sig["pending"] == 0 and sig["queued"] == 0
                and (occ is None or occ <= p.down_occupancy)):
            want = -1
        if want != 0 and want == self._scale_dir:
            self._scale_streak += 1
        else:
            self._scale_dir = want
            self._scale_streak = 1 if want else 0
        if want == 0 or self._scale_streak < p.scale_hysteresis:
            return
        key = "up" if want > 0 else "down"
        now = time.monotonic()
        if now < self._cooldown_until[key]:
            return
        self._scale_dir, self._scale_streak = 0, 0
        try:
            # the chaos hook: a fire aborts ONLY this decision (the
            # cooldown is NOT consumed — the next re-accumulated streak
            # may commit immediately; the hysteresis restart is the
            # "re-evaluates the signals from scratch" contract)
            fault_point("fleet.scale", direction=key, live=sig["live"],
                        pending=sig["pending"])
        except Exception as e:  # noqa: BLE001 — decision aborted, loudly
            self.scale_aborts += 1
            self._c_scale_aborts.inc()
            self._note(f"scale-{key} decision aborted ({e!r})",
                       warning=True)
            return
        self._cooldown_until[key] = now + (
            p.up_cooldown_s if want > 0 else p.down_cooldown_s)
        if want > 0:
            self._scale_up(sig)
        else:
            self._scale_down(sig)

    def _scale_up(self, sig: dict) -> None:
        taken = {hs.name for hs in self.router.monitor.states}
        n = self._next_spawn
        while f"s{n}" in taken:  # an operator may own s<N> names too
            n += 1
        name = f"s{n}"
        with self._lock:
            if name in self._quarantined:
                quarantined = True
            else:
                quarantined = False
        if quarantined:
            # a spawn crash loop quarantined this prospective name:
            # stop churning until the operator releases it
            if name not in self._unhealable_logged:
                self._unhealable_logged.add(name)
                logger.warning("scale-up suppressed: prospective host "
                               "%s is quarantined (spawn crash loop) — "
                               "`fleet release %s` to re-enable",
                               name, name)
            return
        try:
            engine = self._spawn_engine(name)
        except Exception as e:  # noqa: BLE001 — a cycle strikes; the
            # name stays STABLE until a spawn succeeds, so repeated
            # exhausted cycles accumulate toward quarantine instead of
            # churning fresh names forever
            strikes = self._strike(name)
            self._note(f"scale-up spawn of {name} failed ({e!r}); "
                       f"strike {strikes}/"
                       f"{self.policy.quarantine_strikes}", warning=True)
            if strikes >= self.policy.quarantine_strikes:
                self._quarantine(name, strikes,
                                 f"spawn crash loop: {strikes} exhausted "
                                 "spawn cycles within "
                                 f"{self.policy.strike_window_s:.0f}s")
            return
        # only a SUCCESSFUL spawn consumes the ordinal
        self._next_spawn = n + 1
        self._owned_engines.append(engine)
        self.router.add_host(FleetHost(name, engine))
        self._spawned_names.add(name)
        self.spawns += 1
        self.scale_ups += 1
        self._c_spawns.labels(name).inc()
        self._c_scale.labels("up").inc()
        self._note(f"scale-up: spawned {name} (pending={sig['pending']} "
                   f"occ={sig['occupancy']} att="
                   f"{sig['attainment']:.3f}); awaiting probation")

    def _scale_down(self, sig: dict) -> None:
        states = list(self.router.monitor.states)
        admitted = [hs for hs in states if hs.admitted]
        if len(admitted) <= self.policy.min_hosts:
            return
        # prefer retiring a host this supervisor spawned (hand-started
        # hosts are the operator's); among candidates the least loaded
        spawned = [hs for hs in admitted
                   if hs.name in self._spawned_names]
        pool = spawned or admitted

        def load(hs: HostState) -> tuple:
            last = hs.last
            return ((last.queued if last else 0),
                    (last.occupancy or 0.0) if last else 0.0)

        victim = min(pool, key=load)
        self.router.begin_retire(victim.name)
        moved = 0
        if self.policy.drain_migrate:
            # O(blob-ship) shrink (serve.fleet.migrate.drain): the
            # victim's slot-holders move bit-exact to the surviving
            # hosts instead of being waited out — retire_ready is then
            # judged against an already-empty pool. Whatever could not
            # move (no peer admitted) drains the slow way.
            moved = self.router.migrate_host(victim.name, reason="drain")
        self.scale_downs += 1
        self._c_scale.labels("down").inc()
        self._note(f"scale-down: draining {victim.name} "
                   f"(occ={sig['occupancy']}, migrated={moved}); "
                   "retires when its in-flight work completes")

    def _sweep_drains(self) -> None:
        for hs in list(self.router.monitor.states):
            if not hs.draining:
                continue
            if not self.router.retire_ready(hs.name):
                continue
            host = self.router.finish_retire(hs.name)
            self.retired += 1
            self._c_retired.inc()
            engine = host.engine
            if engine is not None and engine in self._owned_engines:
                self._owned_engines.remove(engine)
                try:
                    engine.close()
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass
            self._note(f"retired {hs.name}: drain ran out, host removed")

    # -- introspection / restart ------------------------------------------
    def _note(self, msg: str, warning: bool = False) -> None:
        self.last_decision = msg
        (logger.warning if warning else logger.info)("%s", msg)

    def _state_of(self, hs: HostState) -> str:
        with self._lock:
            if hs.name in self._quarantined:
                return "quarantined"
            if hs.name in self._spawning:
                return "spawning"
        if hs.draining:
            return "draining"
        if hs.admitted:
            return "live"
        if hs.ok_streak > 0:
            return "probation"
        return "ejected"

    def describe(self) -> dict:
        """The /healthz ``supervisor`` rider: per-host lifecycle state,
        quarantine records BY NAME, last decision, lifetime counts."""
        hosts = {hs.name: self._state_of(hs)
                 for hs in list(self.router.monitor.states)}
        with self._lock:
            quarantined = {n: r["reason"]
                           for n, r in self._quarantined.items()}
        return {"hosts": hosts, "quarantined": quarantined,
                "last_decision": self.last_decision or None,
                "spawns": self.spawns,
                "spawn_failures": self.spawn_failures,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "retired": self.retired,
                "quarantines": self.quarantines}

    def snapshot(self) -> dict:
        """Lifecycle state a restarted supervisor resumes from —
        quarantine records and strike clocks (as ages, so a resume
        re-anchors them against its own monotonic clock), next spawn
        ordinal, last decision. Pairs with ``FleetRouter.snapshot()``:
        a front-end restart loses neither requests nor history."""
        now = time.monotonic()
        with self._lock:
            return {
                "quarantined": {n: dict(r)
                                for n, r in self._quarantined.items()},
                "strike_ages": {n: [round(now - t, 6) for t in dq]
                                for n, dq in self._strikes.items() if dq},
                "next_spawn": self._next_spawn,
                "spawned_names": sorted(self._spawned_names),
                "last_decision": self.last_decision,
            }

    def _resume(self, snap: dict) -> None:
        now = time.monotonic()
        self._quarantined = {str(n): dict(r) for n, r
                             in snap.get("quarantined", {}).items()}
        self._strikes = {
            str(n): deque(sorted(now - float(a) for a in ages))
            for n, ages in snap.get("strike_ages", {}).items()}
        self._next_spawn = int(snap.get("next_spawn", self._next_spawn))
        self._spawned_names = {str(n)
                               for n in snap.get("spawned_names", ())}
        self.last_decision = str(snap.get("last_decision", "") or "")
        if self._quarantined:
            for name in self._quarantined:
                self._bar(name, True)  # the bar survives the restart
            logger.info("resumed supervisor state: %d quarantined "
                        "host(s) (%s) stay quarantined",
                        len(self._quarantined),
                        ", ".join(sorted(self._quarantined)))

    def __enter__(self) -> "FleetSupervisor":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()

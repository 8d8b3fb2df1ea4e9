"""Zero-downtime versioned rollout: shadow → canary → full → commit (the
JAX package's ``serve/rollout.py``).

A model update becomes a traffic shift instead of stop-the-world:

* :class:`RolloutEngine` wraps the current engine behind the engine surface
  (``submit``/``predict``/``stats``/``close``), so the transport and the
  fleet router route to it unchanged.
* :meth:`RolloutEngine.stage` loads version N+1 warm beside N: any fully
  built engine for the new checkpoint, its programs warmed at staging.
* **shadow**: every client request is served by N (the client future is
  N's own); a copy also goes to N+1 and, once both complete, the two are
  compared — per-version parity drift (max relative error against N's
  reply) and candidate latency accumulate in the rollout stats. The copy
  sits behind the ``fleet.rollout`` fault point and a catch-all: a shadow
  failure never fails the client's request (it counts as a candidate
  error).
* **canary**: a deterministic ``canary_pct`` share of requests is served
  by N+1 (a counter modulo 100, not a sample); a canary failure falls back
  to N (the client future resolves with N's answer), and any breach of
  :class:`RolloutGates` (candidate error, parity drift past the envelope,
  latency blow-up against N, attainment collapse) rolls back: the stage
  returns to ``stable``, the candidate gets no more traffic, the reason is
  recorded. Rollbacks fail no request.
* **full** → :meth:`commit`: all traffic on N+1; commit promotes the
  candidate and returns the old engine for the caller to close.

Per-version counters (requests, errors, latency, parity) land in a registry
of the rollout's own, rendered beside the current engine's ``/metrics``
(labels ``{version}``), and ``rollout_desc`` rides the ``/healthz`` body.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any

import numpy as np

from euromillioner_tpu_torch.core.precision import rel_error
from euromillioner_tpu_torch.obs.metrics import (MetricsRegistry,
                                                 global_registry, percentile,
                                                 render_prometheus)
from euromillioner_tpu_torch.resilience import fault_point
from euromillioner_tpu_torch.serve.batcher import (LATENCY_WINDOW,
                                                   resolve_future)
from euromillioner_tpu_torch.utils.errors import ServeError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("serve.rollout")

STAGES = ("stable", "shadow", "canary", "full")


@dataclass(frozen=True)
class RolloutGates:
    """Breach thresholds evaluated on every candidate completion.

    ``max_rel_err`` bounds shadow parity drift (candidate output vs the
    current version's reply for the SAME request — set it at the
    family's precision envelope, or ~1e-6 for an identical-artifact
    sanity rollout). ``max_latency_x`` bounds candidate p99 vs current
    p99 (judged once both sides have ``min_samples``).
    ``min_attainment`` bounds the candidate's deadline attainment over
    judged requests. ``max_errors`` candidate errors tolerated before
    rollback (0 = any error rolls back)."""

    max_rel_err: float = 1e-3
    max_latency_x: float = 3.0
    min_attainment: float = 0.9
    min_samples: int = 16
    max_errors: int = 0


def gates_from_config(fleet_cfg) -> tuple[RolloutGates, float]:
    """``serve.fleet.*`` rollout knobs → ``(RolloutGates, canary_pct)``
    — the one config mapping :meth:`RolloutEngine.from_config` and
    tests share (the rollout twin of cli._probe_policy)."""
    return (RolloutGates(max_rel_err=fleet_cfg.rollout_max_rel_err,
                         max_latency_x=fleet_cfg.rollout_max_latency_x,
                         min_attainment=fleet_cfg.rollout_min_attainment),
            fleet_cfg.canary_pct)


class _VersionStats:
    """Per-version accounting (mutated under the rollout lock)."""

    def __init__(self, name: str):
        self.name = name
        self.requests = 0
        self.errors = 0
        self.judged_met = 0
        self.judged_missed = 0
        self.latencies: collections.deque = collections.deque(
            maxlen=LATENCY_WINDOW)
        self.drift_last = 0.0
        self.drift_max = 0.0
        self.drift_checks = 0

    def p99_ms(self) -> float:
        return round(percentile(sorted(self.latencies), 0.99) * 1e3, 3)

    def attainment(self) -> float:
        n = self.judged_met + self.judged_missed
        return self.judged_met / n if n else 1.0

    def snapshot(self) -> dict:
        return {"requests": self.requests, "errors": self.errors,
                "p50_ms": round(percentile(sorted(self.latencies),
                                           0.50) * 1e3, 3),
                "p99_ms": self.p99_ms(),
                "attainment": round(self.attainment(), 4),
                "parity": {"checks": self.drift_checks,
                           "drift_last": round(self.drift_last, 8),
                           "drift_max": round(self.drift_max, 8)}}


class _RolloutTelemetry:
    """Transport-facing telemetry proxy: every attribute of the CURRENT
    engine's telemetry, with ``render()`` adding the rollout registry's
    per-version families to ``/metrics``."""

    def __init__(self, rollout: "RolloutEngine"):
        self._rollout = rollout

    def __getattr__(self, name: str):
        return getattr(self._rollout._current.telemetry, name)

    def render(self) -> str:
        cur = self._rollout._current.telemetry
        return render_prometheus(cur.registry, self._rollout.registry,
                                 global_registry())


class RolloutEngine:
    """Engine-surface wrapper shifting traffic between two versioned
    engines (see module docstring). Construction wraps the stable
    version; :meth:`stage` adds the candidate; :meth:`set_stage` moves
    the shift; gates auto-roll-back."""

    def __init__(self, engine: Any, version: str = "v1", *,
                 gates: RolloutGates | None = None,
                 canary_pct: float = 10.0):
        if not 0.0 < canary_pct <= 100.0:
            raise ServeError(
                f"canary_pct must be in (0, 100], got {canary_pct}")
        self._current = engine
        self._candidate: Any = None
        self.version = str(version)
        self.candidate_version = ""
        self.gates = gates or RolloutGates()
        self.canary_pct = float(canary_pct)
        self.stage_name = "stable"
        self.rollbacks = 0
        self.rollback_reason = ""
        self._n = 0  # deterministic canary split counter
        self._staging = False  # a stage() is mid-prestage (warmup)
        self._lock = threading.Lock()
        self._stats = {self.version: _VersionStats(self.version)}
        self.registry = MetricsRegistry()
        self._req_counter = self.registry.counter(
            "serve_version_requests_total",
            "Client requests served per model version", ("version",))
        self._err_counter = self.registry.counter(
            "serve_version_errors_total",
            "Candidate-side errors per model version", ("version",))
        self.registry.gauge(
            "serve_rollout_stage",
            "Rollout stage (0=stable 1=shadow 2=canary 3=full)").labels(
            ).set_function(lambda: STAGES.index(self.stage_name))
        self._rollback_counter = self.registry.counter(
            "serve_rollout_rollbacks_total",
            "Automatic rollbacks on gate breach").labels()
        self.telemetry = _RolloutTelemetry(self)

    @classmethod
    def from_config(cls, engine: Any, fleet_cfg,
                    version: str = "v1") -> "RolloutEngine":
        """Build a rollout wrapper from the ``serve.fleet.*`` knobs
        (canary_pct, rollout_max_rel_err, rollout_max_latency_x,
        rollout_min_attainment) — the front door config overrides
        reach the gates through."""
        gates, canary_pct = gates_from_config(fleet_cfg)
        return cls(engine, version, gates=gates, canary_pct=canary_pct)

    # -- engine-surface passthroughs -------------------------------------
    @property
    def kind(self) -> str:
        return getattr(self._current, "kind", "rows")

    @property
    def backend(self):
        return getattr(self._current, "backend", None)

    @property
    def session(self):
        return getattr(self._current, "session", None)

    @property
    def mesh_desc(self):
        return getattr(self._current, "mesh_desc", None)

    @property
    def slo_desc(self):
        return getattr(self._current, "slo_desc", None)

    @property
    def precision_desc(self):
        return getattr(self._current, "precision_desc", None)

    @property
    def load_desc(self):
        return getattr(self._current, "load_desc", None)

    @property
    def rollout_desc(self) -> dict:
        """The /healthz rider: serving version, stage, candidate, and
        rollback count — what a fleet probe reads to tell where each
        host's shift stands."""
        with self._lock:
            return {"version": self.version, "stage": self.stage_name,
                    "candidate": self.candidate_version or None,
                    "rollbacks": self.rollbacks}

    # -- staging / stage machine ------------------------------------------
    def stage(self, engine: Any, version: str, *,
              prestage: bool = True) -> None:
        """Load version N+1 warm beside N. ``engine`` must be a fully
        built engine for the same model kind. ``prestage`` (default)
        runs the candidate's idempotent ``warmup()`` here, so staging
        pays the compiles and the traffic shift does not: with the AOT
        store bound, every fresh compile also lands on disk, and a later
        warm spawn (or the committed version's next restart) compiles
        nothing. An engine without a ``warmup`` surface is staged as it
        is (logged)."""
        if getattr(engine, "kind", "rows") != self.kind:
            raise ServeError(
                f"candidate kind {getattr(engine, 'kind', 'rows')!r} != "
                f"current {self.kind!r}")
        with self._lock:
            # refuse BEFORE prestaging: a doomed stage() must not pay
            # (and persist) the whole compile ladder first — the
            # _staging flag also refuses a CONCURRENT stage() whose
            # rival is still mid-warmup
            if self._candidate is not None or self._staging:
                raise ServeError(
                    f"candidate {self.candidate_version or '(staging)'} "
                    "already staged — commit or rollback first")
            self._staging = True
        try:
            if prestage:
                warm = getattr(engine, "warmup", None)
                if callable(warm):
                    t0 = time.monotonic()
                    warm()
                    logger.info(
                        "pre-staged candidate %s: executable ladder "
                        "warmed in %.0f ms (compile-free traffic "
                        "shift)", version,
                        (time.monotonic() - t0) * 1e3)
                else:
                    logger.info("candidate %s has no warmup surface; "
                                "staged as-is", version)
            with self._lock:
                self._candidate = engine
                self.candidate_version = str(version)
                self._stats[self.candidate_version] = _VersionStats(
                    self.candidate_version)
                self.rollback_reason = ""
        finally:
            with self._lock:
                self._staging = False
        logger.info("staged candidate %s beside %s (stage=stable; "
                    "set_stage('shadow') to begin the shift)",
                    version, self.version)

    def set_stage(self, stage: str) -> None:
        if stage not in STAGES:
            raise ServeError(f"stage must be one of {STAGES}, got {stage!r}")
        with self._lock:
            if stage != "stable" and self._candidate is None:
                raise ServeError(f"stage {stage!r} needs a staged "
                                 "candidate (stage() first)")
            self.stage_name = stage
        logger.info("rollout stage -> %s (version=%s candidate=%s)",
                    stage, self.version, self.candidate_version or "-")

    def rollback(self, reason: str = "manual") -> Any:
        """Stop shifting traffic: stage returns to stable, the candidate
        is detached and returned (caller closes it). Idempotent."""
        with self._lock:
            cand = self._candidate
            if cand is None:
                return None
            self._candidate = None
            detached = self.candidate_version
            self.candidate_version = ""
            self.stage_name = "stable"
            self.rollbacks += 1
            self.rollback_reason = reason
        self._rollback_counter.inc()
        logger.warning("ROLLBACK of candidate %s: %s", detached, reason)
        return cand

    def commit(self) -> Any:
        """Promote the candidate to current (requires stage=full); the
        old engine is returned for the caller to drain/close."""
        with self._lock:
            if self._candidate is None or self.stage_name != "full":
                raise ServeError(
                    "commit needs a staged candidate at stage 'full' "
                    f"(stage={self.stage_name!r})")
            old, self._current = self._current, self._candidate
            self._candidate = None
            old_version = self.version
            self.version = self.candidate_version
            self.candidate_version = ""
            self.stage_name = "stable"
        logger.info("committed version %s (was %s)", self.version,
                    old_version)
        return old

    # -- request path ------------------------------------------------------
    def submit(self, x: np.ndarray, max_wait_s: float | None = None,
               cls: str | None = None,
               profile: str | None = None) -> Future:
        with self._lock:
            stage = self.stage_name
            cand = self._candidate
            if stage == "canary" and cand is not None:
                take_candidate = (self._n % 100) < self.canary_pct
                self._n += 1
            else:
                take_candidate = stage == "full" and cand is not None
        if cand is None or stage == "stable":
            return self._submit_current(x, max_wait_s, cls, profile)
        if stage == "shadow":
            return self._submit_shadow(cand, x, max_wait_s, cls, profile)
        if take_candidate:
            return self._submit_candidate(cand, x, max_wait_s, cls,
                                          profile)
        return self._submit_current(x, max_wait_s, cls, profile)

    def predict(self, x: np.ndarray, max_wait_s: float | None = None,
                cls: str | None = None,
                profile: str | None = None) -> np.ndarray:
        return self.submit(x, max_wait_s=max_wait_s, cls=cls,
                           profile=profile).result()

    @staticmethod
    def _profile_kw(profile) -> dict:
        # forwarded ONLY when the request names one: engines without
        # precision profiles keep their unchanged submit signature
        return {} if profile is None else {"profile": profile}

    def _submit_current(self, x, max_wait_s, cls,
                        profile=None) -> Future:
        t0 = time.monotonic()
        fut = self._current.submit(x, max_wait_s=max_wait_s, cls=cls,
                                   **self._profile_kw(profile))
        self._req_counter.labels(self.version).inc()
        fut.add_done_callback(
            lambda f: self._account(self.version, t0, f, max_wait_s))
        return fut

    def _submit_shadow(self, cand, x, max_wait_s, cls,
                       profile=None) -> Future:
        # the client future IS the current engine's — the mirror adds a
        # callback, never a wait (zero client-visible latency cost)
        fut = self._submit_current(x, max_wait_s, cls, profile)
        t0 = time.monotonic()
        try:
            fault_point("fleet.rollout", stage="shadow",
                        version=self.candidate_version)
            cfut = cand.submit(np.array(x, copy=True),
                               max_wait_s=max_wait_s, cls=cls,
                               **self._profile_kw(profile))
        except Exception as e:  # noqa: BLE001 — shadow must not touch clients
            self._candidate_error(e)
            return fut
        self._req_counter.labels(self.candidate_version).inc()
        version = self.candidate_version
        # compare only when BOTH sides are done: neither callback may
        # block a dispatcher thread waiting on the other engine
        left = [2]
        left_lock = threading.Lock()

        def compare() -> None:
            exc = cfut.exception()
            if exc is not None:
                self._candidate_error(exc)
                return
            if fut.exception() is not None:
                return  # current failed; nothing to compare against
            drift = rel_error(np.asarray(cfut.result()),
                              np.asarray(fut.result()))
            breach = None
            with self._lock:
                vs = self._stats.get(version)
                if vs is not None:
                    vs.drift_last = drift
                    vs.drift_max = max(vs.drift_max, drift)
                    vs.drift_checks += 1
                if drift > self.gates.max_rel_err:
                    breach = (f"shadow parity drift {drift:.3e} > "
                              f"{self.gates.max_rel_err:.3e}")
            if breach:
                self.rollback(breach)

        def arm(_f) -> None:
            with left_lock:
                left[0] -= 1
                ready = left[0] == 0
            if ready:
                compare()

        def on_candidate(_f) -> None:
            self._account(version, t0, cfut, max_wait_s,
                          judge=cfut.exception() is None)
            arm(_f)

        cfut.add_done_callback(on_candidate)
        fut.add_done_callback(arm)
        return fut

    def _submit_candidate(self, cand, x, max_wait_s, cls,
                          profile=None) -> Future:
        """Canary/full: serve from the candidate, but NEVER fail a
        client for the candidate's sake — an error falls back to the
        current version (and, in canary, rolls the shift back)."""
        client: Future = Future()
        t0 = time.monotonic()
        version = self.candidate_version
        try:
            fault_point("fleet.rollout", stage=self.stage_name,
                        version=version)
            cfut = cand.submit(x, max_wait_s=max_wait_s, cls=cls,
                               **self._profile_kw(profile))
        except Exception as e:  # noqa: BLE001 — fall back to current
            self._candidate_error(e)
            return self._submit_current(x, max_wait_s, cls, profile)
        self._req_counter.labels(version).inc()

        def done(_f) -> None:
            exc = cfut.exception()
            if exc is None:
                self._account(version, t0, cfut, max_wait_s)
                resolve_future(client, cfut.result())
                self._check_gates()
                return
            self._account(version, t0, cfut, max_wait_s, judge=False)
            self._candidate_error(exc)
            # transparent fallback: the client resolves with the stable
            # version's answer — a rollback costs zero failed requests
            try:
                fb = self._submit_current(x, max_wait_s, cls, profile)
            except Exception as e:  # noqa: BLE001 — both sides down
                resolve_future(client, exc=e)
                return
            fb.add_done_callback(
                lambda f: resolve_future(client, exc=f.exception())
                if f.exception() is not None
                else resolve_future(client, f.result()))

        cfut.add_done_callback(done)
        return client

    # -- accounting / gates ------------------------------------------------
    def _account(self, version: str, t0: float, fut: Future,
                 max_wait_s, judge: bool = True) -> None:
        now = time.monotonic()
        with self._lock:
            vs = self._stats.get(version)
            if vs is None:
                return
            vs.requests += 1
            if fut.exception() is not None:
                return
            vs.latencies.append(now - t0)
            if judge and max_wait_s is not None:
                if now - t0 <= float(max_wait_s):
                    vs.judged_met += 1
                else:
                    vs.judged_missed += 1

    def _candidate_error(self, exc: BaseException) -> None:
        with self._lock:
            version = self.candidate_version
            vs = self._stats.get(version)
            if vs is None:
                return
            vs.errors += 1
            errors = vs.errors
            stage = self.stage_name
        if version:
            self._err_counter.labels(version).inc()
        logger.warning("candidate %s error in stage %s: %r", version,
                       stage, exc)
        if errors > self.gates.max_errors:
            self.rollback(f"candidate errors {errors} > "
                          f"{self.gates.max_errors}")

    def _check_gates(self) -> None:
        """Latency/attainment gates, evaluated on candidate completions
        once both sides have ``min_samples``. Parity and error gates
        fire from their own paths."""
        breach = None
        with self._lock:
            cand = self._stats.get(self.candidate_version)
            cur = self._stats.get(self.version)
            if cand is None or cur is None:
                return
            g = self.gates
            if (len(cand.latencies) >= g.min_samples
                    and len(cur.latencies) >= g.min_samples):
                cp, sp = cand.p99_ms(), cur.p99_ms()
                if sp > 0 and cp > g.max_latency_x * sp:
                    breach = (f"candidate p99 {cp:.1f}ms > "
                              f"{g.max_latency_x}x current {sp:.1f}ms")
            n_judged = cand.judged_met + cand.judged_missed
            if (breach is None and n_judged >= g.min_samples
                    and cand.attainment() < g.min_attainment):
                breach = (f"candidate attainment {cand.attainment():.3f}"
                          f" < {g.min_attainment}")
        if breach:
            self.rollback(breach)

    # -- introspection / lifecycle ----------------------------------------
    def stats(self) -> dict:
        out = dict(self._current.stats())
        with self._lock:
            versions = {v: s.snapshot() for v, s in self._stats.items()}
            cur = self._stats.get(self.version)
            shadow_delta = None
            cand = self._stats.get(self.candidate_version)
            if cand is not None and cur is not None and cur.latencies \
                    and cand.latencies:
                shadow_delta = round(cand.p99_ms() - cur.p99_ms(), 3)
            out["rollout"] = {
                "version": self.version,
                "stage": self.stage_name,
                "candidate": self.candidate_version or None,
                "canary_pct": self.canary_pct,
                "rollbacks": self.rollbacks,
                "rollback_reason": self.rollback_reason or None,
                "versions": versions,
                # candidate-vs-current p99 gap: the "shadow traffic
                # never affects client latency" report rides here
                "candidate_p99_delta_ms": shadow_delta,
            }
        return out

    def close(self) -> None:
        with self._lock:
            cand, self._candidate = self._candidate, None
        if cand is not None:
            cand.close()
        self._current.close()

    def __enter__(self) -> "RolloutEngine":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()

"""The port's fleet supervisor (serve/supervisor.py), test for test as
tests/test_supervisor.py pins the JAX package's: the bounded probation-gap
dead-host signal, warm respawn of dead hosts through the router's own
probation (compile-free against the AOT store), crash-loop quarantine with
operator release, autoscale decisions (hysteresis, cooldowns, drain-never-
kill scale-down), ``fleet.spawn``/``fleet.scale`` chaos, supervisor
snapshot and resume beside the router's ledger, rollout pre-staging, the
admin and CLI surfaces, and the fleet-top lifecycle rendering; and the
config mapping against the JAX package's.

Probe rounds and supervisor ticks are driven synchronously
(``monitor.probe_once()`` / ``sup.tick()``). A reply's bit-exact oracle is
the step scheduler's block program at the pool's row count."""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.models.mlp import build_mlp
from euromillioner_tpu_torch.resilience import FaultPlan, FaultSpec, inject
from euromillioner_tpu_torch.serve import (FleetHost, FleetRouter,
                                           FleetSupervisor, InferenceEngine,
                                           NNBackend, ProbePolicy,
                                           RecurrentBackend, RolloutEngine,
                                           RolloutGates, StepScheduler,
                                           SupervisorPolicy, parse_probe,
                                           policy_from_config)
from euromillioner_tpu_torch.serve.aotstore import AotStore
from euromillioner_tpu_torch.serve.transport import healthz_body, make_server
from euromillioner_tpu_torch.utils.errors import ServeError

torch.set_num_threads(2)

WAIT = 60  # seconds any future or join may take
SLOTS = 4

FAST_POLICY = ProbePolicy(interval_s=30.0, timeout_s=2.0, retries=1,
                          jitter_s=0.0, eject_stale_probes=2,
                          eject_breach_probes=2, probation_probes=2)

# the loop never fires by itself (the tests tick); death after 2 probes
# past the ejection; a quick spawn backoff
FAST_SUP = SupervisorPolicy(interval_s=30.0, dead_after_probes=2,
                            spawn_retries=3, spawn_backoff_s=0.001,
                            quarantine_strikes=3, strike_window_s=300.0)


@pytest.fixture(scope="module")
def row_backend():
    model = build_mlp((8,), 1, in_features=5,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    return NNBackend(model, (5,), compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def seq_backend():
    model = build_lstm(8, 1, 3, fused="off", in_features=4,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    return RecurrentBackend(model, feat_dim=4, compute_dtype=torch.float32)


def _row_engine(backend, warmup=False):
    return InferenceEngine(backend, buckets=(8,), warmup=warmup)


def _seq_engine(backend, **kw):
    kw.setdefault("max_slots", SLOTS)
    kw.setdefault("step_block", 2)
    kw.setdefault("warmup", False)
    return StepScheduler(backend, **kw)


def _store(path):
    return AotStore(str(path), compiler="export")


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, 5)).astype(np.float32) for _ in range(n)]


def _seqs(n, seed=0, lo=2, hi=7):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(int(rng.integers(lo, hi)), 4))
            .astype(np.float32) for _ in range(n)]


def seq_want(backend, x, rows=SLOTS):
    """The step scheduler's reply: the block program at the pool's rows."""
    xs = torch.from_numpy(np.repeat(x[None], rows, 0))
    _, y = backend.block_fn(backend.init_states(rows), xs,
                            torch.ones((rows, 1), dtype=torch.bool))
    return y[0, -1].numpy()


def _probe_rounds(router, n):
    for _ in range(n):
        router.monitor.probe_once()


def _occ_body(occ, queued=0, att=1.0):
    """A slot host's /healthz body with an occupancy the test dials."""
    return {"ok": True, "healthz_version": 1,
            "attainment": {"interactive": att, "bulk": 1.0},
            "drift_breaches": 0, "queued": queued,
            "mean_occupancy": occ}


class _Spawner:
    """A spawn_fn that records what it built."""

    def __init__(self, make):
        self.make = make
        self.built = []

    def __call__(self, name):
        eng = self.make()
        self.built.append(eng)
        return eng


# ---------------------------------------------------------------------------
# the bounded probation gap (the dead-host signal)
# ---------------------------------------------------------------------------

class TestDeadHostSignal:
    def test_probes_since_eject_counts_and_resets(self, row_backend):
        e0, e1 = _row_engine(row_backend), _row_engine(row_backend)
        h1 = FleetHost("h1", e1)
        router = FleetRouter([FleetHost("h0", e0), h1],
                             policy=FAST_POLICY, start=False)
        try:
            h1.kill()
            _probe_rounds(router, 2)      # 2 stale probes: ejected
            hs = router._states["h1"]
            assert not hs.admitted and hs.probes_since_eject == 0
            assert router.monitor.dead_hosts(2) == []
            _probe_rounds(router, 2)
            assert hs.probes_since_eject == 2
            assert [d.name for d in router.monitor.dead_hosts(2)] == ["h1"]
            hosts = router._health()["fleet"]["hosts"]
            assert hosts["h1"]["probes_since_eject"] == 2
            assert "probes_since_eject" not in hosts["h0"]
            h1.revive()                   # a recovering host is not dead
            router.monitor.probe_once()
            assert hs.ok_streak == 1
            assert router.monitor.dead_hosts(2) == []
            router.monitor.probe_once()   # probation_probes=2: re-admitted
            assert hs.admitted and hs.probes_since_eject == 0
        finally:
            router.close(drain_s=0.0)
            e0.close()
            e1.close()

    def test_supervisor_keys_read_tolerantly(self, row_backend):
        with _row_engine(row_backend) as eng:
            body = healthz_body(eng)
        assert parse_probe(dict(body)).ok
        new_body = dict(body, lifecycle="live", probes_since_eject=0)
        assert parse_probe(new_body).ok


# ---------------------------------------------------------------------------
# self-healing: dead host → warm respawn → probation re-admission
# ---------------------------------------------------------------------------

class TestSelfHealing:
    def test_dead_host_respawned_and_readmitted_via_probation(
            self, seq_backend):
        e0 = _seq_engine(seq_backend, warmup=True)
        e1 = _seq_engine(seq_backend)
        h0, h1 = FleetHost("h0", e0), FleetHost("h1", e1)
        router = FleetRouter([h0, h1], policy=FAST_POLICY, start=False)
        spawn = _Spawner(lambda: _seq_engine(seq_backend))
        sup = FleetSupervisor(router, spawn, FAST_SUP, start=False)
        try:
            xs = _seqs(8)
            futs = [router.submit(x, max_wait_s=30.0) for x in xs]
            h1.kill()
            _probe_rounds(router, 2)      # eject + drain to h0
            sup.tick()                    # not dead yet
            assert sup.spawns == 0
            _probe_rounds(router, 2)      # past dead_after_probes=2
            sup.tick()
            assert sup.spawns == 1 and len(spawn.built) == 1
            assert h1.engine is spawn.built[0] and not h1.killed
            for x, fut in zip(xs, futs):
                np.testing.assert_array_equal(fut.result(timeout=WAIT),
                                              seq_want(seq_backend, x))
            assert not router._states["h1"].admitted  # probation decides
            _probe_rounds(router, 2)
            assert router._states["h1"].admitted
            futs2 = [router.submit(x, max_wait_s=30.0) for x in xs]
            for x, fut in zip(xs, futs2):
                np.testing.assert_array_equal(fut.result(timeout=WAIT),
                                              seq_want(seq_backend, x))
            assert spawn.built[0].stats()["sequences"] >= 1
            assert router.stats()["failed"] == 0
            st = router._health()["supervisor"]
            assert st["hosts"]["h1"] == "live" and st["spawns"] == 1
        finally:
            sup.close()
            router.close(drain_s=1.0)
            e0.close()
            e1.close()

    def test_respawn_against_warm_store_is_compile_free(self, seq_backend,
                                                        tmp_path):
        """The respawned engine loads its rung and gather from the store
        the first host filled: zero compiles on the replacement."""
        store_dir = tmp_path / "aot"
        e0 = _seq_engine(seq_backend, warmup=True)
        e1 = _seq_engine(seq_backend, warmup=True, aot=_store(store_dir))
        h0, h1 = FleetHost("h0", e0), FleetHost("h1", e1)
        router = FleetRouter([h0, h1], policy=FAST_POLICY, start=False)
        spawn = _Spawner(lambda: _seq_engine(seq_backend, warmup=True,
                                             aot=_store(store_dir)))
        sup = FleetSupervisor(router, spawn, FAST_SUP, start=False)
        try:
            h1.kill()
            _probe_rounds(router, 4)
            sup.tick()
            assert sup.spawns == 1
            repl = spawn.built[0]
            assert repl._exec.counts()["compiles"] == 0
            assert repl._exec.aot_counts()["hits"] >= 1
            _probe_rounds(router, 2)
            assert router._states["h1"].admitted
            x = _seqs(1)[0]
            np.testing.assert_array_equal(
                router.predict(x, max_wait_s=30.0), seq_want(seq_backend, x))
        finally:
            sup.close()
            router.close(drain_s=1.0)
            e0.close()
            e1.close()

    def test_watch_only_supervisor_never_spawns(self, row_backend):
        e0, e1 = _row_engine(row_backend), _row_engine(row_backend)
        h1 = FleetHost("h1", e1)
        router = FleetRouter([FleetHost("h0", e0), h1],
                             policy=FAST_POLICY, start=False)
        sup = FleetSupervisor(router, None, FAST_SUP, start=False)
        try:
            h1.kill()
            _probe_rounds(router, 4)
            sup.tick()
            sup.tick()
            assert sup.spawns == 0 and h1.killed
            assert (router._health()["supervisor"]["hosts"]["h1"]
                    == "ejected")
        finally:
            sup.close()
            router.close(drain_s=0.0)
            e0.close()
            e1.close()

    def test_watch_only_supervisor_still_quarantines(self, row_backend):
        e0, e1 = _row_engine(row_backend), _row_engine(row_backend)
        h1 = FleetHost("h1", e1)
        router = FleetRouter([FleetHost("h0", e0), h1],
                             policy=FAST_POLICY, start=False)
        pol = SupervisorPolicy(interval_s=30.0, dead_after_probes=2,
                               quarantine_strikes=2)
        sup = FleetSupervisor(router, None, pol, start=False)
        try:
            h1.kill()
            _probe_rounds(router, 4)
            sup.tick()                    # death 1: a strike, no respawn
            assert sup.spawns == 0 and sup.quarantines == 0
            sup.tick()                    # the same death: no new strike
            assert sup.quarantines == 0
            h1.revive()                   # restarted out of band
            _probe_rounds(router, 2)
            assert router._states["h1"].admitted
            sup.tick()                    # healed: the clock re-arms
            h1.kill()
            _probe_rounds(router, 4)
            sup.tick()                    # death 2 == quarantine_strikes
            assert sup.quarantines == 1 and sup.spawns == 0
            assert "h1" in router._health()["supervisor"]["quarantined"]
            # quarantine bars probation: healthy probes do not re-admit
            h1.revive()
            _probe_rounds(router, 4)
            assert not router._states["h1"].admitted
            assert (router._health()["supervisor"]["hosts"]["h1"]
                    == "quarantined")
            assert sup.release("h1") is True
            _probe_rounds(router, 2)
            assert router._states["h1"].admitted
        finally:
            sup.close()
            router.close(drain_s=0.0)
            e0.close()
            e1.close()


# ---------------------------------------------------------------------------
# chaos: fleet.spawn retries, crash-loop quarantine, operator release
# ---------------------------------------------------------------------------

class TestSpawnFaultsAndQuarantine:
    @pytest.fixture
    def fleet(self, seq_backend):
        e0 = _seq_engine(seq_backend)
        e1 = _seq_engine(seq_backend)
        h1 = FleetHost("h1", e1)
        router = FleetRouter([FleetHost("h0", e0), h1], policy=FAST_POLICY,
                             start=False)
        spawn = _Spawner(lambda: _seq_engine(seq_backend))
        sup = FleetSupervisor(router, spawn, FAST_SUP, start=False)
        try:
            yield router, sup, h1, spawn
        finally:
            sup.close()
            router.close(drain_s=0.0)
            e0.close()
            e1.close()

    def test_spawn_fault_retries_with_backoff(self, fleet):
        router, sup, h1, spawn = fleet
        h1.kill()
        _probe_rounds(router, 4)
        plan = FaultPlan([FaultSpec("fleet.spawn", raises=ServeError,
                                    hits=(1,))])
        with inject(plan):
            sup.tick()
        assert plan.fired_count("fleet.spawn") == 1
        assert sup.spawns == 1 and sup.spawn_failures == 1
        assert len(spawn.built) == 1 and not h1.killed

    def test_exhausted_spawn_cycle_strikes_then_next_tick_heals(self,
                                                                fleet):
        router, sup, h1, spawn = fleet
        h1.kill()
        _probe_rounds(router, 4)
        plan = FaultPlan([FaultSpec("fleet.spawn", raises=ServeError,
                                    times=FAST_SUP.spawn_retries)])
        with inject(plan):
            sup.tick()
        assert plan.fired_count("fleet.spawn") == FAST_SUP.spawn_retries
        assert sup.spawns == 0
        assert sup.spawn_failures == FAST_SUP.spawn_retries
        sup.tick()                        # the storm is over: healed
        assert sup.spawns == 1 and not h1.killed

    def test_crash_loop_quarantined_then_operator_release(self, fleet):
        router, sup, h1, spawn = fleet

        def die_once():
            _probe_rounds(router, 4)      # eject, then past the bound
            sup.tick()

        h1.kill()
        die_once()                        # strike 1: respawned
        assert sup.spawns == 1
        h1.kill()
        die_once()                        # strike 2: respawned
        assert sup.spawns == 2
        h1.kill()
        die_once()                        # strike 3: quarantined
        assert sup.spawns == 2 and sup.quarantines == 1
        desc = router._health()["supervisor"]
        assert desc["hosts"]["h1"] == "quarantined"
        assert "crash loop" in desc["quarantined"]["h1"]
        assert "h1" in healthz_body(router)["supervisor"]["quarantined"]
        for _ in range(3):
            _probe_rounds(router, 2)
            sup.tick()
        assert sup.spawns == 2
        assert int(router.telemetry.registry.counter(
            "fleet_quarantines_total", "", ("host",)).labels("h1")
            .get()) == 1
        assert router.release_host("h1") is True
        assert router.release_host("h1") is False
        sup.tick()
        assert sup.spawns == 3 and not h1.killed
        _probe_rounds(router, 2)
        assert router._states["h1"].admitted

    def test_release_without_supervisor_is_loud(self, row_backend):
        e0 = _row_engine(row_backend)
        router = FleetRouter([FleetHost("h0", e0)], policy=FAST_POLICY,
                             start=False)
        try:
            with pytest.raises(ServeError, match="no supervisor"):
                router.release_host("h0")
        finally:
            router.close(drain_s=0.0)
            e0.close()


# ---------------------------------------------------------------------------
# autoscaling: hysteresis, cooldowns, probation entry, drain-never-kill
# ---------------------------------------------------------------------------

class TestAutoscale:
    def test_scale_up_spawns_through_probation(self, seq_backend):
        e0 = _seq_engine(seq_backend, warmup=True)
        h0 = FleetHost("h0", e0, probe_fn=lambda: _occ_body(0.95))
        router = FleetRouter([h0], policy=FAST_POLICY, start=False)
        spawn = _Spawner(lambda: _seq_engine(seq_backend))
        pol = SupervisorPolicy(interval_s=30.0, autoscale=True,
                               min_hosts=1, max_hosts=2,
                               up_occupancy=0.8, down_occupancy=0.05,
                               scale_hysteresis=2, up_cooldown_s=0.0,
                               down_cooldown_s=0.0, dead_after_probes=99)
        sup = FleetSupervisor(router, spawn, pol, start=False)
        try:
            router.monitor.probe_once()
            sup.tick()                    # streak 1 of 2
            assert sup.scale_ups == 0
            sup.tick()                    # hysteresis met: scale up
            assert sup.scale_ups == 1 and len(spawn.built) == 1
            assert "s1" in router._states
            assert not router._states["s1"].admitted  # probation first
            _probe_rounds(router, 2)
            assert router._states["s1"].admitted
            for _ in range(3):            # at max_hosts: no more
                sup.tick()
            assert sup.scale_ups == 1
            assert router.monitor._pool_size >= len(router._states) + 2
            for x in _seqs(6):
                np.testing.assert_array_equal(
                    router.predict(x, max_wait_s=30.0),
                    seq_want(seq_backend, x))
            assert spawn.built[0].stats()["sequences"] >= 1
            st = router._health()["supervisor"]
            assert st["scale_ups"] == 1 and st["hosts"]["s1"] == "live"
        finally:
            sup.close()                   # closes the spawned engine
            router.close(drain_s=1.0)
            e0.close()

    def test_scale_down_picks_idle_victim_and_respects_min_hosts(
            self, seq_backend):
        e0 = _seq_engine(seq_backend)
        h0 = FleetHost("h0", e0, probe_fn=lambda: _occ_body(0.0))
        h1 = FleetHost("h1", e0, probe_fn=lambda: _occ_body(0.0))
        router = FleetRouter([h0, h1], policy=FAST_POLICY, start=False)
        pol = SupervisorPolicy(interval_s=30.0, autoscale=True,
                               min_hosts=1, max_hosts=2,
                               down_occupancy=0.25, scale_hysteresis=2,
                               up_cooldown_s=0.0, down_cooldown_s=0.0,
                               dead_after_probes=99)
        sup = FleetSupervisor(router, lambda name: _seq_engine(seq_backend),
                              pol, start=False)
        try:
            router.monitor.probe_once()
            sup.tick()
            sup.tick()                    # the down decision commits
            assert sup.scale_downs == 1
            draining = [n for n, hs in router._states.items()
                        if hs.draining]
            assert len(draining) == 1
            sup.tick()                    # drain empty: retired, removed
            assert sup.retired == 1
            assert draining[0] not in router._states
            for _ in range(3):            # the min_hosts floor
                sup.tick()
            assert sup.scale_downs == 1
            assert len(router._states) == 1
        finally:
            sup.close()
            router.close(drain_s=0.0)
            e0.close()

    def test_scale_down_drains_never_kills(self, seq_backend):
        e0 = _seq_engine(seq_backend, warmup=True)
        router = FleetRouter([FleetHost("h0", e0)], policy=FAST_POLICY,
                             start=False)
        pol = SupervisorPolicy(interval_s=30.0, autoscale=True,
                               min_hosts=1, max_hosts=2,
                               dead_after_probes=99)
        held = _seq_engine(seq_backend, start=False)  # holds its work
        sup = FleetSupervisor(router, lambda name: held, pol, start=False)
        sup._owned_engines.append(held)
        try:
            router.add_host(FleetHost("s1", held), admitted=True)
            xs = _seqs(6)
            futs = [router.submit(x, max_wait_s=60.0) for x in xs]
            assert any(e.host == "s1" for e in router._ledger.values())
            router.begin_retire("s1")
            sup.tick()                    # the drain has not run out
            assert "s1" in router._states and sup.retired == 0
            held.start()                  # the displaced work completes
            for x, fut in zip(xs, futs):
                np.testing.assert_array_equal(fut.result(timeout=WAIT),
                                              seq_want(seq_backend, x))
            deadline = time.monotonic() + 10
            while (not router.retire_ready("s1")
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            sup.tick()                    # ran out: retired and closed
            assert sup.retired == 1 and "s1" not in router._states
            assert router.stats()["failed"] == 0
        finally:
            sup.close()
            router.close(drain_s=1.0)
            e0.close()

    def test_exhausted_scale_up_cycles_quarantine_the_name(
            self, seq_backend):
        e0 = _seq_engine(seq_backend)
        h0 = FleetHost("h0", e0, probe_fn=lambda: _occ_body(0.95))
        router = FleetRouter([h0], policy=FAST_POLICY, start=False)
        pol = SupervisorPolicy(interval_s=30.0, autoscale=True,
                               min_hosts=1, max_hosts=2,
                               up_occupancy=0.8, scale_hysteresis=1,
                               up_cooldown_s=0.0, spawn_retries=1,
                               spawn_backoff_s=0.0, quarantine_strikes=2,
                               dead_after_probes=99)

        def broken_spawn(name):
            raise ServeError("spawn always fails")

        sup = FleetSupervisor(router, broken_spawn, pol, start=False)
        try:
            router.monitor.probe_once()
            sup.tick()                    # cycle 1: strike s1 (1/2)
            sup.tick()                    # cycle 2: quarantined
            assert sup.quarantines == 1
            assert "s1" in router._health()["supervisor"]["quarantined"]
            n_failures = sup.spawn_failures
            sup.tick()                    # suppressed: no fresh churn
            sup.tick()
            assert sup.spawn_failures == n_failures
            assert sup.spawns == 0 and "s1" not in router._states
        finally:
            sup.close()
            router.close(drain_s=0.0)
            e0.close()

    def test_scale_fault_aborts_only_that_decision(self, seq_backend):
        e0 = _seq_engine(seq_backend)
        h0 = FleetHost("h0", e0, probe_fn=lambda: _occ_body(0.0))
        h1 = FleetHost("h1", e0, probe_fn=lambda: _occ_body(0.0))
        router = FleetRouter([h0, h1], policy=FAST_POLICY, start=False)
        pol = SupervisorPolicy(interval_s=30.0, autoscale=True,
                               min_hosts=1, max_hosts=2,
                               scale_hysteresis=2, up_cooldown_s=0.0,
                               down_cooldown_s=0.0, dead_after_probes=99)
        sup = FleetSupervisor(router, lambda name: _seq_engine(seq_backend),
                              pol, start=False)
        try:
            router.monitor.probe_once()
            plan = FaultPlan([FaultSpec("fleet.scale", raises=ServeError,
                                        hits=(1,))])
            with inject(plan):
                sup.tick()
                sup.tick()                # the decision fires: aborted
                assert plan.fired_count("fleet.scale") == 1
                assert sup.scale_aborts == 1 and sup.scale_downs == 0
                assert not any(hs.draining
                               for hs in router._states.values())
                sup.tick()
                sup.tick()                # decided again, cleanly
            assert sup.scale_downs == 1
        finally:
            sup.close()
            router.close(drain_s=0.0)
            e0.close()


# ---------------------------------------------------------------------------
# restart: the router's ledger and the supervisor's lifecycle resume
# ---------------------------------------------------------------------------

class TestSupervisorRestart:
    def test_restart_loses_no_request_and_no_quarantine_record(
            self, seq_backend):
        e0 = _seq_engine(seq_backend, start=False)
        e1 = _seq_engine(seq_backend, start=False)
        h0, h1 = FleetHost("h0", e0), FleetHost("h1", e1)
        router = FleetRouter([h0, h1], policy=FAST_POLICY, start=False)
        pol = SupervisorPolicy(interval_s=30.0, dead_after_probes=2,
                               quarantine_strikes=2)
        spawn = _Spawner(lambda: _seq_engine(seq_backend, start=False))
        sup = FleetSupervisor(router, spawn, pol, start=False)
        router2 = sup2 = None
        try:
            xs = _seqs(6)
            futs = [router.submit(x, max_wait_s=60.0) for x in xs]
            h1.kill()
            _probe_rounds(router, 4)
            sup.tick()                    # strike 1: respawned
            assert sup.spawns == 1
            h1.kill()                     # the respawn dies too
            _probe_rounds(router, 4)
            sup.tick()                    # strike 2: quarantined
            assert sup.quarantines == 1 and sup.spawns == 1
            snap_s = sup.snapshot()       # the front end "dies"
            sup.close()
            snap_r = router.abandon()
            assert len(snap_r) == 6 and not any(f.done() for f in futs)
            router2 = FleetRouter([h0, h1], policy=FAST_POLICY, start=False,
                                  resume=snap_r)
            sup2 = FleetSupervisor(router2, spawn, pol, start=False,
                                   resume=snap_s)
            _probe_rounds(router2, 4)
            sup2.tick()                   # still quarantined: no respawn
            assert sup2.spawns == 0 and len(spawn.built) == 1
            assert "h1" in router2._health()["supervisor"]["quarantined"]
            e0.start()
            for x, fut in zip(xs, futs):
                np.testing.assert_array_equal(fut.result(timeout=WAIT),
                                              seq_want(seq_backend, x))
            assert router2.stats()["completed"] == 6
            assert sup2.release("h1") is True
            sup2.tick()
            assert sup2.spawns == 1
        finally:
            for s in (sup, sup2):
                if s is not None:
                    s.close()
            for r in (router, router2):
                if r is not None:
                    r.close(drain_s=1.0)
            for e in [e0, e1] + spawn.built:
                e.close()


# ---------------------------------------------------------------------------
# rollout pre-staging (compile-free canaries)
# ---------------------------------------------------------------------------

class TestRolloutPrestage:
    def test_stage_prewarms_candidate_ladder_into_the_store(
            self, seq_backend, tmp_path):
        store_dir = tmp_path / "aot"
        cur = _seq_engine(seq_backend, warmup=True)
        cand = _seq_engine(seq_backend, warmup=False, aot=_store(store_dir))
        assert cand._exec.counts()["compiles"] == 0  # provably cold
        ro = RolloutEngine(cur, "v1", gates=RolloutGates(max_rel_err=1e-6,
                                                         min_samples=4))
        warm = old = None
        try:
            ro.stage(cand, "v2")          # prestage=True
            n_staged = cand._exec.counts()["compiles"]
            assert n_staged >= 1          # compiled at staging
            assert cand._exec.aot_counts()["saves"] >= 1
            xs = _seqs(6)
            ref = [seq_want(seq_backend, x) for x in xs]
            for stage in ("shadow", "canary", "full"):
                ro.set_stage(stage)
                for x, want in zip(xs, ref):
                    np.testing.assert_array_equal(
                        ro.predict(x, max_wait_s=30.0), want)
            # the shift compiled nothing new on the candidate
            assert cand._exec.counts()["compiles"] == n_staged
            warm = _seq_engine(seq_backend, warmup=True,
                               aot=_store(store_dir))
            assert warm._exec.counts()["compiles"] == 0
            assert warm._exec.aot_counts()["hits"] >= 1
            np.testing.assert_array_equal(warm.predict(xs[0]), ref[0])
            old = ro.commit()
        finally:
            ro.close()
            for e in (old, warm):
                if e is not None:
                    e.close()

    def test_prestage_false_stages_cold(self, seq_backend, tmp_path):
        cur = _seq_engine(seq_backend)
        cand = _seq_engine(seq_backend, warmup=False,
                           aot=_store(tmp_path / "aot"))
        ro = RolloutEngine(cur, "v1")
        try:
            ro.stage(cand, "v2", prestage=False)
            assert cand._exec.counts()["compiles"] == 0
        finally:
            ro.close()


# ---------------------------------------------------------------------------
# fleet-top lifecycle rendering, the admin and CLI surfaces, the config
# ---------------------------------------------------------------------------

class TestLifecycleObs:
    def test_fleet_line_carries_spawn_and_quarantine(self, seq_backend):
        from euromillioner_tpu_torch.obs.top import (format_fleet_line,
                                                     parse_prometheus,
                                                     summarize_metrics)

        e0 = _seq_engine(seq_backend)
        e1 = _seq_engine(seq_backend)
        h1 = FleetHost("h1", e1)
        router = FleetRouter([FleetHost("h0", e0), h1],
                             policy=FAST_POLICY, start=False)
        pol = SupervisorPolicy(interval_s=30.0, dead_after_probes=2,
                               quarantine_strikes=2)
        sup = FleetSupervisor(router, lambda name: _seq_engine(seq_backend),
                              pol, start=False)
        try:
            h1.kill()
            _probe_rounds(router, 4)
            sup.tick()                    # strike 1: respawn (spawn=1)
            h1.kill()
            _probe_rounds(router, 4)
            sup.tick()                    # strike 2: quarantined (quar=1)
            assert sup.spawns == 1 and sup.quarantines == 1
            s = summarize_metrics(parse_prometheus(router.telemetry.render()))
            assert s["spawns"] == 1 and s["quarantined"] == 1
            line = format_fleet_line(0.0, {"front": s, "h9": {
                "attainment": 1.0, "completed": 3.0}})
            assert "spawn=1" in line and "quar=1" in line
            assert "h9[att=100.0%]" in line
        finally:
            sup.close()
            router.close(drain_s=0.0)
            e0.close()
            e1.close()

    def test_admin_release_route_and_cli(self, row_backend):
        from euromillioner_tpu_torch.cli import main

        e0 = _row_engine(row_backend)
        router = FleetRouter([FleetHost("h0", e0)], policy=FAST_POLICY,
                             start=False)
        sup = FleetSupervisor(router, None, FAST_SUP, start=False)
        sup._quarantine("h0", 3, "test quarantine")
        srv = make_server(router, "127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True,
                                  kwargs={"poll_interval": 0.05})
        thread.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            assert main(["fleet", "--release", "h0", "--front", url]) == 0
            assert "h0" not in sup._quarantined
            assert main(["fleet", "--release", "h0", "--front", url]) == 1
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=WAIT)
            sup.close()
            router.close(drain_s=0.0)
            e0.close()

    def test_admin_release_without_supervisor_404s(self, row_backend):
        with _row_engine(row_backend) as eng:
            srv = make_server(eng, "127.0.0.1", 0)
            thread = threading.Thread(target=srv.serve_forever, daemon=True,
                                      kwargs={"poll_interval": 0.05})
            thread.start()
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            try:
                req = urllib.request.Request(
                    url + "/admin/release",
                    data=json.dumps({"host": "h0"}).encode(),
                    headers={"Content-Type": "application/json"})
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(req, timeout=10)
                assert ei.value.code == 404
            finally:
                srv.shutdown()
                srv.server_close()
                thread.join(timeout=WAIT)

    def test_fleet_smoke_with_autoscale_reports_supervisor(self, capsys):
        from euromillioner_tpu_torch.cli import main

        rc = main(["fleet", "--smoke", "6", "--model-type", "mlp",
                   "--local-hosts", "2", "--autoscale", "--device", "cpu"])
        summary = json.loads(capsys.readouterr().out.strip()
                             .splitlines()[-1])
        assert rc == 0
        assert summary["requests"] == 6 and summary["failed"] == 0
        assert set(summary["supervisor"]["hosts"]) == {"h0", "h1"}
        assert summary["supervisor"]["quarantines"] == 0

    def test_policy_from_config_matches_the_jax_mapping(self):
        """Every serve.fleet.autoscale.* and serve.fleet.migrate.*
        override reaches the same SupervisorPolicy in both packages."""
        from euromillioner_tpu.config import Config as JaxConfig
        from euromillioner_tpu.config import \
            apply_overrides as jax_apply_overrides
        from euromillioner_tpu.serve.supervisor import \
            policy_from_config as jax_policy_from_config
        from euromillioner_tpu_torch.config import Config, apply_overrides

        overrides = ["serve.fleet.autoscale.enabled=true",
                     "serve.fleet.autoscale.min_hosts=2",
                     "serve.fleet.autoscale.max_hosts=5",
                     "serve.fleet.autoscale.interval_ms=50",
                     "serve.fleet.autoscale.up_cooldown_ms=300",
                     "serve.fleet.autoscale.dead_after_probes=4",
                     "serve.fleet.autoscale.spawn_backoff_ms=7",
                     "serve.fleet.autoscale.strike_window_s=60",
                     "serve.fleet.migrate.drain=false",
                     "serve.fleet.migrate.respawn=false"]
        fl = apply_overrides(Config(), overrides).serve.fleet
        jfl = jax_apply_overrides(JaxConfig(), overrides).serve.fleet
        got = policy_from_config(fl.autoscale, fl.migrate)
        want = jax_policy_from_config(jfl.autoscale, jfl.migrate)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.autoscale and got.min_hosts == 2
        assert not got.drain_migrate and not got.respawn_restore
        assert dataclasses.asdict(fl) == dataclasses.asdict(jfl)


# ---------------------------------------------------------------------------
# slow: an autoscaled chaos soak under a seeded storm
# ---------------------------------------------------------------------------

class TestSupervisorSoak:
    @pytest.mark.slow
    def test_autoscaled_chaos_soak_diurnal(self, seq_backend):
        """A compressed diurnal replay through a supervised 2-host fleet
        while a seeded FaultPlan storms fleet.spawn, fleet.probe and
        serve.step and a host is killed mid-replay: every event is
        completed or a counted error, the pools end leak-free, and a
        fault-free rerun completes every event."""
        from euromillioner_tpu_torch.obs.replay import replay_trace
        from euromillioner_tpu_torch.obs.workload import diurnal

        trace = diurnal(seed=3, duration_s=120.0, low_rps=2.0,
                        high_rps=10.0, period_s=30.0,
                        deadline_ms=(2000.0, 60000.0), bulk_shape=(8, 16))
        policy = ProbePolicy(interval_s=0.05, timeout_s=1.0, retries=1,
                             jitter_s=0.0, eject_stale_probes=2,
                             probation_probes=2)
        # min_hosts=2: the soak tests self-healing, not shrink-to-zero
        pol = SupervisorPolicy(interval_s=0.05, autoscale=True,
                               min_hosts=2, max_hosts=3,
                               dead_after_probes=2, spawn_retries=3,
                               spawn_backoff_s=0.005, quarantine_strikes=5,
                               up_cooldown_s=0.5, down_cooldown_s=2.0)

        def run(faulted: bool):
            engines = [_seq_engine(seq_backend, warmup=True)
                       for _ in range(2)]
            hosts = [FleetHost(f"h{i}", e) for i, e in enumerate(engines)]
            router = FleetRouter(hosts, policy=policy, max_route_attempts=6)
            sup = FleetSupervisor(router,
                                  lambda name: _seq_engine(seq_backend), pol)
            plan = FaultPlan([
                FaultSpec(point="fleet.probe", raises=ServeError,
                          probability=0.05, times=8),
                FaultSpec(point="fleet.spawn", raises=ServeError,
                          probability=0.5, times=2),
                FaultSpec(point="serve.step", raises=RuntimeError,
                          hits=(30,), times=1),
            ], seed=11)
            killer = threading.Timer(1.0, hosts[1].kill)
            killer.start()
            try:
                if faulted:
                    with inject(plan):
                        rep = replay_trace(router, trace, speed=4.0,
                                           timeout_s=120.0)
                else:
                    rep = replay_trace(router, trace, speed=4.0,
                                       timeout_s=120.0)
                st = router.stats()
                desc = sup.describe()
            finally:
                killer.cancel()
                sup.close()
                router.close(drain_s=10.0)
                for e in engines:
                    e.close()
            return rep, st, desc, plan, engines

        rep, st, desc, plan, engines = run(faulted=True)
        assert rep["completed"] + rep["errors"] == rep["events"]
        assert plan.fired_count("fleet.probe") >= 1
        assert desc["spawns"] >= 1
        for e in engines:
            s = e.stats()
            assert s["active"] == 0 and s["queued"] == 0
        rep2, st2, desc2, _plan2, _ = run(faulted=False)
        assert rep2["errors"] == 0
        assert rep2["completed"] == rep2["events"] == rep["events"]
        assert st2["failed"] == 0
        assert desc2["spawns"] >= 1

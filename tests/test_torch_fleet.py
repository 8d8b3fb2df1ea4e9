"""The port's fleet (serve/fleet.py, serve/router.py, serve/rollout.py, the
``fleet`` CLI), test for test as tests/test_fleet.py pins the JAX
package's: the /healthz schema the ejection policy keys on, router
placement and SLO judging,
SLO and staleness ejection with drain and bit-identical re-route, recovery
probation, router restart without request loss, versioned rollout, the
HTTP fleet, the fleet-top aggregation and the ``fleet --smoke`` CLI. Then
the two packages side by side: the same rows through a two-host router of
each (the MLP's JAX params carried across), each package's ``parse_probe``
on the other's ``/healthz`` body, and the two CLIs' smoke summaries.

Probe rounds are driven synchronously (``monitor.probe_once()``). The
bit-exact oracle of a reply is the program the engine runs: the step
scheduler's block program at the pool's row count (``max_slots``), the row
engine's program at its bucket."""

import json
import threading
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from euromillioner_tpu.models.mlp import build_mlp as jax_build_mlp
from euromillioner_tpu.serve import FleetHost as JaxFleetHost
from euromillioner_tpu.serve import FleetRouter as JaxFleetRouter
from euromillioner_tpu.serve import InferenceEngine as JaxInferenceEngine
from euromillioner_tpu.serve import ModelSession as JaxModelSession
from euromillioner_tpu.serve import NNBackend as JaxNNBackend
from euromillioner_tpu.serve import ProbePolicy as JaxProbePolicy
from euromillioner_tpu.serve import parse_probe as jax_parse_probe
from euromillioner_tpu.serve.transport import \
    healthz_body as jax_healthz_body
from euromillioner_tpu.utils.errors import ServeError as JaxServeError
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.models.mlp import build_mlp
from euromillioner_tpu_torch.resilience import FaultPlan, FaultSpec, inject
from euromillioner_tpu_torch.serve import (FleetHost, FleetRouter,
                                           InferenceEngine, NNBackend,
                                           ProbePolicy, RecurrentBackend,
                                           RolloutEngine, RolloutGates,
                                           StepScheduler, parse_probe)
from euromillioner_tpu_torch.serve.fleet import HEALTHZ_VERSION
from euromillioner_tpu_torch.serve.transport import healthz_body
from euromillioner_tpu_torch.utils.errors import ServeError

torch.set_num_threads(2)

WAIT = 60  # seconds any future or join may take
BUCKET = 8
SLOTS = 4
# port vs JAX in f32: the JAX package's NN pin
RTOL = 1e-5
ATOL = 1e-6

# rounds are driven by the tests: the loop itself never fires
FAST_POLICY = ProbePolicy(interval_s=30.0, timeout_s=2.0, retries=1,
                          jitter_s=0.0, eject_stale_probes=2,
                          eject_breach_probes=2, probation_probes=2)


@pytest.fixture(scope="module")
def mlp_pair():
    """The JAX package's MLP backend and the port's on the same params."""
    jm = jax_build_mlp(hidden_sizes=(8,), out_dim=1)
    params, _ = jm.init(jax.random.PRNGKey(0), (5,))
    tm = build_mlp((8,), 1, in_features=5, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params), "cpu"))
    return (JaxNNBackend(jm, params, (5,), compute_dtype=np.float32),
            NNBackend(tm, (5,), compute_dtype=torch.float32))


@pytest.fixture(scope="module")
def row_backend(mlp_pair):
    return mlp_pair[1]


@pytest.fixture(scope="module")
def seq_backend():
    model = build_lstm(8, 1, 3, fused="off", in_features=4,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    return RecurrentBackend(model, feat_dim=4, compute_dtype=torch.float32)


def _row_engine(backend, warmup=False):
    return InferenceEngine(backend, buckets=(BUCKET,), warmup=warmup)


def _seq_engine(backend, **kw):
    kw.setdefault("max_slots", SLOTS)
    kw.setdefault("step_block", 2)
    kw.setdefault("warmup", False)
    return StepScheduler(backend, **kw)


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, 5)).astype(np.float32) for _ in range(n)]


def _seqs(n, seed=0, lo=2, hi=7):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(int(rng.integers(lo, hi)), 4))
            .astype(np.float32) for _ in range(n)]


def row_want(backend, x):
    """The row engine's reply: the program at the bucket's row count."""
    pad = np.zeros((BUCKET - len(x), *x.shape[1:]), np.float32)
    return backend.predict(np.concatenate([x, pad]))[:len(x)]


def seq_want(backend, x, rows=SLOTS):
    """The step scheduler's reply: the block program at the pool's rows."""
    xs = torch.from_numpy(np.repeat(x[None], rows, 0))
    _, y = backend.block_fn(backend.init_states(rows), xs,
                            torch.ones((rows, 1), dtype=torch.bool))
    return y[0, -1].numpy()


# ---------------------------------------------------------------------------
# the /healthz body as a versioned schema
# ---------------------------------------------------------------------------

class TestHealthzSchema:
    def test_row_engine_body_carries_keyed_fields(self, row_backend):
        with _row_engine(row_backend) as eng:
            body = healthz_body(eng)
        assert body["healthz_version"] == HEALTHZ_VERSION == 1
        assert body["ok"] is True
        assert isinstance(body["attainment"], dict)
        assert "drift_breaches" in body
        assert "queue_depth" in body  # the row engine's queue figure
        view = parse_probe(body)
        assert view.ok and view.queued == 0

    def test_sequence_engine_body_carries_keyed_fields(self, seq_backend):
        with _seq_engine(seq_backend) as eng:
            eng.predict(_seqs(1)[0])
            body = healthz_body(eng)
        assert body["healthz_version"] == 1
        assert isinstance(body["attainment"], dict)
        assert "drift_breaches" in body
        assert "queued" in body and "slots" in body and "active" in body
        assert "mean_occupancy" in body
        assert parse_probe(body).occupancy is not None

    def test_missing_keyed_field_is_loud(self, row_backend):
        with _row_engine(row_backend) as eng:
            body = healthz_body(eng)
        del body["attainment"]
        with pytest.raises(ServeError, match="attainment"):
            parse_probe(body)
        with pytest.raises(ServeError, match="keys on"):
            parse_probe({"ok": True})  # liveness alone is no probe body

    def test_newer_schema_version_rejected(self, row_backend):
        with _row_engine(row_backend) as eng:
            body = healthz_body(eng)
        body["healthz_version"] = HEALTHZ_VERSION + 1
        with pytest.raises(ServeError, match="newer"):
            parse_probe(body)

    def test_rollout_rider_does_not_break_probes(self, row_backend):
        with RolloutEngine(_row_engine(row_backend), "v1") as ro:
            body = healthz_body(ro)
            assert body["rollout"]["version"] == "v1"
            parse_probe(body)

    def test_preempt_keys_surface_and_stay_optional(self, row_backend,
                                                    seq_backend):
        with _seq_engine(seq_backend) as eng:
            eng.predict(_seqs(1)[0])
            body = healthz_body(eng)
        assert body["preempted"] == 0 and body["evicted_depth"] == 0
        view = parse_probe(body)
        assert view.preempted == 0 and view.evicted_depth == 0
        with _row_engine(row_backend) as eng:
            row_body = healthz_body(eng)
        assert "preempted" not in row_body
        row_view = parse_probe(row_body)
        assert row_view.ok
        assert row_view.preempted is None and row_view.evicted_depth is None

    def test_budget_keys_surface_and_stay_optional(self, row_backend,
                                                   seq_backend):
        with _seq_engine(seq_backend) as eng:
            eng.predict(_seqs(1)[0])
            body = healthz_body(eng)
        assert body["ledger_bytes"] == 0 and body["spilled"] == 0
        view = parse_probe(body)
        assert view.ledger_bytes == 0 and view.spilled == 0
        old_body = {k: v for k, v in body.items()
                    if k not in ("ledger_bytes", "spilled")}
        old_view = parse_probe(old_body)
        assert old_view.ok
        assert old_view.ledger_bytes is None and old_view.spilled is None
        with _row_engine(row_backend) as eng:
            row_body = healthz_body(eng)
        assert "ledger_bytes" not in row_body
        row_view = parse_probe(row_body)
        assert row_view.ok and row_view.ledger_bytes is None


# ---------------------------------------------------------------------------
# the router: placement, affinity, SLO judging
# ---------------------------------------------------------------------------

class TestFleetRouter:
    def test_routes_bit_equal_and_balances(self, row_backend):
        e0, e1 = _row_engine(row_backend, warmup=True), \
            _row_engine(row_backend)
        router = FleetRouter([FleetHost("h0", e0), FleetHost("h1", e1)],
                             policy=FAST_POLICY, start=False)
        try:
            xs = _rows(10)
            outs = [router.predict(x, max_wait_s=5.0) for x in xs]
            for x, got in zip(xs, outs):
                np.testing.assert_array_equal(got, row_want(row_backend, x))
            st = router.stats()
            assert st["completed"] == 10 and st["failed"] == 0
            assert e0.stats()["requests"] > 0 and e1.stats()["requests"] > 0
            assert st["slo"]["interactive"] == {"met": 10, "missed": 0,
                                                "attainment": 1.0}
        finally:
            router.close(drain_s=1.0)
            e0.close()
            e1.close()

    def test_sequence_affinity_one_host_per_sequence(self, seq_backend):
        e0, e1 = _seq_engine(seq_backend), _seq_engine(seq_backend)
        router = FleetRouter([FleetHost("h0", e0), FleetHost("h1", e1)],
                             policy=FAST_POLICY, start=False)
        try:
            assert router.kind == "sequence"
            xs = _seqs(8)
            outs = [router.submit(x).result(timeout=WAIT) for x in xs]
            for x, got in zip(xs, outs):
                np.testing.assert_array_equal(got, seq_want(seq_backend, x))
            done = (e0.stats()["sequences"], e1.stats()["sequences"])
            assert sum(done) == 8 and all(d > 0 for d in done)
        finally:
            router.close(drain_s=1.0)
            e0.close()
            e1.close()

    def test_unknown_class_and_bad_fleets_rejected(self, row_backend):
        e0 = _row_engine(row_backend)
        h0 = FleetHost("h0", e0)
        try:
            with pytest.raises(ServeError, match="duplicate"):
                FleetRouter([h0, FleetHost("h0", e0)], start=False)
            router = FleetRouter([h0], policy=FAST_POLICY, start=False)
            with pytest.raises(ServeError, match="unknown request class"):
                router.submit(_rows(1)[0], cls="nope")
            router.close(drain_s=0.0)
        finally:
            e0.close()

    def test_mixed_kind_fleet_rejected(self, row_backend, seq_backend):
        e0, e1 = _row_engine(row_backend), _seq_engine(seq_backend)
        try:
            with pytest.raises(ServeError, match="one model kind"):
                FleetRouter([FleetHost("h0", e0), FleetHost("h1", e1)],
                            start=False)
        finally:
            e0.close()
            e1.close()

    def test_close_fails_parked_requests(self, row_backend):
        e0 = _row_engine(row_backend)
        router = FleetRouter([FleetHost("h0", e0)], policy=FAST_POLICY,
                             start=False)
        try:
            router.eject_host("h0")       # total outage: submits park
            fut = router.submit(_rows(1)[0], max_wait_s=5.0)
            assert router.pending == 1 and not fut.done()
            router.close(drain_s=0.2)
            with pytest.raises(ServeError, match="router closed"):
                fut.result(timeout=1)
            st = router.stats()
            assert st["failed"] == 1 and st["pending"] == 0
        finally:
            router.close(drain_s=0.0)
            e0.close()

    def test_outage_queue_bound_sheds_loudly(self, row_backend):
        e0 = _row_engine(row_backend)
        router = FleetRouter([FleetHost("h0", e0)], policy=FAST_POLICY,
                             start=False, max_pending=2)
        try:
            router.eject_host("h0")
            parked = [router.submit(r, max_wait_s=5.0) for r in _rows(2)]
            assert router.pending == 2
            shed_fut = router.submit(_rows(1, seed=1)[0], max_wait_s=5.0)
            with pytest.raises(ServeError, match="shed"):
                shed_fut.result(timeout=1)
            st = router.stats()
            assert st["shed"] == 1 and st["pending"] == 2
            assert int(router.telemetry.shed.get()) == 1
            hs = router._states["h0"]
            for _ in range(FAST_POLICY.probation_probes):
                router.monitor.probe_once()
            assert hs.admitted
            for f in parked:
                assert f.result(timeout=WAIT) is not None
        finally:
            router.close(drain_s=1.0)
            e0.close()

    def test_max_pending_validated(self, row_backend):
        e0 = _row_engine(row_backend)
        try:
            with pytest.raises(ServeError, match="max_pending"):
                FleetRouter([FleetHost("h0", e0)], start=False,
                            max_pending=0)
        finally:
            e0.close()

    def test_probe_round_budget_covers_retries(self, row_backend):
        e0 = _row_engine(row_backend)
        router = FleetRouter(
            [FleetHost("h0", e0)], start=False,
            policy=ProbePolicy(timeout_s=1.0, retries=3, jitter_s=0.0))
        try:
            assert router.monitor._round_budget_s >= 3.0
        finally:
            router.close(drain_s=0.0)
            e0.close()


# ---------------------------------------------------------------------------
# chaos: ejection, drain and re-route, probation, route faults
# ---------------------------------------------------------------------------

class TestEjectionAndReroute:
    def test_host_kill_mid_sequence_reroutes_bit_identical(self,
                                                           seq_backend):
        """A host dying with sequences on it is ejected on probe
        staleness, its sequences drain to the other host, and every client
        future resolves bit-identical to the unfaulted program (both pools
        step at the same row count)."""
        e0 = _seq_engine(seq_backend, warmup=True)
        # h1 never dispatches: its sequences are in flight at the kill
        e1 = _seq_engine(seq_backend, start=False)
        h0, h1 = FleetHost("h0", e0), FleetHost("h1", e1)
        router = FleetRouter([h0, h1], policy=FAST_POLICY, start=False)
        try:
            xs = _seqs(8)
            futs = [router.submit(x, max_wait_s=30.0) for x in xs]
            h1.kill()
            router.monitor.probe_once()
            router.monitor.probe_once()  # the 2nd stale probe ejects
            st = router.stats()
            assert not st["hosts"]["h1"]["admitted"]
            assert "stale" in st["hosts"]["h1"]["ejected_reason"]
            for x, fut in zip(xs, futs):
                np.testing.assert_array_equal(fut.result(timeout=WAIT),
                                              seq_want(seq_backend, x))
            st = router.stats()
            assert st["completed"] == 8 and st["failed"] == 0
            assert st["rerouted"] >= 1
            assert e0.stats()["active"] == 0 and e0.stats()["queued"] == 0
        finally:
            router.close(drain_s=1.0)
            e0.close()
            e1.close()

    def test_killed_host_respawns_warm_and_rejoins_via_probation(
            self, seq_backend, tmp_path):
        """A killed host's work drains bit-identical; the host respawns
        on an engine built against the warm AOT store (no compile) and the
        router's own probation re-admits it."""
        from euromillioner_tpu_torch.serve.aotstore import AotStore

        store_dir = str(tmp_path / "aot")
        e0 = _seq_engine(seq_backend, warmup=True)
        e1 = _seq_engine(seq_backend, warmup=True,
                         aot=AotStore(store_dir, compiler="export"))
        h0, h1 = FleetHost("h0", e0), FleetHost("h1", e1)
        router = FleetRouter([h0, h1], policy=FAST_POLICY, start=False)
        e1b = None
        try:
            xs = _seqs(8)
            futs = [router.submit(x, max_wait_s=30.0) for x in xs]
            h1.kill()
            router.monitor.probe_once()
            router.monitor.probe_once()
            assert not router.stats()["hosts"]["h1"]["admitted"]
            for x, fut in zip(xs, futs):
                np.testing.assert_array_equal(fut.result(timeout=WAIT),
                                              seq_want(seq_backend, x))
            e1b = _seq_engine(seq_backend, warmup=True,
                              aot=AotStore(store_dir, compiler="export"))
            assert e1b._exec.counts()["compiles"] == 0
            assert e1b._exec.aot_counts()["hits"] >= 1
            h1.respawn(e1b)
            assert not router.stats()["hosts"]["h1"]["admitted"]
            router.monitor.probe_once()
            router.monitor.probe_once()
            assert router.stats()["hosts"]["h1"]["admitted"]
            futs2 = [router.submit(x, max_wait_s=30.0) for x in xs]
            for x, fut in zip(xs, futs2):
                np.testing.assert_array_equal(fut.result(timeout=WAIT),
                                              seq_want(seq_backend, x))
            assert router.stats()["failed"] == 0
            assert e1b.stats()["sequences"] >= 1
        finally:
            router.close(drain_s=1.0)
            for e in (e0, e1, e1b):
                if e is not None:
                    e.close()

    def test_probe_fault_storm_ejects_then_probation_readmits(
            self, row_backend):
        e0, e1 = _row_engine(row_backend), _row_engine(row_backend)
        router = FleetRouter([FleetHost("h0", e0), FleetHost("h1", e1)],
                             policy=FAST_POLICY, start=False)
        try:
            # 2 hosts x 1 attempt x 2 rounds = 4 fires
            plan = FaultPlan([FaultSpec("fleet.probe", raises=ServeError,
                                        times=4)])
            with inject(plan):
                router.monitor.probe_once()
                router.monitor.probe_once()
            assert plan.fired_count("fleet.probe") == 4
            st = router.stats()
            assert not st["hosts"]["h0"]["admitted"]
            assert not st["hosts"]["h1"]["admitted"]
            fut = router.submit(_rows(1)[0], max_wait_s=30.0)
            assert router.pending == 1
            router.monitor.probe_once()
            router.monitor.probe_once()
            st = router.stats()
            assert (st["hosts"]["h0"]["admitted"]
                    and st["hosts"]["h1"]["admitted"])
            np.testing.assert_array_equal(
                fut.result(timeout=WAIT), row_want(row_backend, _rows(1)[0]))
            assert router.pending == 0
        finally:
            router.close(drain_s=1.0)
            e0.close()
            e1.close()

    def test_route_fault_reroutes_and_completes(self, row_backend):
        e0, e1 = _row_engine(row_backend), _row_engine(row_backend)
        router = FleetRouter([FleetHost("h0", e0), FleetHost("h1", e1)],
                             policy=FAST_POLICY, start=False)
        try:
            x = _rows(1)[0]
            plan = FaultPlan([FaultSpec("fleet.route", raises=ServeError,
                                        hits=(1,))])
            with inject(plan):
                out = router.predict(x, max_wait_s=30.0)
            np.testing.assert_array_equal(out, row_want(row_backend, x))
            assert plan.fired_count("fleet.route") == 1
            st = router.stats()
            assert st["rerouted"] == 1 and st["failed"] == 0
        finally:
            router.close(drain_s=1.0)
            e0.close()
            e1.close()

    def test_attainment_collapse_ejects_slo_keyed(self, row_backend):
        e0 = _row_engine(row_backend)
        sick = {"ok": True, "healthz_version": 1,
                "attainment": {"interactive": 0.2, "bulk": 1.0},
                "drift_breaches": 0, "queue_depth": 0}
        h0 = FleetHost("h0", e0)
        h1 = FleetHost("h1", submit_fn=e0.submit, probe_fn=lambda: sick)
        router = FleetRouter([h0, h1], policy=FAST_POLICY, start=False)
        try:
            router.monitor.probe_once()
            router.monitor.probe_once()
            st = router.stats()
            assert st["hosts"]["h0"]["admitted"]
            assert not st["hosts"]["h1"]["admitted"]
            assert ("attainment collapse"
                    in st["hosts"]["h1"]["ejected_reason"])
            sick["attainment"]["interactive"] = 1.0
            router.monitor.probe_once()
            router.monitor.probe_once()
            assert router.stats()["hosts"]["h1"]["admitted"]
        finally:
            router.close(drain_s=0.0)
            e0.close()

    def test_exhausted_route_attempts_fail_the_future(self, row_backend):
        e0 = _row_engine(row_backend)
        router = FleetRouter([FleetHost("h0", e0)], policy=FAST_POLICY,
                             max_route_attempts=2, start=False)
        try:
            plan = FaultPlan([FaultSpec("fleet.route", raises=ServeError)])
            with inject(plan):
                fut = router.submit(_rows(1)[0])
                with pytest.raises(ServeError):
                    fut.result(timeout=WAIT)
            assert plan.fired_count("fleet.route") == 2  # both attempts
            st = router.stats()
            assert st["failed"] == 1 and st["completed"] == 0
        finally:
            router.close(drain_s=0.0)
            e0.close()


# ---------------------------------------------------------------------------
# router restart: no admitted request lost
# ---------------------------------------------------------------------------

class TestRouterRestart:
    def test_restart_mid_flight_loses_no_admitted_request(self,
                                                          seq_backend):
        e0 = _seq_engine(seq_backend, start=False)
        e1 = _seq_engine(seq_backend, start=False)
        h0, h1 = FleetHost("h0", e0), FleetHost("h1", e1)
        router = FleetRouter([h0, h1], policy=FAST_POLICY, start=False)
        router2 = None
        try:
            xs = _seqs(6)
            futs = [router.submit(x, max_wait_s=30.0) for x in xs]
            snap = router.abandon()       # the router process "dies"
            assert len(snap) == 6
            assert not any(f.done() for f in futs)
            router2 = FleetRouter([h0, h1], policy=FAST_POLICY, start=False,
                                  resume=snap)
            e0.start()
            e1.start()
            for x, fut in zip(xs, futs):
                np.testing.assert_array_equal(fut.result(timeout=WAIT),
                                              seq_want(seq_backend, x))
            st = router2.stats()
            assert st["requests"] == 6 and st["completed"] == 6
        finally:
            if router2 is not None:
                router2.close(drain_s=1.0)
            e0.close()
            e1.close()


# ---------------------------------------------------------------------------
# versioned rollout: shadow, canary, gates, rollback
# ---------------------------------------------------------------------------

def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)


class TestRollout:
    def test_full_shift_commit_bit_equal_throughout(self, row_backend):
        cur = _row_engine(row_backend, warmup=True)
        cand = _row_engine(row_backend)
        ro = RolloutEngine(cur, "v1", gates=RolloutGates(max_rel_err=1e-6,
                                                         min_samples=4))
        old = None
        try:
            xs = _rows(24)
            ref = [row_want(row_backend, x) for x in xs]
            ro.stage(cand, "v2")
            for stage in ("shadow", "canary", "full"):
                ro.set_stage(stage)
                for x, want in zip(xs, ref):
                    np.testing.assert_array_equal(
                        ro.predict(x, max_wait_s=5.0), want)
                if stage == "shadow":
                    _wait_for(lambda: ro.stats()["rollout"][
                        "candidate_p99_delta_ms"] is not None)
                    assert (ro.stats()["rollout"]["candidate_p99_delta_ms"]
                            is not None)
            old = ro.commit()
            assert old is cur and ro.version == "v2"
            np.testing.assert_array_equal(ro.predict(xs[0]), ref[0])
            st = ro.stats()["rollout"]
            assert st["rollbacks"] == 0 and st["stage"] == "stable"
            assert st["versions"]["v2"]["parity"]["checks"] > 0
            assert st["versions"]["v2"]["parity"]["drift_max"] == 0.0
            assert st["candidate_p99_delta_ms"] is None
        finally:
            ro.close()
            (old or cand).close()

    def test_shadow_drift_breach_auto_rolls_back_zero_failures(
            self, row_backend):
        model = build_mlp((8,), 1, in_features=5, device="cpu")
        model.load_state_dict({k: v + 1.0 for k, v in
                               row_backend.model.state_dict().items()})
        bad = NNBackend(model, (5,), compute_dtype=torch.float32)
        cur = _row_engine(row_backend)
        cand = _row_engine(bad)
        ro = RolloutEngine(cur, "v1", gates=RolloutGates(max_rel_err=1e-6))
        try:
            ro.stage(cand, "v2-broken")
            ro.set_stage("shadow")
            xs = _rows(6)
            outs = [ro.predict(x, max_wait_s=5.0) for x in xs]
            for x, got in zip(xs, outs):
                np.testing.assert_array_equal(got, row_want(row_backend, x))
            _wait_for(lambda: ro.stage_name == "stable")
            st = ro.stats()["rollout"]
            assert st["stage"] == "stable" and st["rollbacks"] == 1
            assert "drift" in st["rollback_reason"]
        finally:
            ro.close()
            cand.close()

    def test_canary_error_falls_back_and_rolls_back_zero_failures(
            self, row_backend):
        class BrokenEngine:
            kind = "rows"

            def submit(self, x, max_wait_s=None, cls=None):
                f = Future()
                f.set_exception(ServeError("candidate exploded"))
                return f

            def stats(self):
                return {}

            def close(self):
                pass

        cur = _row_engine(row_backend)
        ro = RolloutEngine(cur, "v1", canary_pct=100.0,
                           gates=RolloutGates(max_errors=0))
        try:
            ro.stage(BrokenEngine(), "v2-broken")
            ro.set_stage("canary")
            for x in _rows(5):
                np.testing.assert_array_equal(
                    ro.predict(x, max_wait_s=5.0), row_want(row_backend, x))
            st = ro.stats()["rollout"]
            assert st["stage"] == "stable" and st["rollbacks"] == 1
            assert "errors" in st["rollback_reason"]
            assert st["versions"]["v2-broken"]["errors"] >= 1
        finally:
            ro.close()

    def test_canary_split_is_deterministic(self, row_backend):
        cur = _row_engine(row_backend)
        cand = _row_engine(row_backend)
        ro = RolloutEngine(cur, "v1", canary_pct=25.0,
                           gates=RolloutGates(min_samples=1000))
        try:
            ro.stage(cand, "v2")
            ro.set_stage("canary")
            for x in _rows(100):
                ro.predict(x)
            st = ro.stats()["rollout"]["versions"]
            assert st["v2"]["requests"] == 25
            assert st["v1"]["requests"] == 75
        finally:
            ro.close()

    def test_fleet_rollout_fault_counts_candidate_error(self,
                                                        row_backend):
        cur = _row_engine(row_backend)
        cand = _row_engine(row_backend)
        ro = RolloutEngine(cur, "v1", gates=RolloutGates(max_errors=100))
        try:
            ro.stage(cand, "v2")
            ro.set_stage("shadow")
            x = _rows(1)[0]
            plan = FaultPlan([FaultSpec("fleet.rollout", raises=ServeError,
                                        hits=(1,))])
            with inject(plan):
                np.testing.assert_array_equal(ro.predict(x),
                                              row_want(row_backend, x))
            assert plan.fired_count("fleet.rollout") == 1
            assert ro.stats()["rollout"]["versions"]["v2"]["errors"] == 1
        finally:
            ro.close()
            cand.close()

    def test_gates_from_config_overrides_reach_the_engine(
            self, row_backend):
        from euromillioner_tpu_torch.config import Config, apply_overrides
        from euromillioner_tpu_torch.serve.rollout import gates_from_config

        cfg = apply_overrides(Config(), [
            "serve.fleet.canary_pct=25",
            "serve.fleet.rollout_max_rel_err=0.5",
            "serve.fleet.rollout_max_latency_x=9",
            "serve.fleet.rollout_min_attainment=0.8"])
        gates, canary_pct = gates_from_config(cfg.serve.fleet)
        assert (gates.max_rel_err, gates.max_latency_x,
                gates.min_attainment) == (0.5, 9.0, 0.8)
        assert canary_pct == 25.0
        ro = RolloutEngine.from_config(_row_engine(row_backend),
                                       cfg.serve.fleet)
        try:
            assert ro.gates == gates and ro.canary_pct == 25.0
        finally:
            ro.close()


# ---------------------------------------------------------------------------
# the HTTP fleet: the network path end to end
# ---------------------------------------------------------------------------

class TestHttpFleet:
    def test_http_hosts_probe_route_and_survive_a_death(self,
                                                        row_backend):
        from euromillioner_tpu_torch.serve import HttpServeHost
        from euromillioner_tpu_torch.serve.transport import make_server

        engines = [_row_engine(row_backend, warmup=True),
                   _row_engine(row_backend)]
        servers = []
        for eng in engines:
            srv = make_server(eng, "127.0.0.1", 0)
            threading.Thread(target=srv.serve_forever, daemon=True,
                             kwargs={"poll_interval": 0.05}).start()
            servers.append(srv)
        hosts = [HttpServeHost(f"h{i}",
                               f"http://127.0.0.1:{srv.server_address[1]}",
                               timeout_s=5.0)
                 for i, srv in enumerate(servers)]
        policy = ProbePolicy(interval_s=30.0, timeout_s=5.0, retries=1,
                             jitter_s=0.0, eject_stale_probes=1)
        router = FleetRouter(hosts, policy=policy, start=False)
        try:
            router.monitor.probe_once()
            st = router.stats()
            assert st["hosts"]["h0"]["admitted"]
            assert st["hosts"]["h0"]["attainment"] is not None
            xs = _rows(6)
            for x in xs:
                got = np.asarray(router.predict(x, max_wait_s=10.0),
                                 np.float32)
                np.testing.assert_allclose(got, row_want(row_backend, x),
                                           rtol=1e-6)
            # host 1's server goes away: its probe fails, it is ejected,
            # and traffic keeps flowing through host 0 over real sockets
            servers[1].shutdown()
            servers[1].server_close()
            router.monitor.probe_once()
            assert not router.stats()["hosts"]["h1"]["admitted"]
            for x in xs:
                got = np.asarray(router.predict(x, max_wait_s=10.0),
                                 np.float32)
                np.testing.assert_allclose(got, row_want(row_backend, x),
                                           rtol=1e-6)
            assert router.stats()["failed"] == 0
        finally:
            router.close(drain_s=1.0)
            for h in hosts:
                h.close()
            servers[0].shutdown()
            servers[0].server_close()
            for eng in engines:
                eng.close()


# ---------------------------------------------------------------------------
# fleet-top aggregation and the CLI
# ---------------------------------------------------------------------------

class TestFleetTop:
    def test_parse_prometheus_and_summarize(self, row_backend):
        from euromillioner_tpu_torch.obs.top import (parse_prometheus,
                                                     summarize_metrics)

        with _row_engine(row_backend) as eng:
            eng.predict(_rows(1)[0], max_wait_s=5.0)
            text = eng.telemetry.render()
        metrics = parse_prometheus(text)
        assert metrics["serve_requests_completed_total"][0][1] == 1.0
        lab = metrics["serve_slo_attainment_ratio"][0][0]
        assert lab["class"] in ("interactive", "bulk")
        s = summarize_metrics(metrics)
        assert s["completed"] == 1.0
        assert s["attainment"] == 1.0
        assert s["queued"] == 0

    def test_format_fleet_line_marks_down_hosts(self):
        from euromillioner_tpu_torch.obs.top import format_fleet_line

        line = format_fleet_line(0.0, {
            "h0": {"attainment": 0.995, "queued": 2, "completed": 10.0,
                   "occupancy": 0.5},
            "h1": None})
        assert "h0[att=99.5% q=2 occ=0.50]" in line
        assert "h1[DOWN]" in line

    def test_fleet_line_carries_preempt_figures(self, seq_backend):
        from euromillioner_tpu_torch.obs.top import (format_fleet_line,
                                                     parse_prometheus,
                                                     summarize_metrics)
        from euromillioner_tpu_torch.serve import PreemptPolicy

        pol = PreemptPolicy(enabled=True)
        with _seq_engine(seq_backend, max_slots=2, start=False,
                         preempt=pol) as eng:
            bulk = _seqs(2, seed=3, lo=24, hi=25)
            fb = [eng.submit(s, cls="bulk") for s in bulk]
            with eng._cond:
                eng._admit_locked()
            eng._dispatch_step()          # both bulk sequences hold slots
            fi = eng.submit(_seqs(1, seed=4)[0], cls="interactive")
            eng.start()
            fi.result(timeout=WAIT)
            for f in fb:
                f.result(timeout=WAIT)
            metrics = parse_prometheus(eng.telemetry.render())
        s = summarize_metrics(metrics)
        assert s["preempted"] >= 1
        assert s["evicted_depth"] == 0
        line = format_fleet_line(0.0, {"h0": s, "h1": {
            "attainment": 1.0, "completed": 3.0}})
        assert f"pre={s['preempted']}" in line
        assert "evd=" not in line
        assert "h1[att=100.0%]" in line

    def test_fleet_line_carries_budget_figures(self, seq_backend,
                                               tmp_path):
        from euromillioner_tpu_torch.obs.top import (format_fleet_line,
                                                     parse_prometheus,
                                                     summarize_metrics)
        from euromillioner_tpu_torch.serve import BudgetPolicy, PreemptPolicy

        pol = PreemptPolicy(enabled=True, max_evicted=8)
        with _seq_engine(seq_backend, max_slots=2, preempt=pol) as probe:
            blob = probe._per_slot_state_bytes()
        bud = BudgetPolicy(enabled=True, ledger_bytes=blob + 16,
                           spill_dir=str(tmp_path), spill_bytes=1 << 20)
        with _seq_engine(seq_backend, max_slots=2, start=False,
                         preempt=pol, budget=bud) as eng:
            bulk = _seqs(2, seed=5, lo=48, hi=49)
            fb = [eng.submit(s, cls="bulk") for s in bulk]
            with eng._cond:
                eng._admit_locked()
            eng._dispatch_step()
            fi = [eng.submit(s, cls="interactive")
                  for s in _seqs(6, seed=6)]
            eng.start()
            for f in fi + fb:
                f.result(timeout=WAIT)
            spills = int(eng.telemetry.spills.get())
            metrics = parse_prometheus(eng.telemetry.render())
        assert spills >= 1, "the scenario never spilled"
        s = summarize_metrics(metrics)
        assert s["spilled"] == spills
        assert s["ledger_bytes"] == 0
        s["ledger_bytes"] = 3 * 2**20
        line = format_fleet_line(0.0, {"h0": s, "h1": {
            "attainment": 1.0, "completed": 3.0}})
        assert "led=3.0M" in line and f"spl={spills}" in line
        assert "h1[att=100.0%]" in line

    def test_run_fleet_once_against_dead_hosts_exits_1(self, capsys):
        from euromillioner_tpu_torch.obs.top import run_fleet

        assert run_fleet(["http://127.0.0.1:9"], iterations=1) == 1
        assert "DOWN" in capsys.readouterr().out


def _smoke_summary(main, capsys, *argv):
    rc = main(["fleet", "--smoke", "8", "--local-hosts", "2", *argv])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


class TestFleetCLI:
    @pytest.mark.parametrize("model_type", ["mlp", "lstm"])
    def test_fleet_smoke_routes_over_two_hosts(self, capsys, model_type):
        from euromillioner_tpu_torch.cli import main

        rc, summary = _smoke_summary(main, capsys, "--model-type",
                                     model_type, "--device", "cpu")
        assert rc == 0
        assert summary["requests"] == 8 and summary["failed"] == 0
        assert set(summary["fleet"]["hosts"]) == {"h0", "h1"}

    def test_fleet_without_a_card_or_hosts_fails(self, capsys):
        from euromillioner_tpu_torch.cli import main

        if not torch.cuda.is_available():
            assert main(["fleet", "--smoke", "4"]) == 17  # no --device cpu
        assert main(["fleet"]) == 16  # no --hosts, no --smoke

    def test_obs_top_fleet_usage_and_flag(self):
        from euromillioner_tpu_torch.cli import main

        assert main(["obs-top"]) == 2
        assert main(["obs-top", "--fleet", "http://127.0.0.1:9",
                     "--once"]) == 1


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------

class TestParityWithJax:
    def test_two_host_routers_reply_alike(self, mlp_pair):
        """The same seeded rows through a two-host router of each package
        (one MLP, its JAX params carried across)."""
        jb, tb = mlp_pair
        jax_engines = [JaxInferenceEngine(JaxModelSession(jb),
                                          buckets=(BUCKET,), warmup=False)
                       for _ in range(2)]
        engines = [_row_engine(tb) for _ in range(2)]
        jr = JaxFleetRouter([JaxFleetHost(f"h{i}", e)
                             for i, e in enumerate(jax_engines)],
                            policy=JaxProbePolicy(interval_s=30.0),
                            start=False)
        tr = FleetRouter([FleetHost(f"h{i}", e)
                          for i, e in enumerate(engines)],
                         policy=FAST_POLICY, start=False)
        try:
            xs = _rows(12, seed=7)
            want = [np.asarray(f.result(timeout=WAIT))
                    for f in [jr.submit(x, max_wait_s=5.0) for x in xs]]
            got = [np.asarray(f.result(timeout=WAIT))
                   for f in [tr.submit(x, max_wait_s=5.0) for x in xs]]
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
            js, ts = jr.stats(), tr.stats()
            assert set(ts) == set(js)
            assert set(ts["hosts"]) == set(js["hosts"]) == {"h0", "h1"}
            assert ts["completed"] == js["completed"] == 12
        finally:
            jr.close(drain_s=1.0)
            tr.close(drain_s=1.0)
            for e in jax_engines + engines:
                e.close()

    def test_each_parse_probe_reads_the_others_healthz(self, mlp_pair,
                                                       seq_backend):
        jb, tb = mlp_pair
        jax_eng = JaxInferenceEngine(JaxModelSession(jb), buckets=(BUCKET,),
                                     warmup=False)
        try:
            jax_body = json.loads(json.dumps(jax_healthz_body(jax_eng)))
        finally:
            jax_eng.close()
        with _row_engine(tb) as eng:
            row_body = json.loads(json.dumps(healthz_body(eng)))
        with _seq_engine(seq_backend) as eng:
            eng.predict(_seqs(1)[0])
            seq_body = json.loads(json.dumps(healthz_body(eng)))
        port_view = parse_probe(jax_body)
        assert port_view.ok and port_view.queued == 0
        for body in (row_body, seq_body):
            jv, pv = jax_parse_probe(body), parse_probe(body)
            assert jv.ok and pv.ok
            assert jv.attainment == pv.attainment
            assert jv.queued == pv.queued and jv.occupancy == pv.occupancy
        for body in (jax_body, row_body, seq_body):
            newer = dict(body, healthz_version=HEALTHZ_VERSION + 1)
            with pytest.raises(ServeError, match="newer"):
                parse_probe(newer)
            with pytest.raises(JaxServeError, match="newer"):
                jax_parse_probe(newer)

    def test_fleet_smoke_summaries_have_the_same_keys(self, capsys,
                                                      monkeypatch,
                                                      tmp_path):
        from euromillioner_tpu.cli import main as jax_main
        from euromillioner_tpu_torch.cli import main

        monkeypatch.chdir(tmp_path)  # the JAX CLI's compile cache
        rc_j, jax_summary = _smoke_summary(jax_main, capsys,
                                           "--model-type", "mlp")
        rc_t, summary = _smoke_summary(main, capsys, "--model-type", "mlp",
                                       "--device", "cpu")
        assert rc_j == rc_t == 0
        assert set(summary) == set(jax_summary)
        assert set(summary["fleet"]) == set(jax_summary["fleet"])
        assert set(summary["stats"]) == set(jax_summary["stats"])

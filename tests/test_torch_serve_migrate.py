"""The port's live migration (serve/continuous.py export_sequence /
import_sequence, the EMT1 migration container, ``/admin/export`` and
``/admin/migrate``) against the JAX package's: the golden v1 blob decodes
and its bytes are reproduced, blobs cross between the two packages both
ways mid-flight, and the port's own bit pin holds — a sequence migrated
mid-flight replies bit-equal to one never migrated, in f32 and bf16. Then
the fleet's three triggers (scale-down drain, SLO ejection of a reachable
host, a planned restart), ``fleet.migrate`` chaos and the fleet's
observability riders. Each behaviour mirrors a test of
tests/test_migrate.py."""

import base64
import contextlib
import dataclasses
import json
import pathlib
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.models.lstm import build_lstm as jax_build_lstm
from euromillioner_tpu.serve import RecurrentBackend as JaxBackend
from euromillioner_tpu.serve import StepScheduler as JaxStepScheduler
from euromillioner_tpu.serve.aotstore import \
    params_fingerprint as jax_fingerprint
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.models.mlp import build_mlp
from euromillioner_tpu_torch.resilience import FaultPlan, FaultSpec, inject
from euromillioner_tpu_torch.serve import (FleetHost, FleetRouter,
                                           FleetSupervisor, HttpServeHost,
                                           ProbePolicy, SupervisorPolicy,
                                           parse_probe)
from euromillioner_tpu_torch.serve.aotstore import params_fingerprint
from euromillioner_tpu_torch.serve.continuous import (MIGRATE_VERSION,
                                                      RecurrentBackend,
                                                      StepScheduler,
                                                      WholeSequenceScheduler,
                                                      unpack_migration)
from euromillioner_tpu_torch.serve.engine import InferenceEngine
from euromillioner_tpu_torch.serve.session import NNBackend
from euromillioner_tpu_torch.serve.transport import (handle_request,
                                                     healthz_body,
                                                     make_server)
from euromillioner_tpu_torch.utils import serialization
from euromillioner_tpu_torch.utils.errors import ServeError

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "migrate_blob_v1.emt1"
FEAT = 11
RTOL = 1e-5
ATOL = 1e-6
WAIT = 60


@pytest.fixture(scope="module")
def models():
    jm = jax_build_lstm(hidden=8, num_layers=2, out_dim=7, fused="off")
    params, _ = jm.init(jax.random.PRNGKey(0), (64, FEAT))
    tm = build_lstm(8, 2, 7, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params), "cpu"))
    jb = JaxBackend(jm, params, feat_dim=FEAT, compute_dtype=np.float32)
    return jb, RecurrentBackend(tm, feat_dim=FEAT,
                                compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def backend(models):
    return models[1]


def _engine(backend, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("step_block", 2)
    kw.setdefault("warmup", False)
    return StepScheduler(backend, **kw)


def _seq(steps, seed=0):
    return np.random.default_rng(seed).normal(
        size=(steps, FEAT)).astype(np.float32)


def pool_program(backend, seq, rows):
    x = torch.from_numpy(np.repeat(seq[None], rows, 0))
    _, y = backend.block_fn(backend.init_states(rows), x,
                            torch.ones((rows, 1), dtype=torch.bool))
    return y[0, -1].numpy()


def export_mid_flight(eng, x, dispatches=3, **kw):
    """Submit ``x`` to a not-yet-started scheduler (either package's),
    step it ``dispatches`` blocks on this thread, file its export, then
    release the dispatcher: the export is packed at its first boundary,
    so the blob is mid-flight by construction."""
    fut = eng.submit(x, cls="bulk", **kw)
    with eng._cond:
        eng._admit_locked()
    for _ in range(dispatches):
        eng._dispatch_step()
    with ThreadPoolExecutor(1) as ex:
        blob = ex.submit(eng.export_sequence, fut, reason="drain")
        deadline = time.monotonic() + WAIT
        while not eng._export_q and time.monotonic() < deadline:
            time.sleep(0.001)
        eng.start()
        return fut, blob.result(timeout=WAIT)


def _leak_free(eng):
    ld = eng.load_desc
    return (ld["active"] == 0 and ld["queued"] == 0
            and ld["evicted_depth"] == 0)


def test_golden_blob_decodes_with_every_pinned_header_field():
    header, x, state = unpack_migration(GOLDEN.read_bytes())
    assert header == {
        "migrate_version": 1, "model": "0123456789abcdef",
        "family": "lstm", "profile": "f32",
        "pool_dtype": "float32", "layers": [[8]], "feat_dim": 4,
        "steps": 6, "pos": 4, "cls": "bulk", "priority": 1,
        "deadline_s": 2.5, "arrival": 7}
    assert x.dtype == np.float32 and x.shape == (6, 4)
    np.testing.assert_array_equal(
        x, (np.arange(24, dtype=np.float32) / 8.0).reshape(6, 4))
    (h, c), = state
    assert h.dtype == c.dtype == torch.float32
    np.testing.assert_array_equal(
        h.numpy(), (np.arange(8, dtype=np.float32) - 3.0) / 4.0)
    np.testing.assert_array_equal(
        c.numpy(), (np.arange(8, dtype=np.float32) + 1.0) / 16.0)


def test_golden_blob_bytes_reproduced_by_the_port():
    """The port's ``dumps`` of make_migrate_blob.py's entries is the
    checked-in blob, byte for byte."""
    sys.path.insert(0, str(GOLDEN.parent))
    try:
        import make_migrate_blob
    finally:
        sys.path.pop(0)
    entries = {"migrate": serialization.json_entry(make_migrate_blob.HEADER),
               "x": (np.arange(24, dtype=np.float32) / 8.0).reshape(6, 4),
               "0.h": (np.arange(8, dtype=np.float32) - 3.0) / 4.0,
               "0.c": (np.arange(8, dtype=np.float32) + 1.0) / 16.0}
    assert serialization.dumps(entries) == GOLDEN.read_bytes()


def test_newer_version_rejected_with_valid_range():
    blob = serialization.dumps({"migrate": serialization.json_entry(
        {"migrate_version": MIGRATE_VERSION + 1})})
    with pytest.raises(ServeError, match=r"migrate_version.*\[1, 1\]"):
        unpack_migration(blob)


def test_non_container_rejected():
    with pytest.raises(ServeError, match="migration blob rejected"):
        unpack_migration(b"not an EMT1 container at all")
    plain = serialization.dumps({"x": np.zeros(3, np.float32)})
    with pytest.raises(ServeError, match="no 'migrate' header"):
        unpack_migration(plain)


def test_missing_header_field_named():
    header, x, _state = unpack_migration(GOLDEN.read_bytes())
    header.pop("arrival")
    blob = serialization.dumps({"migrate": serialization.json_entry(header),
                                "x": x})
    with pytest.raises(ServeError, match="'arrival' missing"):
        unpack_migration(blob)


@pytest.mark.parametrize("hidden,dtype", [(8, jnp.float32),
                                          (512, jnp.float32),
                                          (512, jnp.bfloat16)])
def test_fingerprint_equals_the_jax_packages(hidden, dtype):
    """The flagship's width included: the port's fingerprint of its state
    dict is the JAX package's of the same params tree."""
    jm = jax_build_lstm(hidden=hidden, num_layers=2, out_dim=7,
                        fused="off")
    params, _ = jm.init(jax.random.PRNGKey(0), (64, FEAT))
    params = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
    state = params_from_jax(jax.device_get(params), "cpu")
    assert params_fingerprint(state) == jax_fingerprint(params)


@pytest.mark.parametrize("profile", ["f32", "bf16"])
def test_mid_flight_migration_bit_identical(backend, profile):
    be = backend if profile == "f32" else backend.with_profile(profile)
    x = _seq(128, seed=1)
    with _engine(be) as eng:
        unmigrated = eng.predict(x, cls="bulk")
    src, dst = _engine(be, start=False), _engine(be)
    try:
        fut, blob = export_mid_flight(src, x)
        assert blob is not None
        header, _x, state = unpack_migration(blob)
        assert header["pos"] == 6 and state is not None
        assert header["pool_dtype"] == ("float32" if profile == "f32"
                                        else "bfloat16")
        assert {t.dtype for pair in state for t in pair} == {
            torch.float32 if profile == "f32" else torch.bfloat16}
        with pytest.raises(ServeError, match="migrated off"):
            fut.result(timeout=5)
        out = dst.import_sequence(blob).result(timeout=WAIT)
        assert np.array_equal(out, unmigrated)
        if profile == "f32":
            assert np.array_equal(out, pool_program(be, x, 4))
        assert _leak_free(src) and _leak_free(dst)
        assert src.load_desc["migrations"] == 1
        assert dst.load_desc["migrations"] == 1
    finally:
        src.close()
        dst.close()


def test_queued_sequence_migrates_from_pos_zero(backend):
    src, dst = _engine(backend), _engine(backend)
    try:
        hold = [src.submit(_seq(64, seed=s), cls="bulk") for s in range(4)]
        x = _seq(24, seed=9)
        fut = src.submit(x, cls="bulk")
        blob = src.export_sequence(fut, reason="drain")
        assert blob is not None
        header, _x, state = unpack_migration(blob)
        out = dst.import_sequence(blob).result(timeout=WAIT)
        assert np.array_equal(out, pool_program(backend, x, 4))
        for f in hold:
            f.result(timeout=WAIT)
        assert _leak_free(src) and _leak_free(dst)
    finally:
        src.close()
        dst.close()


def test_import_admits_under_original_ordering(backend):
    src = _engine(backend)
    dst = _engine(backend, max_slots=2, start=False)
    try:
        x = _seq(32, seed=3)
        fut = src.submit(x, cls="bulk", max_wait_s=9.0)
        blob = src.export_sequence(fut, reason="drain")
        header, _x, _state = unpack_migration(blob)
        hold = [dst.submit(_seq(96, seed=s), cls="bulk") for s in range(2)]
        mfut = dst.import_sequence(blob)
        with dst._cond:
            entry = next(t for t in dst._q if t[-1].future is mfut)
        prio, deadline, arrival, _seq_key, req = entry
        assert arrival == header["arrival"] and prio == header["priority"]
        assert req.cls == header["cls"]
        assert deadline < time.monotonic() + 9.5
        dst.start()
        assert np.array_equal(mfut.result(timeout=WAIT),
                              pool_program(backend, x, 2))
        for f in hold:
            f.result(timeout=WAIT)
    finally:
        src.close()
        dst.close()


def test_a_jax_blob_finishes_in_the_port(models):
    """Exported mid-flight by the JAX scheduler, imported by the port's:
    the reply is within tolerance of the JAX import's."""
    jb, backend = models
    x = _seq(96, seed=4)
    jsrc = JaxStepScheduler(jb, max_slots=4, step_block=2, warmup=False,
                            start=False)
    try:
        _fut, blob = export_mid_flight(jsrc, x)
    finally:
        jsrc.close()
    assert unpack_migration(blob)[0]["pos"] == 6
    with JaxStepScheduler(jb, max_slots=4, step_block=2,
                          warmup=False) as jdst:
        want = np.asarray(jdst.import_sequence(blob).result(timeout=WAIT))
    with _engine(backend) as dst:
        got = dst.import_sequence(blob).result(timeout=WAIT)
        assert _leak_free(dst)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_a_port_blob_finishes_in_the_jax_scheduler(models):
    jb, backend = models
    x = _seq(96, seed=5)
    src = _engine(backend, start=False)
    try:
        _fut, blob = export_mid_flight(src, x)
    finally:
        src.close()
    with _engine(backend) as dst:
        mine = dst.import_sequence(blob).result(timeout=WAIT)
    with JaxStepScheduler(jb, max_slots=4, step_block=2,
                          warmup=False) as jdst:
        got = np.asarray(jdst.import_sequence(blob).result(timeout=WAIT))
    np.testing.assert_allclose(mine, got, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mine, jb.predict(x), rtol=RTOL, atol=ATOL)


def test_profile_mismatch_names_the_field(backend):
    src, dst = _engine(backend.with_profile("bf16"), start=False), \
        _engine(backend)
    try:
        _fut, blob = export_mid_flight(src, _seq(64, seed=2))
        with pytest.raises(ServeError, match=r"'profile'"):
            dst.import_sequence(blob)
        assert _leak_free(dst)
    finally:
        src.close()
        dst.close()


def test_model_fingerprint_mismatch_names_the_field(backend):
    other = RecurrentBackend(build_lstm(16, 2, 7, device="cpu"),
                             feat_dim=FEAT, compute_dtype=torch.float32)
    src, dst = _engine(other, start=False), _engine(backend)
    try:
        _fut, blob = export_mid_flight(src, _seq(48, seed=4))
        with pytest.raises(ServeError, match=r"'model'"):
            dst.import_sequence(blob)
    finally:
        src.close()
        dst.close()


def _golden_for(dst):
    """The golden blob's header rewritten to fit ``dst``'s pool."""
    header, _x, _state = unpack_migration(GOLDEN.read_bytes())
    header.update(model=dst._model_fingerprint, layers=[[8], [8]],
                  feat_dim=FEAT, steps=6, pos=4)
    return header, _seq(6, seed=0)


def test_restore_payload_dtype_and_shape_drift_shed_loudly(backend):
    dst = _engine(backend)
    try:
        header, x = _golden_for(dst)
        for rows, match in ((np.zeros(8, np.float64), "dtype"),
                            (np.zeros(16, np.float32), "shape")):
            entries = {"migrate": serialization.json_entry(header), "x": x}
            for i in range(2):
                entries[f"{i}.h"] = entries[f"{i}.c"] = rows
            with pytest.raises(ServeError, match=match):
                dst.import_sequence(serialization.dumps(entries))
        assert _leak_free(dst)
    finally:
        dst.close()


def test_check_restore_payload_unit(backend):
    eng = _engine(backend)
    try:
        good = [(np.zeros(8, np.float32), np.zeros(8, np.float32))] * 2
        eng._check_restore_payload(good)
        with pytest.raises(ServeError, match="layers"):
            eng._check_restore_payload(good * 2)
        with pytest.raises(ServeError, match="dtype"):
            eng._check_restore_payload(
                [(np.zeros(8, np.float64), np.zeros(8, np.float64))] * 2)
        with pytest.raises(ServeError, match="shape"):
            eng._check_restore_payload(
                [(np.zeros(4, np.float32), np.zeros(4, np.float32))] * 2)
    finally:
        eng.close()


@contextlib.contextmanager
def serving(engine):
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              kwargs={"poll_interval": 0.05})
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=WAIT)
        engine.close()


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_admin_migrate_http_round_trip(backend):
    x = _seq(48, seed=13)
    src = _engine(backend, start=False)
    try:
        _fut, blob = export_mid_flight(src, x)
    finally:
        src.close()
    with serving(_engine(backend)) as url, _engine(backend) as ref:
        want = ref.import_sequence(blob).result(timeout=WAIT)
        status, body = post(url + "/admin/migrate",
                            {"blob": base64.b64encode(blob).decode()})
        assert status == 200 and body["migrated"] is True
        assert np.array_equal(np.asarray(body["predictions"], np.float32),
                              want)
        assert post(url + "/admin/migrate",
                    {"blob": "@@not-base64@@"})[0] == 400
        assert post(url + "/admin/migrate", {"nope": 1})[0] == 400
        header, hx, state = unpack_migration(blob)
        header["model"] = "f" * 16
        entries = {"migrate": serialization.json_entry(header), "x": hx}
        for i, (h, c) in enumerate(state):
            entries[f"{i}.h"], entries[f"{i}.c"] = h, c
        status, body = post(url + "/admin/migrate", {
            "blob": base64.b64encode(serialization.dumps(entries)).decode()})
        assert status == 400 and "'model'" in body["error"]


def test_admin_export_http_round_trip(backend):
    """``/admin/export`` by tag, then ``{"all": true}``; bad bodies are
    400s, an unknown tag a null blob."""
    src = _engine(backend, start=False)
    with serving(src) as url, _engine(backend) as dst:
        for bad in ({"nope": 1}, {"target": 7}, {"all": False},
                    {"target": ""}):
            status, body = post(url + "/admin/export", bad)
            assert status == 400 and "body must be" in body["error"]
        x = _seq(96, seed=14)
        fut = src.submit(x, cls="bulk", tag="job-1")
        with src._cond:
            src._admit_locked()
        for _ in range(3):
            src._dispatch_step()
        with ThreadPoolExecutor(1) as ex:
            reply = ex.submit(post, url + "/admin/export",
                              {"target": "job-1"})
            deadline = time.monotonic() + WAIT
            while not src._export_q and time.monotonic() < deadline:
                time.sleep(0.001)
            src.start()
            status, body = reply.result(timeout=WAIT)
        assert status == 200 and body["blob"] is not None
        blob = base64.b64decode(body["blob"])
        assert unpack_migration(blob)[0]["pos"] == 6
        with pytest.raises(ServeError, match="migrated off"):
            fut.result(timeout=5)
        out = dst.import_sequence(blob).result(timeout=WAIT)
        assert np.array_equal(out, pool_program(backend, x, 4))
        assert post(url + "/admin/export",
                    {"target": "never-submitted"}) == (200, {"blob": None})
        # long enough that neither finishes before the drain reaches it
        futs = [src.submit(_seq(4000, seed=s), cls="bulk")
                for s in (15, 16)]
        status, body = post(url + "/admin/export", {"all": True})
        assert status == 200
        for f in futs:
            with pytest.raises(ServeError, match="migrated off"):
                f.result(timeout=WAIT)
        assert len(body["blobs"]) == 2
        assert _leak_free(src)


def test_admin_routes_404_without_the_surface(backend):
    """The batch scheduler and the row engine have no migration surface."""
    mlp = NNBackend(build_mlp((8,), 1, in_features=FEAT, device="cpu"),
                    (FEAT,), compute_dtype=torch.float32)
    for engine in (WholeSequenceScheduler(backend),
                   InferenceEngine(mlp, buckets=(8,), warmup=False)):
        with serving(engine) as url:
            for path in ("/admin/export", "/admin/migrate"):
                status, body = post(url + path, {"all": True})
                assert status == 404
                assert body == {"error": "this engine has no "
                                         "live-migration surface"}


def test_predict_tag_discipline(backend):
    rows = _seq(4, seed=0).tolist()
    mlp = NNBackend(build_mlp((8,), 1, in_features=FEAT, device="cpu"),
                    (FEAT,), compute_dtype=torch.float32)
    with _engine(backend) as eng, InferenceEngine(
            mlp, buckets=(8,), warmup=False) as rows_eng:
        for tag in (7, ""):
            status, body = handle_request(eng, {"rows": rows, "tag": tag})
            assert status == 400
            assert "tag must be a non-empty string" in body["error"]
        assert handle_request(eng, {"rows": rows, "tag": "ok-1"})[0] == 200
        status, body = handle_request(rows_eng,
                                      {"rows": rows[:1], "tag": "x"})
        assert status == 400 and "sequence engines" in body["error"]


def test_healthz_carries_migrations_after_a_move(backend):
    src, dst = _engine(backend, start=False), _engine(backend)
    try:
        _fut, blob = export_mid_flight(src, _seq(64, seed=12))
        dst.import_sequence(blob).result(timeout=WAIT)
        for eng in (src, dst):
            assert healthz_body(eng)["migrations"] == 1
    finally:
        src.close()
        dst.close()


# -- the fleet's three triggers, its chaos and its observability ---------------

FAST_POLICY = ProbePolicy(interval_s=30.0, timeout_s=2.0, retries=1,
                          jitter_s=0.0, eject_stale_probes=2,
                          eject_breach_probes=2, probation_probes=2)
FAST_SUP = SupervisorPolicy(interval_s=30.0, autoscale=True, min_hosts=1,
                            dead_after_probes=2, spawn_retries=2,
                            spawn_backoff_s=0.001)
# long enough that a sequence is still in its slot when the move lands
LONG = 1024


def _wait_steps(eng, n, timeout_s=WAIT):
    """Poll until ``eng`` has run ``n`` block substeps: a sequence
    submitted before is mid-flight (the blobs' headers show pos > 0)."""
    deadline = time.monotonic() + timeout_s
    while eng.telemetry.steps.get() < n:
        if time.monotonic() > deadline:
            raise AssertionError(f"the engine never reached {n} steps")
        time.sleep(0.002)


def _pin_to(router, name, xs, cls="bulk"):
    """Submit ``xs`` while every other host is unadmitted: placement on
    ``name`` by construction."""
    others = [n for n in router._states if n != name]
    for n in others:
        router._states[n].admitted = False
    futs = [router.submit(x, cls=cls) for x in xs]
    for n in others:
        router._states[n].admitted = True
    return futs


@contextlib.contextmanager
def two_host_fleet(backend, **router_kw):
    e0, e1 = _engine(backend), _engine(backend)
    router = FleetRouter([FleetHost("h0", e0), FleetHost("h1", e1)],
                         policy=FAST_POLICY, start=False, **router_kw)
    try:
        yield router, e0, e1
    finally:
        router.close(drain_s=5)
        e0.close()
        e1.close()


class TestRouterMigration:
    def test_scale_down_drain_is_o_blob_ship(self, backend):
        """Scale-down of the host holding long sequences: the drain has
        run out right after the migration (nothing waits out a sequence)
        and every migrated reply is bit-identical, none failed."""
        with two_host_fleet(backend) as (router, e0, e1):
            sup = FleetSupervisor(router, lambda name: _engine(backend),
                                  FAST_SUP, start=False)
            sup._spawned_names.add("h0")  # the preferred victim
            try:
                xs = [_seq(LONG, seed=s) for s in range(2)]
                futs = _pin_to(router, "h0", xs)
                _wait_steps(e0, 4)
                sup._scale_down({"pending": 0, "occupancy": 0.1,
                                 "attainment": 1.0})
                assert router.retire_ready("h0")
                sup._sweep_drains()
                assert "h0" not in router._states
                for x, f in zip(xs, futs):
                    assert np.array_equal(f.result(timeout=WAIT),
                                          pool_program(backend, x, 4))
                assert int(router.telemetry.migrations("drain").get()) == 2
                assert int(router.telemetry.failed.get()) == 0
                assert _leak_free(e1)
            finally:
                sup.close()

    def test_scale_down_without_migrate_waits_out(self, backend):
        with two_host_fleet(backend) as (router, e0, e1):
            pol = dataclasses.replace(FAST_SUP, drain_migrate=False)
            sup = FleetSupervisor(router, lambda name: _engine(backend),
                                  pol, start=False)
            sup._spawned_names.add("h0")
            try:
                futs = _pin_to(router, "h0", [_seq(LONG, seed=7)])
                _wait_steps(e0, 2)
                sup._scale_down({"pending": 0, "occupancy": 0.1,
                                 "attainment": 1.0})
                # behind the knob: the drain waits for the sequence
                assert not router.retire_ready("h0")
                assert router.telemetry.migrations_total() == 0
                futs[0].result(timeout=WAIT)
            finally:
                sup.close()

    def test_slo_ejection_of_reachable_host_migrates(self, backend):
        """A reachable host ejected for its attainment moves its live
        sequences (nothing restarts from step 0) and they finish
        bit-identical."""
        with two_host_fleet(backend) as (router, e0, e1):
            x = _seq(LONG, seed=5)
            fut = _pin_to(router, "h0", [x])[0]
            _wait_steps(e0, 2)
            router.monitor._eject(router._states["h0"],
                                  "slo: interactive attainment 0.10 < 0.50")
            assert np.array_equal(fut.result(timeout=WAIT),
                                  pool_program(backend, x, 4))
            assert int(router.telemetry.migrations("eject").get()) == 1
            assert int(router.telemetry.rerouted.get()) == 0
            assert router._health()["migrations"] == 1

    def test_stale_ejection_still_drains_from_zero(self, backend):
        with two_host_fleet(backend) as (router, e0, e1):
            x = _seq(256, seed=6)
            fut = _pin_to(router, "h0", [x])[0]
            _wait_steps(e0, 2)
            router._states["h0"].host.kill()
            router.monitor._eject(router._states["h0"],
                                  "stale: 2 failed probes")
            assert np.array_equal(fut.result(timeout=WAIT),
                                  pool_program(backend, x, 4))
            assert router.telemetry.migrations_total() == 0
            assert int(router.telemetry.rerouted.get()) >= 1

    def test_migrate_on_eject_false_reverts_to_drain(self, backend):
        with two_host_fleet(backend, migrate_on_eject=False) as (
                router, e0, e1):
            fut = _pin_to(router, "h0", [_seq(256, seed=8)])[0]
            _wait_steps(e0, 2)
            router.monitor._eject(router._states["h0"],
                                  "slo: interactive attainment 0.10 < 0.50")
            fut.result(timeout=WAIT)
            assert router.telemetry.migrations_total() == 0
            assert int(router.telemetry.rerouted.get()) >= 1


class TestRespawnHandoff:
    def test_respawn_restores_drain_exported_sequences(self, backend):
        """A draining host exports its live pool; respawn restores every
        blob into the fresh engine and the restored futures finish
        bit-identical."""
        e0 = _engine(backend)
        host = FleetHost("h0", e0)
        e1 = None
        try:
            xs = [_seq(LONG, seed=s) for s in range(3)]
            futs = [host.submit(x, cls="bulk") for x in xs]
            _wait_steps(e0, 4)
            blobs = host.drain_export(reason="respawn")
            assert len(blobs) == 3
            assert any(unpack_migration(b)[0]["pos"] > 0 for b in blobs)
            for f in futs:
                with pytest.raises(ServeError, match="migrated off"):
                    f.result(timeout=5)
            assert _leak_free(e0)
            e1 = _engine(backend)
            nfuts = host.respawn(e1, sequences=blobs)
            assert len(nfuts) == 3
            outs = {np.asarray(f.result(timeout=WAIT)).tobytes()
                    for f in nfuts}
            assert outs == {pool_program(backend, x, 4).tobytes()
                            for x in xs}
            assert _leak_free(e1)
        finally:
            e0.close()
            if e1 is not None:
                e1.close()

    def test_supervisor_restart_host_carries_slot_holders(self, backend):
        with two_host_fleet(backend) as (router, e0, e1):
            sup = FleetSupervisor(router, lambda name: _engine(backend),
                                  FAST_SUP, start=False)
            try:
                xs = [_seq(LONG, seed=s) for s in range(2)]
                futs = _pin_to(router, "h0", xs)
                _wait_steps(e0, 4)
                assert sup.restart_host("h0") == 2  # both to the peer
                for x, f in zip(xs, futs):
                    assert np.array_equal(f.result(timeout=WAIT),
                                          pool_program(backend, x, 4))
                assert int(router.telemetry.migrations("respawn")
                           .get()) == 2
                assert int(router.telemetry.failed.get()) == 0
            finally:
                sup.close()

    def test_single_host_restart_no_duplicated_compute(self, backend):
        """One host, no peer: restart_host exports the router's entries,
        restores them into the fresh engine and re-hooks the client
        futures — the fresh engine admits each sequence once and nothing
        re-routes from step 0."""
        e0 = _engine(backend)
        router = FleetRouter([FleetHost("h0", e0)], policy=FAST_POLICY,
                             start=False)
        sup = FleetSupervisor(router, lambda name: _engine(backend),
                              FAST_SUP, start=False)
        try:
            xs = [_seq(LONG, seed=s) for s in range(2)]
            futs = [router.submit(x, cls="bulk") for x in xs]
            _wait_steps(e0, 4)
            assert sup.restart_host("h0") == 2  # both re-hooked
            for x, f in zip(xs, futs):
                assert np.array_equal(f.result(timeout=WAIT),
                                      pool_program(backend, x, 4))
            fresh = router._states["h0"].host.engine
            assert fresh is not e0
            assert int(fresh.telemetry.requests.get()) == 2
            assert int(router.telemetry.rerouted.get()) == 0
            assert int(router.telemetry.migrations("respawn").get()) == 2
            assert int(router.telemetry.failed.get()) == 0
            assert _leak_free(fresh)
        finally:
            sup.close()
            router.close(drain_s=5)
            e0.close()


class TestMigrateChaos:
    def test_fault_loses_only_the_inflight_migration(self, backend):
        """A fired ``fleet.migrate`` loses the migration, not the
        sequence: the source re-imports its own blob and the sequence
        finishes where it was, bit-identical, both pools leak-free."""
        with two_host_fleet(backend) as (router, e0, e1):
            x = _seq(LONG, seed=11)
            fut = _pin_to(router, "h0", [x])[0]
            _wait_steps(e0, 2)
            plan = FaultPlan([FaultSpec(
                "fleet.migrate",
                raises=ServeError("chaos: migration link down"))])
            with inject(plan):
                moved = router.migrate_host("h0", reason="drain")
            assert plan.fired_count("fleet.migrate") == 1
            assert moved == 0
            assert np.array_equal(fut.result(timeout=WAIT),
                                  pool_program(backend, x, 4))
            assert router.telemetry.migrations_total() == 0
            assert int(router.telemetry.failed.get()) == 0
            assert _leak_free(e0) and _leak_free(e1)


class TestFleetObservability:
    def test_probe_view_migrations_tolerant_and_old_bodies_pinned(self):
        old_body = {"ok": True, "healthz_version": 1,
                    "attainment": {"interactive": 1.0},
                    "drift_breaches": 0, "queued": 0}
        assert parse_probe(old_body).migrations is None
        assert parse_probe(dict(old_body, migrations=5)).migrations == 5

    def test_fleet_line_renders_mig_nonzero_only(self):
        from euromillioner_tpu_torch.obs.top import format_fleet_line

        line = format_fleet_line(0.0, {
            "h0": {"attainment": 1.0, "migrations": 3},
            "h1": {"attainment": 1.0, "migrations": 0}})
        assert "mig=3" in line and line.count("mig=") == 1

    def test_http_host_tags_every_submit_and_exports_by_future(self,
                                                               backend):
        """HttpServeHost tags each sequence it submits and maps the future
        back to the tag, so the router's ``export_sequence(hfut)`` reaches
        a host across HTTP."""
        src, dst = _engine(backend), _engine(backend)
        host = None
        try:
            with serving(src) as url:
                host = HttpServeHost("h0", url, kind="sequence",
                                     timeout_s=30.0)
                x = _seq(LONG, seed=17)
                fut = host.submit(x, cls="bulk")
                _wait_steps(src, 2)
                blob = host.export_sequence(fut, reason="drain",
                                            timeout_s=10.0)
                assert blob is not None
                assert unpack_migration(blob)[0]["pos"] > 0
                assert np.array_equal(
                    dst.import_sequence(blob).result(timeout=WAIT),
                    pool_program(backend, x, 4))
                with pytest.raises((ServeError, urllib.error.HTTPError)):
                    fut.result(timeout=WAIT)
                # a future submitted elsewhere has no tag: None, no call
                assert host.export_sequence(Future(), reason="drain",
                                            timeout_s=5.0) is None
                base = src.telemetry.steps.get()
                f2 = host.submit(_seq(8192, seed=18), cls="bulk")
                _wait_steps(src, base + 1)
                assert len(host.drain_export(reason="drain")) == 1
                with pytest.raises((ServeError, urllib.error.HTTPError)):
                    f2.result(timeout=WAIT)
                assert _leak_free(src)
        finally:
            if host is not None:
                host.close()
            dst.close()

    def test_summarize_metrics_picks_up_migration_counters(self):
        from euromillioner_tpu_torch.obs.top import summarize_metrics

        fleet = {"fleet_migrations_total": [({"reason": "drain"}, 2.0),
                                            ({"reason": "eject"}, 1.0)],
                 "serve_requests_completed_total": []}
        assert summarize_metrics(fleet)["migrations"] == 3
        host = {"serve_migrations_total": [({"dir": "in"}, 1.0),
                                           ({"dir": "out"}, 1.0)],
                "serve_requests_completed_total": []}
        assert summarize_metrics(host)["migrations"] == 2

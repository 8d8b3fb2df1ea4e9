"""The port's live migration (serve/continuous.py export_sequence /
import_sequence, the EMT1 migration container, ``/admin/export`` and
``/admin/migrate``) against the JAX package's: the golden v1 blob decodes
and its bytes are reproduced, blobs cross between the two packages both
ways mid-flight, and the port's own bit pin holds — a sequence migrated
mid-flight replies bit-equal to one never migrated, in f32 and bf16.
Each behaviour mirrors a test of tests/test_migrate.py (its fleet,
supervisor and chaos tests wait for the port's fleet and fault points)."""

import base64
import contextlib
import json
import pathlib
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

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

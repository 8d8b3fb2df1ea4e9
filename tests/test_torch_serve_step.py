"""The port's step scheduler (serve/continuous.py StepScheduler) against the
JAX package's RecurrentBackend.predict and StepScheduler on the same
weights, and its own bit pins: a reply equals the pool program
(``block_fn``) run straight through at the same pool shape, whatever the
step blocks and readbacks that carried it. Each behaviour mirrors a test
of tests/test_serve_seq.py."""

import threading

import jax
import numpy as np
import pytest
import torch

from euromillioner_tpu.models.lstm import build_lstm as jax_build_lstm
from euromillioner_tpu.serve import RecurrentBackend as JaxBackend
from euromillioner_tpu.serve import StepScheduler as JaxStepScheduler
from euromillioner_tpu_torch.config import Config, apply_overrides
from euromillioner_tpu_torch.core.precision import SERVE_ENVELOPES, rel_error
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.serve.continuous import (RecurrentBackend,
                                                      StepScheduler,
                                                      make_sequence_engine)
from euromillioner_tpu_torch.serve.transport import handle_request
from euromillioner_tpu_torch.utils.errors import ConfigError, ServeError

torch.set_num_threads(2)

FEAT = 11
# tests/test_serve_seq.py's lengths: across block boundaries, T=1 included
MIXED_LENS = [5, 9, 16, 3, 12, 7, 32, 1, 2, 31]
# port vs JAX, f32 on both sides: the JAX package's NN trajectory pin
# (tests/test_train.py). Measured max abs diff 4.5e-8 (outputs ~0.1).
RTOL = 1e-5
ATOL = 1e-6
WAIT = 60  # seconds any future or join may take


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
def seqs():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(n, FEAT)).astype(np.float32)
            for n in MIXED_LENS]


@pytest.fixture(scope="module")
def jax_replies(models, seqs):
    """The JAX oracle's predictions and its StepScheduler's replies."""
    jb, _ = models
    with JaxStepScheduler(jb, max_slots=4, warmup=False) as eng:
        sched = [f.result(timeout=WAIT) for f in map(eng.submit, seqs)]
    return [jb.predict(s) for s in seqs], sched


def pool_program(backend, seq, slots):
    """``seq``'s reply from the pool program run straight through at a
    pool of ``slots`` rows, the sequence in every row (which also shows a
    row's reply does not depend on its slot)."""
    x = torch.from_numpy(np.repeat(seq[None], slots, 0))
    _, y = backend.block_fn(backend.init_states(slots), x,
                            torch.ones((slots, 1), dtype=torch.bool))
    y = y[:, -1].numpy()
    assert (y == y[0]).all()
    return y[0]


def served(eng, seqs, **kw):
    return [f.result(timeout=WAIT) for f in
            [eng.submit(s, **kw) for s in seqs]]


def test_replies_match_jax_predict_and_jax_step_scheduler(models, seqs,
                                                          jax_replies):
    _, backend = models
    with StepScheduler(backend, max_slots=4, warmup=True) as eng:
        got = served(eng, seqs)
        st = eng.stats()
    for g, want, jax_sched, n in zip(got, *jax_replies, MIXED_LENS):
        assert g.shape == (7,) and g.dtype == np.float32
        np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"T={n}")
        np.testing.assert_allclose(g, jax_sched, rtol=RTOL, atol=ATOL,
                                   err_msg=f"T={n}")
    assert st["sequences"] == len(seqs) and st["failed"] == 0
    assert st["active"] == 0 and st["queued"] == 0
    assert 0 < st["mean_occupancy"] <= 1.0


@pytest.mark.parametrize("slots", [2, 4])
def test_replies_bit_equal_to_the_pool_program(models, seqs, slots):
    """Co-scheduled neighbours, slot reuse and zero-filled tail substeps
    never move a bit of a reply."""
    _, backend = models
    with StepScheduler(backend, max_slots=slots, warmup=False) as eng:
        got = served(eng, seqs)
    for g, s in zip(got, seqs):
        assert np.array_equal(g, pool_program(backend, s, slots)), len(s)


def test_staggered_admission_bit_identical(models, seqs):
    """Sequences submitted while others are mid-flight join freed slots at
    block boundaries."""
    _, backend = models
    with StepScheduler(backend, max_slots=2, warmup=False) as eng:
        first = [eng.submit(s) for s in seqs[:3]]
        first[0].result(timeout=WAIT)  # the pool is mid-flight now
        rest = [eng.submit(s) for s in seqs[3:]]
        got = [f.result(timeout=WAIT) for f in first + rest]
    for g, s in zip(got, seqs):
        assert np.array_equal(g, pool_program(backend, s, 2))


def test_block_switch_mid_stream_bit_identical(models):
    """A saturated burst drives the ladder from 2 to 8 while the first
    sequences are mid-flight; each reply is bit-equal to the same sequence
    served at a fixed rung and to the pool program."""
    _, backend = models
    rng = np.random.default_rng(3)
    seqs = [rng.normal(size=(40, FEAT)).astype(np.float32)
            for _ in range(20)]
    with StepScheduler(backend, max_slots=4, step_blocks=(2, 8),
                       hysteresis=3, warmup=False, start=False) as eng:
        futures = [eng.submit(s) for s in seqs]
        eng.start()  # 20 queued vs 4 slots: load >= 1 from dispatch 1
        got = [f.result(timeout=WAIT) for f in futures]
        st = eng.stats()
    with StepScheduler(backend, max_slots=4, step_block=2,
                       warmup=False) as eng:
        fixed = served(eng, seqs)
    assert st["block_hist"].get("2", 0) >= 1
    assert st["block_hist"].get("8", 0) >= 1
    assert st["step_blocks"] == [2, 8] and st["failed"] == 0
    for g, f, s in zip(got, fixed, seqs):
        assert np.array_equal(g, f)
        assert np.array_equal(g, pool_program(backend, s, 4))


def test_coalesced_readback_fewer_reads_identical_replies(models):
    """With a long flush interval, 12 finishers over 6 finishing steps
    drain in a few reads (a pool's worth staged, or idle), with the
    replies of a read per finishing step."""
    _, backend = models
    rng = np.random.default_rng(6)
    seqs = [rng.normal(size=(2 + 2 * (i % 6), FEAT)).astype(np.float32)
            for i in range(12)]
    replies, reads = [], []
    for interval in (60_000.0, 0.0):
        with StepScheduler(backend, max_slots=8, warmup=False, start=False,
                           readback_interval_ms=interval) as eng:
            futures = [eng.submit(s) for s in seqs]
            eng.start()
            replies.append([f.result(timeout=WAIT) for f in futures])
            reads.append(eng.stats()["readbacks"])
    assert 1 <= reads[0] <= 3 and reads[1] >= 6, reads
    assert all(np.array_equal(a, b) for a, b in zip(*replies))


def test_light_load_stays_on_smallest_rung(models, seqs):
    _, backend = models
    with StepScheduler(backend, max_slots=8, step_blocks=(2, 8, 32),
                       warmup=False) as eng:
        for s in seqs[:3]:
            eng.submit(s).result(timeout=WAIT)
        st = eng.stats()
    assert list(st["block_hist"]) == ["2"]


@pytest.mark.parametrize("kw,match", [
    ({"step_block": 1}, "step_block"),
    ({"step_blocks": (1, 8)}, "step_block"),
    ({"inflight": 0}, "inflight"),
    ({"hysteresis": 0}, "hysteresis"),
    ({"readback_interval_ms": -1.0}, "readback_interval_ms"),
    ({"max_slots": 1}, "max_slots"),
    ({"classes": ()}, "serve.classes"),
])
def test_constructor_validation(models, kw, match):
    _, backend = models
    with pytest.raises(ServeError, match=match):
        StepScheduler(backend, **{"max_slots": 2, **kw})


def test_interactive_class_jumps_bulk_backlog(models):
    """Class priority beats arrival: interactive sequences submitted after
    a bulk backlog admit first and finish first."""
    _, backend = models
    rng = np.random.default_rng(5)
    bulk = [rng.normal(size=(32, FEAT)).astype(np.float32)
            for _ in range(6)]
    inter = [rng.normal(size=(4, FEAT)).astype(np.float32)
             for _ in range(2)]
    order: list[str] = []
    with StepScheduler(backend, max_slots=2, warmup=False,
                       start=False) as eng:
        futures = []
        for cls, group in (("bulk", bulk), ("interactive", inter)):
            for s in group:
                f = eng.submit(s, cls=cls)
                f.add_done_callback(lambda _f, c=cls: order.append(c))
                futures.append(f)
        eng.start()
        for f in futures:
            f.result(timeout=WAIT)
        st = eng.stats()
    assert order[:2] == ["interactive", "interactive"]
    assert st["classes"]["interactive"]["completed"] == 2
    assert st["classes"]["bulk"]["completed"] == 6


@pytest.mark.parametrize("key,value,valid", [
    ("class", "premium", "['interactive', 'bulk']"),
    ("profile", "int8w", "['f32', 'bf16']"),
])
def test_unknown_class_or_profile_is_a_400_naming_the_valid_ones(
        models, seqs, key, value, valid):
    _, backend = models
    with StepScheduler(backend, max_slots=2, warmup=False,
                       profiles=("bf16",)) as eng:
        status, body = handle_request(eng, {"rows": seqs[0].tolist(),
                                            key: value})
        assert status == 400 and valid in body["error"], body
        assert handle_request(eng, {"rows": seqs[0].tolist(),
                                    key: 3})[0] == 400
        status, _ = handle_request(eng, {"rows": seqs[0].tolist(),
                                         "class": "bulk"})
        assert status == 200


def test_bf16_profile_request_served_by_the_child(models, seqs,
                                                  jax_replies):
    """``{"profile": "bf16"}`` runs on the bf16 child's own pool (bf16
    (h, c)), inside the (lstm, bf16) envelope of the oracle; the parent
    serves nothing of it."""
    _, backend = models
    with StepScheduler(backend, max_slots=2, warmup=False,
                       profiles=("bf16",)) as eng:
        child = eng.children["bf16"]
        assert all(h.dtype == c.dtype == torch.bfloat16
                   for h, c in child.backend.init_states(2))
        status, body = handle_request(eng, {"rows": seqs[2].tolist(),
                                            "profile": "bf16"})
        assert eng.precision_desc["profiles"] == ["f32", "bf16"]
    st = eng.stats()  # closed: the drift sample after the reply has run
    assert status == 200
    env = SERVE_ENVELOPES[("lstm", "bf16")]
    assert rel_error(body["predictions"], np.array(jax_replies[0][2])) <= env
    assert st["sequences"] == 0
    assert st["profiles"]["bf16"]["completed"] == 1
    assert st["profiles"]["bf16"]["drift"]["drift_checks"] == 1
    assert st["profiles"]["bf16"]["drift"]["envelope_breaches"] == 0


def test_bf16_scheduler_inside_its_envelope(models, seqs, jax_replies):
    _, backend = models
    bf16 = backend.with_profile("bf16")
    env = SERVE_ENVELOPES[("lstm", "bf16")]
    with StepScheduler(bf16, max_slots=4, step_blocks=(2, 8),
                       warmup=False) as eng:
        got = served(eng, seqs)
    for g, want in zip(got, jax_replies[0]):
        assert 0.0 < rel_error(g, np.array(want)) <= env


def test_failed_block_fails_only_the_in_flight_requests(models,
                                                        monkeypatch):
    """A block program that raises once fails the sequences holding slots
    at that dispatch; queued ones admit into the rebuilt pool and reply
    bit-equal to the pool program, and the engine keeps serving."""
    _, backend = models
    rng = np.random.default_rng(1)
    seqs = [rng.normal(size=(n, FEAT)).astype(np.float32)
            for n in (10, 10, 3, 3, 3, 3)]
    calls = [0]
    real = backend.block_fn

    def flaky(*args):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("device fault")
        return real(*args)

    monkeypatch.setattr(backend, "block_fn", flaky)
    with StepScheduler(backend, max_slots=2, warmup=False,
                       start=False) as eng:
        futures = [eng.submit(s) for s in seqs]
        eng.start()  # both long sequences hold the slots at dispatch 3
        for f in futures[:2]:
            with pytest.raises(RuntimeError, match="device fault"):
                f.result(timeout=WAIT)
        monkeypatch.setattr(backend, "block_fn", real)
        for f, s in zip(futures[2:], seqs[2:]):
            assert np.array_equal(f.result(timeout=WAIT),
                                  pool_program(backend, s, 2))
        assert np.array_equal(eng.predict(seqs[2]),
                              pool_program(backend, seqs[2], 2))
        st = eng.stats()
    assert st["errors"] == 1 and st["failed"] == 2
    assert st["sequences"] == 5 and st["active"] == 0


def test_unrecoverable_fault_fails_every_request_and_closes(models,
                                                           monkeypatch):
    """A block program that raises, then a pool rebuild that raises too
    (a sticky device error): the dispatcher stops, but every request it
    held — holding a slot or queued — resolves with an error, and a new
    request is refused; nothing waits on a future that never resolves."""
    _, backend = models
    rng = np.random.default_rng(2)
    seqs = [rng.normal(size=(n, FEAT)).astype(np.float32)
            for n in (10, 10, 3, 3, 3)]
    real_init = backend.init_states
    builds = [0]

    def broken_block(*args):
        raise RuntimeError("device fault")

    def init_once(slots):
        builds[0] += 1
        if builds[0] > 1:
            raise RuntimeError("sticky device error")
        return real_init(slots)

    monkeypatch.setattr(backend, "block_fn", broken_block)
    monkeypatch.setattr(backend, "init_states", init_once)
    eng = StepScheduler(backend, max_slots=2, warmup=False, start=False)
    try:
        futures = [eng.submit(s) for s in seqs]
        eng.start()
        for f in futures[:2]:  # the slot holders: the block's own fault
            with pytest.raises(RuntimeError, match="device fault"):
                f.result(timeout=WAIT)
        for f in futures[2:]:  # the queued: the failed rebuild's
            with pytest.raises(RuntimeError, match="sticky device error"):
                f.result(timeout=WAIT)
        eng._thread.join(timeout=WAIT)
        assert not eng._thread.is_alive()
        with pytest.raises(ServeError, match="dispatcher failure"):
            eng.submit(seqs[0])
        st = eng.stats()
        assert st["failed"] == len(seqs) and st["sequences"] == 0
        status, reply = handle_request(eng, {"rows": seqs[0].tolist()})
        assert status == 400 and "dispatcher failure" in reply["error"]
    finally:
        eng.close()


def test_stats_keys_are_the_jax_schedulers_less_the_left_out_parts(
        models, seqs):
    """The JAX StepScheduler.stats() keys without the sections of the
    parts not ported yet, with and without a child profile."""
    jb, backend = models
    left_out = {"slo", "trace", "aot"}
    for profiles in ((), ("bf16",)):
        with JaxStepScheduler(jb, max_slots=2, warmup=False,
                              profiles=profiles) as eng:
            want = set(eng.stats()) - left_out
        with StepScheduler(backend, max_slots=2, warmup=False,
                           profiles=profiles) as eng:
            eng.predict(seqs[0])
            got = eng.stats()
        assert set(got) == want, profiles
    assert got["scheduler"] == "continuous" and got["slots"] == 2
    assert set(got["profiles"]["bf16"]) == {"requests", "completed",
                                            "active", "drift"}


def test_bad_requests_closed_engine_and_draining_close(models, seqs):
    _, backend = models
    eng = StepScheduler(backend, max_slots=2, warmup=False, start=False)
    with pytest.raises(ServeError, match="sequence must be"):
        eng.submit(np.zeros((4, FEAT + 1), np.float32))
    with pytest.raises(ServeError, match="at least one step"):
        eng.submit(np.zeros((0, FEAT), np.float32))
    futures = [eng.submit(s) for s in seqs[:4]]
    eng.close()  # never started: queued work still drains
    for f, s in zip(futures, seqs):
        assert np.array_equal(f.result(timeout=WAIT),
                              pool_program(backend, s, 2))
    with pytest.raises(ServeError, match="closed"):
        eng.submit(seqs[0])


def test_configured_engine_is_the_step_scheduler(models, seqs):
    _, backend = models
    cfg = apply_overrides(Config(), [
        "serve.scheduler=continuous", "serve.max_slots=4",
        "serve.step_blocks=2,8", "serve.readback_interval_ms=5",
        "serve.classes=interactive,bulk", "serve.profiles=fused",
        "serve.warmup=false"])
    with make_sequence_engine(backend, cfg) as eng:
        assert isinstance(eng, StepScheduler)
        assert eng.step_blocks == (2, 8) and eng.max_slots == 4
        assert list(eng.children) == ["fused"]
        got = eng.predict(seqs[1], profile="fused")
    # the fused tier's step block is the scan in float32, as in f32
    assert np.array_equal(got, pool_program(backend, seqs[1], 4))
    with pytest.raises(ConfigError, match="fp8"):
        make_sequence_engine(backend, apply_overrides(Config(), [
            "serve.scheduler=continuous", "serve.profiles=fp8"]))


def test_drift_stats_count_breaches_and_survive_a_failing_oracle():
    from euromillioner_tpu_torch.serve.engine import DriftStats

    drift = DriftStats("bf16", SERVE_ENVELOPES[("lstm", "bf16")])
    for value in (0.1, 0.2, 0.01):
        drift.observe(value)
    snap = drift.snapshot()
    assert (snap["drift_checks"], snap["envelope_breaches"]) == (3, 2)
    assert (snap["drift_last"], snap["drift_max"]) == (0.01, 0.2)

    def broken():
        raise RuntimeError("oracle down")

    assert drift.sample(np.zeros(7), broken, threading.Lock()) is None
    assert drift.snapshot() == snap

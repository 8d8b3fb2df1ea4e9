"""The port's slot preemption and elastic pool (serve/continuous.py
``serve.preempt``) against the JAX package's StepScheduler under the same
policy, and the port's own bit pins: a preempted-and-restored sequence
replies bit-equal to one never preempted at the same block row count, in
f32 and bf16, and a sequence that crosses a resize bit-equal to one that
never did. Each behaviour mirrors a test of tests/test_preempt.py (its
chaos tests wait for the port's fault points)."""

import time

import jax
import numpy as np
import pytest
import torch

from euromillioner_tpu.models.lstm import build_lstm as jax_build_lstm
from euromillioner_tpu.serve import PreemptPolicy as JaxPreemptPolicy
from euromillioner_tpu.serve import RecurrentBackend as JaxBackend
from euromillioner_tpu.serve import StepScheduler as JaxStepScheduler
from euromillioner_tpu.utils.errors import ServeError as JaxServeError
from euromillioner_tpu_torch.config import Config, apply_overrides
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.serve.continuous import (PreemptPolicy,
                                                      RecurrentBackend,
                                                      StepScheduler,
                                                      make_sequence_engine)
from euromillioner_tpu_torch.utils.errors import ServeError

torch.set_num_threads(2)

FEAT = 11
# port vs JAX, f32 on both sides: the JAX package's NN trajectory pin
RTOL = 1e-5
ATOL = 1e-6
WAIT = 60  # seconds any future may take


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


@pytest.fixture(scope="module")
def bf16_backend(backend):
    return backend.with_profile("bf16")


def _seqs(rng, n, steps):
    return [rng.normal(size=(steps, FEAT)).astype(np.float32)
            for _ in range(n)]


def pool_program(backend, seq, rows):
    """``seq``'s reply from the block program run straight through at
    ``rows`` rows: what a never-preempted sequence replies in a pool whose
    block has that many rows."""
    x = torch.from_numpy(np.repeat(seq[None], rows, 0))
    _, y = backend.block_fn(backend.init_states(rows), x,
                            torch.ones((rows, 1), dtype=torch.bool))
    return y[0, -1].numpy()


def mid_flight(eng, seqs, cls="bulk", dispatches=4, **kw):
    """Submit ``seqs`` to a not-yet-started scheduler, admit them and run
    ``dispatches`` blocks on this thread: the holders are provably
    mid-sequence with real rows on the device."""
    futures = [eng.submit(s, cls=cls, **kw) for s in seqs]
    with eng._cond:
        eng._admit_locked()
    for _ in range(dispatches):
        eng._dispatch_step()
    return futures


def results(futures):
    return [f.result(timeout=WAIT) for f in futures]


def test_preempted_bulk_restores_bit_identical(models):
    """Bulk sequences mid-flight are evicted for later interactive ones
    and restored; every reply is bit-equal to the never-preempted pool
    program and within tolerance of the JAX scheduler's under the same
    policy and traffic."""
    jb, backend = models
    rng = np.random.default_rng(0)
    bulk = _seqs(rng, 2, 48)
    inter = _seqs(rng, 2, 4)
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=True,
                        preempt=PreemptPolicy(enabled=True, max_evicted=8),
                        start=False)
    try:
        fb = mid_flight(eng, bulk)
        fi = [eng.submit(s, cls="interactive") for s in inter]
        eng.start()
        got = results(fi) + results(fb)
        st = eng.stats()
    finally:
        eng.close()
    with JaxStepScheduler(jb, max_slots=2, step_block=2, warmup=False,
                          preempt=JaxPreemptPolicy(enabled=True,
                                                   max_evicted=8),
                          start=False) as jeng:
        jfb = [jeng.submit(s, cls="bulk") for s in bulk]
        with jeng._cond:
            jeng._admit_locked()
        for _ in range(4):
            jeng._dispatch_step()
        jfi = [jeng.submit(s, cls="interactive") for s in inter]
        jeng.start()
        want = results(jfi) + results(jfb)
        jst = jeng.stats()
    for g, w, s in zip(got, want, inter + bulk):
        assert np.array_equal(g, pool_program(backend, s, 2))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert st["preempt"]["preempted"] == jst["preempt"]["preempted"] >= 1
    assert st["preempt"]["restored"] == st["preempt"]["preempted"]
    assert st["preempt"]["evicted_depth"] == 0
    assert st["failed"] == 0 and st["errors"] == 0
    assert st["active"] == 0 and st["queued"] == 0


def test_same_class_deadlines_never_preempt(backend):
    rng = np.random.default_rng(1)
    bulk = _seqs(rng, 2, 32)
    late = _seqs(rng, 1, 4)[0]
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=True,
                        preempt=PreemptPolicy(enabled=True), start=False)
    try:
        fb = mid_flight(eng, bulk, dispatches=2)
        fl = eng.submit(late, cls="bulk", max_wait_s=0.0)
        eng.start()
        assert np.array_equal(fl.result(timeout=WAIT),
                              pool_program(backend, late, 2))
        for f, s in zip(fb, bulk):
            assert np.array_equal(f.result(timeout=WAIT),
                                  pool_program(backend, s, 2))
        st = eng.stats()
    finally:
        eng.close()
    assert st["preempt"]["preempted"] == 0


def test_make_sequence_engine_threads_policy(backend):
    cfg = apply_overrides(Config(), [
        "serve.scheduler=continuous", "serve.max_slots=4",
        "serve.warmup=false", "serve.preempt.enabled=true",
        "serve.preempt.elastic=true", "serve.preempt.min_slots=2"])
    eng = make_sequence_engine(backend, cfg)
    try:
        assert eng._preempt.enabled and eng._preempt.elastic
        assert eng.pool_slots == 2 and eng.max_slots == 4
    finally:
        eng.close()


def test_disabled_policy_surface_is_inert(models):
    """The default policy never preempts and reports the JAX scheduler's
    zeroed preempt section and /healthz load keys."""
    jb, backend = models
    rng = np.random.default_rng(2)
    seq = _seqs(rng, 1, 4)[0]
    with StepScheduler(backend, max_slots=2, warmup=False) as eng:
        eng.predict(seq)
        st = eng.stats()
        load = eng.load_desc
    with JaxStepScheduler(jb, max_slots=2, warmup=False) as jeng:
        jeng.predict(seq)
        jst = jeng.stats()
        jload = jeng.load_desc
    assert st["preempt"] == jst["preempt"] == {
        "enabled": False, "elastic": False, "pool_slots": 2,
        "preempted": 0, "restored": 0, "shed": 0,
        "evicted_depth": 0, "resizes": 0}
    assert set(load) == set(jload)
    assert load["preempted"] == 0 and load["evicted_depth"] == 0


def test_pending_admission_eviction_drains_ledger(backend):
    """A victim evicted before its first dispatch (no state) re-admits
    with a reset, and its ledger entry drains there too."""
    rng = np.random.default_rng(11)
    bulk = _seqs(rng, 2, 24)
    inter = _seqs(rng, 2, 4)
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=True,
                        preempt=PreemptPolicy(enabled=True), start=False)
    try:
        fb = mid_flight(eng, bulk, dispatches=0)
        fi = [eng.submit(s, cls="interactive") for s in inter]
        eng._preempt_for_queue()
        assert len(eng._evicted) == 2
        assert all(r.evicted_state is None for r in eng._evicted.values())
        eng.start()
        for f, s in zip(fi + fb, inter + bulk):
            assert np.array_equal(f.result(timeout=WAIT),
                                  pool_program(backend, s, 2))
        st = eng.stats()
    finally:
        eng.close()
    assert st["preempt"]["preempted"] == 2
    assert st["preempt"]["restored"] == 0  # no state: a plain reset
    assert st["preempt"]["evicted_depth"] == 0
    assert st["failed"] == 0 and st["errors"] == 0


def test_reevicting_restore_pending_slot_keeps_parked_state(backend):
    """Evicting a slot whose restore is not applied yet keeps the parked
    rows (the slot's device rows are a previous occupant's) and drops the
    stale pending restore."""
    rng = np.random.default_rng(12)
    bulk = _seqs(rng, 2, 48)
    inter = _seqs(rng, 2, 4)
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=True,
                        preempt=PreemptPolicy(enabled=True), start=False)
    try:
        fb = mid_flight(eng, bulk)
        f1 = eng.submit(inter[0], cls="interactive")
        eng._preempt_for_queue()
        assert len(eng._evicted) == 1
        victim = next(iter(eng._evicted.values()))
        blobs = victim.evicted_state
        assert blobs is not None
        f1.cancel()  # the urgent head is gone: the victim re-admits
        with eng._cond:
            eng._admit_locked()
        assert eng._pending_restore and not eng._evicted
        f2 = eng.submit(inter[1], cls="interactive")
        eng._preempt_for_queue()  # evicted again before the restore ran
        assert next(iter(eng._evicted.values())) is victim
        assert victim.evicted_state is blobs
        assert not eng._pending_restore
        eng.start()
        assert np.array_equal(f2.result(timeout=WAIT),
                              pool_program(backend, inter[1], 2))
        for f, s in zip(fb, bulk):
            assert np.array_equal(f.result(timeout=WAIT),
                                  pool_program(backend, s, 2))
        st = eng.stats()
    finally:
        eng.close()
    assert st["failed"] == 0 and st["errors"] == 0
    assert st["preempt"]["evicted_depth"] == 0


def test_bf16_evict_restore_no_f32_bounce(bf16_backend):
    """A bf16 pool parks its victims' rows as bfloat16 and the preempted
    run replies bit-equal to a never-preempted bf16 run."""
    rng = np.random.default_rng(3)
    bulk = _seqs(rng, 2, 48)
    inter = _seqs(rng, 1, 4)[0]
    with StepScheduler(bf16_backend, max_slots=2, step_block=2,
                       warmup=False) as eng:
        ref = results([eng.submit(s, cls="bulk") for s in bulk])
    eng = StepScheduler(bf16_backend, max_slots=2, step_block=2,
                        warmup=False, preempt=PreemptPolicy(enabled=True),
                        start=False)
    try:
        fb = mid_flight(eng, bulk)
        fi = eng.submit(inter, cls="interactive")
        eng._preempt_for_queue()
        dtypes = {t.dtype for r in eng._evicted.values()
                  for pair in r.evicted_state for t in pair}
        eng.start()
        fi.result(timeout=WAIT)
        got = results(fb)
        st = eng.stats()
    finally:
        eng.close()
    assert st["preempt"]["preempted"] >= 1
    assert dtypes == {torch.bfloat16}
    assert all(np.array_equal(g, w) for g, w in zip(got, ref))


def test_ledger_bound_stops_preemption(backend):
    rng = np.random.default_rng(4)
    bulk = _seqs(rng, 2, 48)
    inter = _seqs(rng, 2, 12)
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=True,
                        preempt=PreemptPolicy(enabled=True, max_evicted=1),
                        start=False)
    try:
        fb = mid_flight(eng, bulk)
        fi = [eng.submit(s, cls="interactive") for s in inter]
        eng.start()
        for f, s in zip(fi + fb, inter + bulk):
            assert np.array_equal(f.result(timeout=WAIT),
                                  pool_program(backend, s, 2))
        st = eng.stats()
    finally:
        eng.close()
    assert st["preempt"]["preempted"] == 1
    assert st["preempt"]["restored"] == 1
    assert st["failed"] == 0 and st["errors"] == 0


def test_expired_evicted_sequence_shed_loudly(backend):
    """A parked bulk sequence whose deadline passes fails with a
    ServeError naming the overrun and lands in the shed count."""
    rng = np.random.default_rng(5)
    bulk = _seqs(rng, 2, 48)
    inter = _seqs(rng, 6, 32)
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=True,
                        preempt=PreemptPolicy(enabled=True, max_evicted=8),
                        start=False)
    try:
        fb = mid_flight(eng, bulk, max_wait_s=0.05)
        fi = [eng.submit(s, cls="interactive") for s in inter]
        eng._preempt_for_queue()  # both holders park behind 6 urgent
        time.sleep(0.06)
        eng.start()
        shed = 0
        for f in fb:
            try:
                f.result(timeout=WAIT)
            except ServeError as e:
                assert "shed" in str(e) and "deadline" in str(e)
                shed += 1
        for f, s in zip(fi, inter):
            assert np.array_equal(f.result(timeout=WAIT),
                                  pool_program(backend, s, 2))
        st = eng.stats()
    finally:
        eng.close()
    assert shed == 2
    assert st["preempt"]["shed"] == shed and st["failed"] == shed
    assert st["errors"] == 0
    assert st["preempt"]["evicted_depth"] == 0
    assert st["active"] == 0 and st["queued"] == 0


def test_flood_grows_then_drains_bit_identical(models):
    """An elastic pool starts at min_slots and grows under a flood; every
    reply is bit-equal to the same sequence in a fixed pool of max_slots
    (the block steps at max_slots rows whatever the live size) and within
    tolerance of the JAX elastic scheduler's."""
    jb, backend = models
    rng = np.random.default_rng(6)
    seqs = [rng.normal(size=(int(n), FEAT)).astype(np.float32)
            for n in rng.integers(8, 33, size=16)]
    kw = dict(enabled=True, elastic=True, min_slots=2, grow_load=0.9,
              shrink_load=0.25, resize_hysteresis=1)
    with StepScheduler(backend, max_slots=8, step_block=2, warmup=True,
                       preempt=PreemptPolicy(**kw), start=False) as eng:
        assert eng.pool_slots == 2
        futures = [eng.submit(s) for s in seqs]
        eng.start()
        got = results(futures)
        st = eng.stats()
    with StepScheduler(backend, max_slots=8, step_block=2,
                       warmup=False) as eng:
        fixed = results([eng.submit(s) for s in seqs])
    with JaxStepScheduler(jb, max_slots=8, step_block=2, warmup=False,
                          preempt=JaxPreemptPolicy(**kw),
                          start=False) as jeng:
        futures = [jeng.submit(s) for s in seqs]
        jeng.start()
        want = results(futures)
    for g, f, w, s in zip(got, fixed, want, seqs):
        assert np.array_equal(g, f)
        assert np.array_equal(g, pool_program(backend, s, 8))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert st["preempt"]["resizes"] >= 2
    assert st["failed"] == 0 and st["errors"] == 0


def test_explicit_shrink_evicts_and_restores(backend):
    """A shrink is an eviction: the holders of the high slots park and
    restore into the smaller pool, bit-equal to the unresized run."""
    rng = np.random.default_rng(7)
    bulk = _seqs(rng, 2, 48)
    pol = PreemptPolicy(enabled=True, elastic=True, min_slots=2,
                        grow_load=99.0, shrink_load=-1.0,
                        resize_hysteresis=1)
    eng = StepScheduler(backend, max_slots=8, step_block=2, warmup=False,
                        preempt=pol, start=False)
    try:
        eng.request_resize(8)
        eng._maybe_resize()
        assert eng.pool_slots == 8
        fb = mid_flight(eng, bulk, dispatches=2)
        assert {s for s, r in enumerate(eng._slot_req) if r} == {6, 7}
        eng.request_resize(2)
        eng.start()
        got = results(fb)
        st = eng.stats()
    finally:
        eng.close()
    assert all(np.array_equal(g, pool_program(backend, s, 8))
               for g, s in zip(got, bulk))
    assert st["preempt"]["resizes"] == 2
    assert st["preempt"]["preempted"] == 2
    assert st["preempt"]["restored"] == 2
    assert st["preempt"]["pool_slots"] == 2
    assert st["budget"]["bytes"]["pool"] == 2 * 2 * 2 * 8 * 4
    assert st["failed"] == 0 and st["errors"] == 0


def test_request_resize_needs_elastic(backend):
    with StepScheduler(backend, max_slots=2, warmup=False) as eng:
        with pytest.raises(ServeError, match="elastic"):
            eng.request_resize(4)


@pytest.mark.parametrize("kw,match", [
    (dict(preempt=PreemptPolicy(enabled=True, min_slots=1)), "min_slots"),
    (dict(preempt=PreemptPolicy(enabled=True, max_evicted=0)),
     "max_evicted"),
    (dict(preempt=PreemptPolicy(elastic=True, grow_load=0.5,
                                shrink_load=0.5)), "shrink_load"),
    (dict(preempt=PreemptPolicy(elastic=True, min_slots=8)), "exceeds"),
    (dict(preempt=PreemptPolicy(elastic=True, resize_hysteresis=0)),
     "resize_hysteresis"),
])
def test_bad_policies_rejected(models, kw, match):
    """The port refuses what the JAX scheduler refuses, with its words."""
    jb, backend = models
    with pytest.raises(ServeError, match=match):
        StepScheduler(backend, max_slots=4, warmup=False, **kw)
    jkw = {"preempt": JaxPreemptPolicy(**vars(kw["preempt"]))}
    with pytest.raises(JaxServeError, match=match):
        JaxStepScheduler(jb, max_slots=4, warmup=False, **jkw)


def _overlap_run(backend, bulk, inter, restore_async):
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=True,
                        preempt=PreemptPolicy(enabled=True, max_evicted=8),
                        start=False)
    try:
        eng._restore_async = restore_async
        fb = mid_flight(eng, bulk)
        fi = [eng.submit(s, cls="interactive") for s in inter]
        eng.start()
        got = results(fi) + results(fb)
        st = eng.stats()
    finally:
        eng.close()
    assert st["preempt"]["restored"] >= 1
    assert st["failed"] == 0 and st["errors"] == 0
    return got


def test_overlapped_restore_bit_identical_to_synchronous(backend):
    rng = np.random.default_rng(20)
    bulk = _seqs(rng, 2, 48)
    inter = _seqs(rng, 2, 4)
    staged = _overlap_run(backend, bulk, inter, True)
    sync = _overlap_run(backend, bulk, inter, False)
    assert all(np.array_equal(a, b) for a, b in zip(staged, sync))
    assert all(np.array_equal(a, pool_program(backend, s, 2))
               for a, s in zip(staged, inter + bulk))


def test_staged_payload_is_device_placed(backend):
    """Admission stages a restore's upload on the serving device before
    the scatter runs (the overlap is real)."""
    rng = np.random.default_rng(21)
    bulk = _seqs(rng, 2, 24)
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=True,
                        preempt=PreemptPolicy(enabled=True), start=False)
    try:
        fb = mid_flight(eng, bulk, dispatches=2)
        fi = eng.submit(bulk[0][:4], cls="interactive")
        eng._preempt_for_queue()
        assert len(eng._evicted) == 1
        fi.cancel()
        with eng._cond:
            eng._admit_locked()
        assert eng._pending_restore
        eng._stage_restores()
        items = list(eng._restore_buf._q)
        assert items, "the restore upload was not staged"
        for _slot, _req, payload in items:
            for h, c in payload:
                assert h.device == c.device == backend.device
        eng.start()
        for f, s in zip(fb, bulk):
            assert np.array_equal(f.result(timeout=WAIT),
                                  pool_program(backend, s, 2))
    finally:
        eng.close()


def _park_expired(backend):
    rng = np.random.default_rng(22)
    bulk = _seqs(rng, 2, 24)
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=True,
                        preempt=PreemptPolicy(enabled=True), start=False)
    fb = mid_flight(eng, bulk, dispatches=0, max_wait_s=0.02)
    eng.submit(_seqs(rng, 1, 4)[0], cls="interactive")
    eng._preempt_for_queue()
    assert len(eng._evicted) == 1
    time.sleep(0.05)  # its deadline passes while parked
    return eng, fb


@pytest.mark.parametrize("how", ["stats", "submit", "close"])
def test_idle_scheduler_sweeps_expired_parked(backend, how):
    """stats(), a submit and close() each shed an expired parked sequence
    with no dispatcher running: no expiry waits for a block boundary."""
    eng, fb = _park_expired(backend)
    try:
        if how == "stats":
            st = eng.stats()
            assert st["preempt"]["shed"] == 1
            assert st["preempt"]["evicted_depth"] == 0
        elif how == "submit":
            eng.submit(_seqs(np.random.default_rng(23), 1, 4)[0],
                       cls="interactive")
        else:
            eng.close()
        shed = [f for f in fb if f.done() and f.exception()]
        assert len(shed) == 1
        assert "shed" in str(shed[0].exception())
        assert "deadline" in str(shed[0].exception())
    finally:
        eng.close()


@pytest.mark.parametrize("section", ["preempt", "budget", "paging"])
def test_config_sections_are_the_jax_packages(section):
    """``serve.preempt``, ``serve.budget`` and ``serve.paging`` have the
    JAX package's fields and defaults, so every override of these
    sections the JAX CLI takes means the same here."""
    import dataclasses

    from euromillioner_tpu.config import Config as JaxConfig

    mine = getattr(Config().serve, section)
    theirs = getattr(JaxConfig().serve, section)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for f in dataclasses.fields(mine):
        value = "3" if isinstance(getattr(mine, f.name), (int, float)) \
            and not isinstance(getattr(mine, f.name), bool) else "true"
        if isinstance(getattr(mine, f.name), str):
            value = "/spill"
        cfg = apply_overrides(Config(), [f"serve.{section}.{f.name}={value}"])
        assert getattr(getattr(cfg.serve, section), f.name) == \
            type(getattr(mine, f.name))(
                value if not isinstance(getattr(mine, f.name), bool)
                else True)

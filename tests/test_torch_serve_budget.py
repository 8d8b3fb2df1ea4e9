"""The port's memory budget (serve/session.py MemoryLedger, BudgetPolicy;
the step scheduler's governor and spill tier) against the JAX package's
under the same budget, and the port's own bit pins: a spilled sequence
replies bit-equal to one parked in RAM and to one never preempted, in f32
and bf16, with its spill file in the pool's own dtype. Each behaviour
mirrors a test of tests/test_budget.py (its chaos tests wait for the
port's fault points)."""

import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from euromillioner_tpu.models.lstm import build_lstm as jax_build_lstm
from euromillioner_tpu.serve import BudgetPolicy as JaxBudgetPolicy
from euromillioner_tpu.serve import MemoryLedger as JaxMemoryLedger
from euromillioner_tpu.serve import PreemptPolicy as JaxPreemptPolicy
from euromillioner_tpu.serve import RecurrentBackend as JaxBackend
from euromillioner_tpu.serve import StepScheduler as JaxStepScheduler
from euromillioner_tpu.utils import serialization as jax_serialization
from euromillioner_tpu_torch.config import Config, apply_overrides
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.models.mlp import build_mlp
from euromillioner_tpu_torch.serve.continuous import (PreemptPolicy,
                                                      RecurrentBackend,
                                                      StepScheduler,
                                                      make_sequence_engine)
from euromillioner_tpu_torch.serve.engine import InferenceEngine
from euromillioner_tpu_torch.serve.session import (BudgetPolicy,
                                                   MemoryLedger, NNBackend)
from euromillioner_tpu_torch.utils import serialization
from euromillioner_tpu_torch.utils.errors import ServeError

torch.set_num_threads(2)

FEAT = 11
RTOL = 1e-5
ATOL = 1e-6
WAIT = 60
# one victim's parked rows in the 2-layer, 8-wide f32 pool: 2 x (h + c)
# x 8 x 4 bytes; its EMT1 spill file is 4 entries x (23 + 32) + 8 bytes
BLOB = 128
FILE = 228


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


def _seqs(rng, n, steps):
    return [rng.normal(size=(steps, FEAT)).astype(np.float32)
            for _ in range(n)]


def pool_program(backend, seq, rows):
    x = torch.from_numpy(np.repeat(seq[None], rows, 0))
    _, y = backend.block_fn(backend.init_states(rows), x,
                            torch.ones((rows, 1), dtype=torch.bool))
    return y[0, -1].numpy()


def mid_flight(eng, seqs, cls="bulk", dispatches=4, **kw):
    """Submit to a not-yet-started scheduler, admit, run ``dispatches``
    blocks on this thread: real rows on the device."""
    futures = [eng.submit(s, cls=cls, **kw) for s in seqs]
    with eng._cond:
        eng._admit_locked()
    for _ in range(dispatches):
        eng._dispatch_step()
    return futures


def results(futures):
    return [f.result(timeout=WAIT) for f in futures]


@pytest.mark.parametrize("Ledger", [MemoryLedger, JaxMemoryLedger],
                         ids=["port", "jax"])
def test_memory_ledger_add_sub_peak_headroom(Ledger):
    """The port's ledger and the JAX package's answer alike."""
    m = Ledger({"ram": 100})
    assert m.headroom("ram") == 100
    m.add("ram", 60)
    m.add("ram", 30)
    assert m.bytes("ram") == 90 and m.peak("ram") == 90
    m.sub("ram", 50)
    assert m.bytes("ram") == 40 and m.peak("ram") == 90
    assert m.headroom("ram") == 60
    assert m.budget("ram") == 100 and m.budget("disk") is None
    assert m.headroom("disk") == float("inf")
    m.add("queue", 10)
    m.sub("queue", 25)  # a bookkeeping fault: clamped, warned
    assert m.bytes("queue") == 0
    m.set_bytes("pool", 256)
    m.set_bytes("pool", 128)
    snap = m.snapshot(defaults=("staged",))
    assert snap["bytes"] == {"pool": 128, "queue": 0, "ram": 40,
                             "staged": 0}
    assert snap["peak"]["pool"] == 256 and snap["budgets"] == {"ram": 100}
    assert m.bytes() == 168
    assert Ledger({"queue": 0, "ram": 5}).budget("queue") is None


def test_try_add_is_an_atomic_check_and_reserve():
    m = MemoryLedger({"queue": 1000})
    assert m.try_add("queue", 600)
    assert not m.try_add("queue", 600)
    assert m.bytes("queue") == 600
    m.sub("queue", 600)
    barrier = threading.Barrier(8)
    over = []

    def worker():
        barrier.wait()
        for _ in range(50):
            if m.try_add("queue", 300):
                if m.bytes("queue") > 1000:
                    over.append(1)
                m.sub("queue", 300)

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT)
    assert not over and m.peak("queue") <= 1000
    assert MemoryLedger().try_add("queue", 10**12)


@pytest.mark.parametrize("kw,match", [
    (dict(ledger_bytes=0), "ledger_bytes"),
    (dict(spill_dir="/nonexistent/x", spill_bytes=0), "spill_bytes"),
    (dict(queue_bytes=-1), "queue_bytes"),
])
def test_budget_policy_validation(kw, match):
    with pytest.raises(ServeError, match=match):
        BudgetPolicy(enabled=True, **kw).validate()


def test_from_config_threads_through_factory(backend):
    cfg = apply_overrides(Config(), [
        "serve.scheduler=continuous", "serve.max_slots=2",
        "serve.warmup=false", "serve.budget.enabled=true",
        "serve.budget.ledger_bytes=4096",
        "serve.budget.queue_bytes=65536"])
    eng = make_sequence_engine(backend, cfg)
    try:
        assert eng._budget.enabled and eng._budget.ledger_bytes == 4096
        assert eng._mem.budget("ram") == 4096
        assert eng._mem.budget("queue") == 65536
    finally:
        eng.close()


def test_disabled_default_tracks_but_never_enforces(models):
    """Bytes are tracked without a budget; the section's keys are the JAX
    scheduler's."""
    jb, backend = models
    seq = _seqs(np.random.default_rng(0), 1, 4)[0]
    with StepScheduler(backend, max_slots=2, warmup=False) as eng:
        eng.predict(seq)
        b = eng.stats()["budget"]
    with JaxStepScheduler(jb, max_slots=2, warmup=False) as jeng:
        jeng.predict(seq)
        jb_ = jeng.stats()["budget"]
    assert set(b) == set(jb_)
    assert set(b["bytes"]) == set(jb_["bytes"])
    assert b["enabled"] is False and b["budgets"] == {}
    assert b["bytes"]["pool"] == jb_["bytes"]["pool"] == 2 * 2 * 8 * 4 * 2
    assert b["bytes"]["params"] == jb_["bytes"]["params"] > 0
    assert b["spills"] == b["deferred"] == b["shed"] == 0
    assert b["spill_restored"] == 0


def _spill_run(backend, bulk, inter, budget):
    """Bulk mid-flight, interactive arrivals that evict both; returns the
    replies (interactive first) and stats."""
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=True,
                        preempt=PreemptPolicy(enabled=True, max_evicted=8),
                        budget=budget, start=False)
    try:
        fb = mid_flight(eng, bulk)
        fi = [eng.submit(s, cls="interactive") for s in inter]
        eng.start()
        return results(fi) + results(fb), eng.stats()
    finally:
        eng.close()


def test_forced_spill_restores_bit_identical_f32(models, tmp_path):
    """A ledger too small for the victims spills LRU to disk; the spilled
    sequences reply bit-equal to RAM-parked ones and to the pool program,
    and within tolerance of the JAX scheduler under the same budget. Peak
    RAM stays in the budget, both tiers drain, no file survives."""
    jb, backend = models
    rng = np.random.default_rng(1)
    bulk = _seqs(rng, 2, 64)
    inter = _seqs(rng, 8, 4)
    small = BudgetPolicy(enabled=True, ledger_bytes=BLOB + 32,
                         spill_dir=str(tmp_path / "port"),
                         spill_bytes=1 << 20)
    got, st = _spill_run(backend, bulk, inter, small)
    parked, pst = _spill_run(backend, bulk, inter,
                             BudgetPolicy(enabled=True))
    with JaxStepScheduler(
            jb, max_slots=2, step_block=2, warmup=False,
            preempt=JaxPreemptPolicy(enabled=True, max_evicted=8),
            budget=JaxBudgetPolicy(enabled=True, ledger_bytes=BLOB + 32,
                                   spill_dir=str(tmp_path / "jax"),
                                   spill_bytes=1 << 20),
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
    for g, p, w, s in zip(got, parked, want, inter + bulk):
        assert np.array_equal(g, p)
        assert np.array_equal(g, pool_program(backend, s, 2))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    b = st["budget"]
    assert b["spills"] == jst["budget"]["spills"] >= 1
    assert b["spill_restored"] >= 1
    assert pst["budget"]["spills"] == 0 and pst["preempt"]["restored"] >= 1
    assert b["peak"]["ram"] <= BLOB + 32
    assert b["bytes"]["ram"] == 0 and b["bytes"]["disk"] == 0
    assert os.listdir(tmp_path / "port") == []
    assert st["failed"] == 0 and st["errors"] == 0 and b["shed"] == 0


def test_bf16_pool_spills_in_its_own_dtype_and_restores_bit_identical(
        backend, tmp_path):
    """A bf16 pool's spill file holds bfloat16 rows (EMT1 code 6, read
    back as bfloat16 by either package), and its spilled run replies
    bit-equal to a never-preempted bf16 run."""
    bf16 = backend.with_profile("bf16")
    rng = np.random.default_rng(2)
    bulk = _seqs(rng, 2, 64)
    inter = _seqs(rng, 8, 4)
    with StepScheduler(bf16, max_slots=2, step_block=2,
                       warmup=False) as eng:
        ref = results([eng.submit(s, cls="bulk") for s in bulk])
    bud = BudgetPolicy(enabled=True, ledger_bytes=BLOB // 2 + 16,
                       spill_dir=str(tmp_path), spill_bytes=1 << 20)
    eng = StepScheduler(bf16, max_slots=2, step_block=2, warmup=False,
                        preempt=PreemptPolicy(enabled=True, max_evicted=8),
                        budget=bud, start=False)
    try:
        fb = mid_flight(eng, bulk)
        fi = [eng.submit(s, cls="interactive") for s in inter]
        eng._preempt_for_queue()  # parks both; the colder one spills
        (name,) = os.listdir(tmp_path)
        spilled = serialization.load(str(tmp_path / name))
        jax_read = jax_serialization.load(str(tmp_path / name))
        eng.start()
        results(fi)
        got = results(fb)
        st = eng.stats()
    finally:
        eng.close()
    assert {t.dtype for t in spilled.values()} == {torch.bfloat16}
    assert {a.dtype.name for a in jax_read.values()} == {"bfloat16"}
    assert {tuple(t.shape) for t in spilled.values()} == {(8,)}
    assert st["budget"]["spills"] >= 1
    assert st["budget"]["spill_restored"] >= 1
    assert all(np.array_equal(g, w) for g, w in zip(got, ref))
    assert st["failed"] == 0 and st["errors"] == 0


def test_corrupted_spill_blob_sheds_only_that_sequence(backend, tmp_path):
    """A spill file that fails its crc32 sheds its own sequence, with a
    ServeError naming the file; the other replies stay bit-equal and the
    pool keeps serving."""
    rng = np.random.default_rng(3)
    bulk = _seqs(rng, 2, 48)
    inter = _seqs(rng, 2, 4)
    bud = BudgetPolicy(enabled=True, ledger_bytes=BLOB + 32,
                       spill_dir=str(tmp_path), spill_bytes=1 << 20)
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=True,
                        preempt=PreemptPolicy(enabled=True), budget=bud,
                        start=False)
    try:
        fb = mid_flight(eng, bulk)
        fi = [eng.submit(s, cls="interactive") for s in inter]
        eng._preempt_for_queue()
        (name,) = os.listdir(tmp_path)
        path = tmp_path / name
        raw = bytearray(path.read_bytes())
        raw[-10] ^= 0xFF  # a payload byte: the crc must catch it
        path.write_bytes(bytes(raw))
        eng.start()
        for f, s in zip(fi, inter):
            assert np.array_equal(f.result(timeout=WAIT),
                                  pool_program(backend, s, 2))
        outcomes = []
        for f, s in zip(fb, bulk):
            try:
                outcomes.append(np.array_equal(f.result(timeout=WAIT),
                                               pool_program(backend, s, 2)))
            except ServeError as e:
                assert "spill blob" in str(e) and name in str(e)
                outcomes.append("shed")
        assert outcomes.count("shed") == 1 and outcomes.count(True) == 1
        assert np.array_equal(eng.predict(bulk[0]),
                              pool_program(backend, bulk[0], 2))
        st = eng.stats()
    finally:
        eng.close()
    assert st["budget"]["shed"] == 1 and st["failed"] == 1
    assert st["errors"] == 0
    assert st["budget"]["bytes"]["disk"] == 0
    assert os.listdir(tmp_path) == []


def test_rung1_full_ledger_stops_preemption(backend):
    rng = np.random.default_rng(4)
    bulk = _seqs(rng, 2, 32)
    inter = _seqs(rng, 1, 4)[0]
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=True,
                        preempt=PreemptPolicy(enabled=True),
                        budget=BudgetPolicy(enabled=True,
                                            ledger_bytes=BLOB - 1),
                        start=False)
    try:
        fb = mid_flight(eng, bulk, dispatches=2)
        fi = eng.submit(inter, cls="interactive")
        eng.start()
        assert np.array_equal(fi.result(timeout=WAIT),
                              pool_program(backend, inter, 2))
        for f, s in zip(fb, bulk):
            assert np.array_equal(f.result(timeout=WAIT),
                                  pool_program(backend, s, 2))
        st = eng.stats()
    finally:
        eng.close()
    assert st["preempt"]["preempted"] == 0
    assert st["budget"]["deferred"] >= 1
    assert st["budget"]["peak"]["ram"] == 0
    assert st["failed"] == 0 and st["errors"] == 0


def _two_parked(backend, tmp_path, **kw):
    """Victim A on a full disk tier, victim B filling the RAM tier: A's
    restore has no RAM to land in and nothing can spill."""
    rng = np.random.default_rng(5)
    bulk = _seqs(rng, 2, 48)
    bud = BudgetPolicy(enabled=True, ledger_bytes=BLOB + 22,
                       spill_dir=str(tmp_path), spill_bytes=FILE + 2)
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=True,
                        preempt=PreemptPolicy(enabled=True), budget=bud,
                        start=False)
    fa = eng.submit(bulk[0], cls="bulk", **kw)
    fb = eng.submit(bulk[1], cls="bulk")
    with eng._cond:
        eng._admit_locked()
    for _ in range(2):
        eng._dispatch_step()
    slot_a = next(i for i, r in enumerate(eng._slot_req)
                  if r is not None and r.x is bulk[0])
    slot_b = next(i for i, r in enumerate(eng._slot_req)
                  if r is not None and r.x is bulk[1])
    assert eng._evict_slot(slot_a, "preempt")  # first: the LRU spill
    assert eng._evict_slot(slot_b, "preempt")  # spills A, fills RAM
    st = eng.stats()
    assert st["budget"]["spills"] == 1 and st["budget"]["bytes"]["disk"]
    assert st["budget"]["bytes"]["ram"] == BLOB
    return eng, fa, fb, bulk


def test_rung2_backpressure_defers_then_rung3_deadline_sheds(backend,
                                                             tmp_path):
    eng, fa, fb, bulk = _two_parked(backend, tmp_path, max_wait_s=0.4)
    try:
        eng.start()
        with pytest.raises(ServeError, match="deadline"):
            fa.result(timeout=WAIT)
        assert np.array_equal(fb.result(timeout=WAIT),
                              pool_program(backend, bulk[1], 2))
        st = eng.stats()
    finally:
        eng.close()
    assert st["budget"]["deferred"] >= 1
    assert st["preempt"]["shed"] == 1
    assert st["budget"]["bytes"]["ram"] == st["budget"]["bytes"]["disk"] == 0
    assert os.listdir(tmp_path) == []


def test_deadline_less_deferred_head_sheds_instead_of_hanging(backend,
                                                              tmp_path):
    eng, fa, fb, bulk = _two_parked(backend, tmp_path)
    try:
        eng.start()
        with pytest.raises(ServeError, match="serve.budget.ledger_bytes"):
            fa.result(timeout=WAIT)
        assert np.array_equal(fb.result(timeout=WAIT),
                              pool_program(backend, bulk[1], 2))
        st = eng.stats()
    finally:
        eng.close()
    assert st["budget"]["shed"] == 1 and st["budget"]["deferred"] >= 1
    assert st["budget"]["bytes"]["ram"] == st["budget"]["bytes"]["disk"] == 0
    assert os.listdir(tmp_path) == []


def test_sweep_releases_dead_heap_entries_queue_bytes(backend):
    rng = np.random.default_rng(16)
    bulk = _seqs(rng, 2, 24)
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=True,
                        preempt=PreemptPolicy(enabled=True),
                        budget=BudgetPolicy(enabled=True,
                                            queue_bytes=1 << 20),
                        start=False)
    try:
        fb = mid_flight(eng, bulk, dispatches=0, max_wait_s=0.02)
        assert eng._mem.bytes("queue") == 0
        eng.submit(_seqs(rng, 1, 4)[0], cls="interactive")
        eng._preempt_for_queue()
        parked = eng._mem.bytes("queue")
        assert parked > bulk[0].nbytes
        time.sleep(0.05)
        eng.stats()  # the sweep sheds the expired victim...
        # ...and releases its heap entry's bytes now
        assert eng._mem.bytes("queue") == parked - bulk[0].nbytes
        assert sum(1 for f in fb if f.done() and f.exception()) == 1
    finally:
        eng.start()
        eng.close()


def test_rung3_queue_bytes_sheds_naming_the_budget(backend):
    seq = _seqs(np.random.default_rng(6), 1, 8)[0]  # 352 payload bytes
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=False,
                        budget=BudgetPolicy(enabled=True, queue_bytes=400),
                        start=False)
    try:
        f1 = eng.submit(seq)
        with pytest.raises(ServeError, match="serve.budget.queue_bytes"):
            eng.submit(seq)
        eng.start()
        assert np.array_equal(f1.result(timeout=WAIT),
                              pool_program(backend, seq, 2))
        st = eng.stats()
    finally:
        eng.close()
    assert st["budget"]["shed"] == 1 and st["failed"] == 0
    assert st["budget"]["bytes"]["queue"] == 0


def test_row_engine_queue_bytes_front_door():
    """The row engine shares the front door: params and queue bytes
    tracked, an oversized admission shed naming the budget."""
    model = build_mlp((8,), 1, in_features=FEAT, device="cpu")
    backend = NNBackend(model, (FEAT,), compute_dtype=torch.float32)
    rng = np.random.default_rng(7)
    rows = rng.normal(size=(4, FEAT)).astype(np.float32)
    bud = BudgetPolicy(enabled=True, queue_bytes=rows.nbytes + 8)
    with InferenceEngine(backend, buckets=(8,), warmup=False,
                         max_wait_ms=50.0, budget=bud) as eng:
        fut = eng.submit(rows)
        with pytest.raises(ServeError, match="serve.budget.queue_bytes"):
            eng.submit(rng.normal(size=(8, FEAT)).astype(np.float32))
        got = fut.result(timeout=WAIT)
        st = eng.stats()
    assert np.array_equal(got, backend.predict(rows))
    assert st["budget"]["shed"] == 1 and st["budget"]["enabled"] is True
    assert st["budget"]["bytes"]["params"] > 0
    assert st["budget"]["bytes"]["queue"] == 0


def test_healthz_load_carries_budget_figures(backend, tmp_path):
    bud = BudgetPolicy(enabled=True, ledger_bytes=4096,
                       spill_dir=str(tmp_path))
    with StepScheduler(backend, max_slots=2, step_block=2, warmup=False,
                       preempt=PreemptPolicy(enabled=True),
                       budget=bud) as eng:
        load = eng.load_desc
    assert load["ledger_bytes"] == 0 and load["spilled"] == 0

"""The port's paged slot state (serve/continuous.py ``serve.paging``)
against the JAX package's paged StepScheduler on the same traffic, and the
port's own bit pins: a paged pool — live sequences beyond its device rows,
demoted to the ledger and promoted back — replies bit-equal to a dense
pool of the same block row count, in f32 and bf16. Each behaviour mirrors
a test of tests/test_paging.py (its chaos tests wait for the port's fault
points, its /metrics and obs-top riders for its telemetry)."""

import os

import jax
import numpy as np
import pytest
import torch

from euromillioner_tpu.models.lstm import build_lstm as jax_build_lstm
from euromillioner_tpu.serve import PagingPolicy as JaxPagingPolicy
from euromillioner_tpu.serve import RecurrentBackend as JaxBackend
from euromillioner_tpu.serve import StepScheduler as JaxStepScheduler
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.serve.continuous import (PagingPolicy,
                                                      PreemptPolicy,
                                                      RecurrentBackend,
                                                      StepScheduler)
from euromillioner_tpu_torch.serve.session import BudgetPolicy
from euromillioner_tpu_torch.utils.errors import ServeError

torch.set_num_threads(2)

FEAT = 11
RTOL = 1e-5
ATOL = 1e-6
WAIT = 120
BLOB = 128  # one sequence's parked rows in the 2-layer, 8-wide f32 pool


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


def _mixed_seqs(rng, n, frac_long=0.15, short=(8, 17), long=(48, 65)):
    """The 85/15 short/long arrival mix of bench.py's serve_paged."""
    out = []
    for _ in range(n):
        lo, hi = long if rng.random() < frac_long else short
        out.append(rng.normal(size=(int(rng.integers(lo, hi)),
                                    FEAT)).astype(np.float32))
    return out


def _paged(pages=2, page_slots=4, max_live=0):
    return PagingPolicy(enabled=True, pages=pages, page_slots=page_slots,
                        max_live=max_live)


def dense_replies(backend, xs, rows):
    """The same sequences through a dense pool of ``rows`` slots."""
    with StepScheduler(backend, max_slots=rows, step_block=2,
                       warmup=False) as eng:
        return [f.result(timeout=WAIT)
                for f in [eng.submit(x, cls="bulk") for x in xs]]


def paged_run(backend, xs, **kw):
    with StepScheduler(backend, max_slots=8, step_block=2, warmup=False,
                       paging=_paged(pages=2, page_slots=4, max_live=32),
                       **kw) as eng:
        outs = [f.result(timeout=WAIT)
                for f in [eng.submit(x, cls="bulk") for x in xs]]
        return outs, eng.stats()


def test_geometry_matches_the_jax_policy():
    for args, kw, want in (((2, 4), {}, (2, 8, 32)),
                           ((0, 4), {}, (3, 12, 48)),
                           ((2, 4), {"max_live": 11}, (2, 8, 11))):
        mine = _paged(*args, **kw)
        jax_pol = JaxPagingPolicy(enabled=True, pages=args[0],
                                  page_slots=args[1], **kw)
        slots = 10 if args[0] == 0 else 8
        assert mine.geometry(slots) == jax_pol.geometry(slots) == want


@pytest.mark.parametrize("kw,match", [
    (dict(page_slots=0), "page_slots"),
    (dict(max_live=-1), "max_live"),
    (dict(pages=-1), "pages"),
])
def test_validation_rejects_bad_knobs(kw, match):
    with pytest.raises(ServeError, match=match):
        PagingPolicy(enabled=True, **kw).validate()


def test_single_row_store_and_elastic_pool_rejected(backend):
    with pytest.raises(ServeError, match="2 device rows"):
        StepScheduler(backend, max_slots=2, step_block=2, warmup=False,
                      paging=_paged(pages=1, page_slots=1))
    with pytest.raises(ServeError, match="elastic"):
        StepScheduler(backend, max_slots=4, step_block=2, warmup=False,
                      preempt=PreemptPolicy(enabled=True, elastic=True),
                      paging=_paged())


def test_disabled_policy_is_inert(backend):
    with StepScheduler(backend, max_slots=2, step_block=2,
                       warmup=False) as eng:
        assert eng.stats()["paging"] == {"enabled": False}
        assert "pages_live" not in eng.load_desc


def test_f32_bit_identical_beyond_device_rows(models):
    """24 live sequences over an 8-row store: they churn through the
    ledger and reply bit-equal to a dense 8-slot pool, and within
    tolerance of the JAX paged scheduler's replies."""
    jb, backend = models
    xs = _mixed_seqs(np.random.default_rng(5), 24)
    outs, st = paged_run(backend, xs)
    dense = dense_replies(backend, xs, 8)
    with JaxStepScheduler(jb, max_slots=8, step_block=2, warmup=False,
                          paging=JaxPagingPolicy(enabled=True, pages=2,
                                                 page_slots=4,
                                                 max_live=32)) as jeng:
        want = [f.result(timeout=WAIT)
                for f in [jeng.submit(x, cls="bulk") for x in xs]]
    for o, d, w in zip(outs, dense, want):
        assert np.array_equal(o, d)
        np.testing.assert_allclose(o, w, rtol=RTOL, atol=ATOL)
    pg = st["paging"]
    assert pg["rows"] == 8 and pg["peak_live"] > pg["rows"]
    assert pg["demoted"] > 0 and pg["promoted"] > 0
    assert pg["shed"] == 0 and st["failed"] == 0 and st["errors"] == 0
    assert pg["free_rows"] == pg["rows"] and pg["live"] == 0
    assert st["budget"]["bytes"]["ram"] == 0


def test_bf16_demote_promote_round_trip_bit_identical(backend):
    bf16 = backend.with_profile("bf16")
    xs = _mixed_seqs(np.random.default_rng(6), 16)
    outs, st = paged_run(bf16, xs)
    dense = dense_replies(bf16, xs, 8)
    for o, d in zip(outs, dense):
        assert np.array_equal(o, d)
    pg = st["paging"]
    assert pg["demoted"] > 0 and pg["promoted"] > 0
    assert pg["shed"] == 0 and st["failed"] == 0
    assert pg["free_rows"] == pg["rows"]


def test_demoted_rows_spill_and_promote_bit_identical(backend, tmp_path):
    """Under a ledger too small for the demoted rows, the coldest spill to
    disk and promote from there; replies stay bit-equal to the dense pool
    and both tiers drain."""
    xs = _mixed_seqs(np.random.default_rng(7), 20)
    bud = BudgetPolicy(enabled=True, ledger_bytes=2 * BLOB,
                       spill_dir=str(tmp_path), spill_bytes=1 << 20)
    outs, st = paged_run(backend, xs, budget=bud)
    for o, d in zip(outs, dense_replies(backend, xs, 8)):
        assert np.array_equal(o, d)
    b = st["budget"]
    assert b["spills"] >= 1 and b["spill_restored"] >= 1
    assert b["peak"]["ram"] <= 2 * BLOB
    assert b["bytes"]["ram"] == b["bytes"]["disk"] == 0
    assert b["bytes"]["pages"] == b["bytes"]["pool"] == 2 * 2 * 8 * 8 * 4
    assert os.listdir(tmp_path) == []
    assert st["failed"] == 0 and st["errors"] == 0


def test_full_live_set_preempts_by_class(backend):
    """With the live set at max_live, an interactive arrival parks the
    least urgent bulk sequence; everything replies bit-equal to the dense
    pool."""
    rng = np.random.default_rng(8)
    bulk = [rng.normal(size=(40, FEAT)).astype(np.float32)
            for _ in range(4)]
    inter = [rng.normal(size=(6, FEAT)).astype(np.float32)
             for _ in range(2)]
    eng = StepScheduler(backend, max_slots=2, step_block=2, warmup=False,
                        preempt=PreemptPolicy(enabled=True),
                        paging=_paged(pages=1, page_slots=2, max_live=4),
                        start=False)
    try:
        fb = [eng.submit(x, cls="bulk") for x in bulk]
        with eng._cond:
            eng._admit_locked()
        for _ in range(3):
            eng._dispatch_step()
        fi = [eng.submit(x, cls="interactive") for x in inter]
        eng.start()
        got = [f.result(timeout=WAIT) for f in fi + fb]
        st = eng.stats()
    finally:
        eng.close()
    for g, d in zip(got, dense_replies(backend, inter + bulk, 2)):
        assert np.array_equal(g, d)
    assert st["preempt"]["preempted"] >= 1
    assert st["failed"] == 0 and st["paging"]["live"] == 0


def test_stats_section_and_load_key(models):
    """``stats()["paging"]`` is the JAX scheduler's section, key for key
    and value for value on an idle store."""
    jb, backend = models
    with StepScheduler(backend, max_slots=4, step_block=2, warmup=False,
                       paging=_paged(pages=2, page_slots=2)) as eng:
        st = eng.stats()
        assert eng.load_desc["pages_live"] == 0
    with JaxStepScheduler(jb, max_slots=4, step_block=2, warmup=False,
                          paging=JaxPagingPolicy(enabled=True, pages=2,
                                                 page_slots=2)) as jeng:
        jst = jeng.stats()
    assert st["paging"] == jst["paging"] == {
        "enabled": True, "pages": 2, "page_slots": 2, "rows": 4,
        "free_rows": 4, "free_pages": 2, "live": 0, "max_live": 16,
        "peak_live": 0, "demoted": 0, "promoted": 0, "shed": 0}
    assert set(st["budget"]["bytes"]) == set(jst["budget"]["bytes"])

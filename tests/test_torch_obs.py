"""The port's serving telemetry (obs/metrics.py, obs/trace.py,
obs/telemetry.py, obs/top.py) and the serving fault points against the
JAX package's: the same registry operations render the same Prometheus
bytes, each engine kind registers the JAX engine's metric families and
labels and counts the same requests, completions and rows, spans are
complete and monotonic, ``/metrics`` and ``/trace`` answer over HTTP,
``obs-top`` summarises a JAX-written stream into the same lines, and each
serving fault point fails only what the JAX package's fails. Each
behaviour mirrors a test of tests/test_obs.py, tests/test_preempt.py,
tests/test_budget.py or tests/test_paging.py."""

import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from euromillioner_tpu.models.lstm import build_lstm as jax_build_lstm
from euromillioner_tpu.models.mlp import build_mlp as jax_build_mlp
from euromillioner_tpu.obs import metrics as jax_metrics
from euromillioner_tpu.obs import top as jax_top
from euromillioner_tpu.serve import InferenceEngine as JaxInferenceEngine
from euromillioner_tpu.serve import ModelSession as JaxModelSession
from euromillioner_tpu.serve import NNBackend as JaxNNBackend
from euromillioner_tpu.serve import RecurrentBackend as JaxBackend
from euromillioner_tpu.serve import StepScheduler as JaxStepScheduler
from euromillioner_tpu.serve import \
    WholeSequenceScheduler as JaxWholeSequenceScheduler
from euromillioner_tpu_torch.config import Config, apply_overrides
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.models.mlp import build_mlp
from euromillioner_tpu_torch.obs import metrics, top
from euromillioner_tpu_torch.obs.trace import (STAGES, TERMINAL_STAGE, Span,
                                               TraceBuffer)
from euromillioner_tpu_torch.resilience import FaultPlan, FaultSpec, inject
from euromillioner_tpu_torch.serve import batcher
from euromillioner_tpu_torch.serve.continuous import (PagingPolicy,
                                                      PreemptPolicy,
                                                      RecurrentBackend,
                                                      StepScheduler,
                                                      WholeSequenceScheduler)
from euromillioner_tpu_torch.serve.engine import InferenceEngine
from euromillioner_tpu_torch.serve.session import BudgetPolicy, NNBackend
from euromillioner_tpu_torch.serve.transport import make_server
from euromillioner_tpu_torch.utils.errors import ServeError

torch.set_num_threads(2)

FEAT = 11
WAIT = 60
# families of the JAX engines the port does not register: its
# ExecutableCache's counters (the port runs its programs eagerly and has
# no executable cache)
NOT_PORTED = {"serve_exec_cache"}


@pytest.fixture(scope="module")
def lstm():
    jm = jax_build_lstm(hidden=8, num_layers=2, out_dim=7, fused="off")
    params, _ = jm.init(jax.random.PRNGKey(0), (64, FEAT))
    tm = build_lstm(8, 2, 7, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params), "cpu"))
    return (JaxBackend(jm, params, feat_dim=FEAT, compute_dtype=np.float32),
            RecurrentBackend(tm, feat_dim=FEAT, compute_dtype=torch.float32))


@pytest.fixture(scope="module")
def mlp():
    jm = jax_build_mlp((16,), out_dim=1)
    params, _ = jm.init(jax.random.PRNGKey(0), (10,))
    tm = build_mlp((16,), 1, in_features=10, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params), "cpu"))
    return (JaxNNBackend(jm, params, (10,), compute_dtype=np.float32),
            NNBackend(tm, (10,), compute_dtype=torch.float32))


@pytest.fixture(scope="module")
def seqs():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(n, FEAT)).astype(np.float32)
            for n in (5, 9, 3, 12, 7, 2)]


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(1)
    return [rng.normal(size=(n, 10)).astype(np.float32) for n in (1, 3, 8)]


def results(futures):
    return [f.result(timeout=WAIT) for f in futures]


# -- the registry and its exposition ---------------------------------------

def _registry_ops(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("req_total", 'Requests with "quotes"\nand a newline',
                    ("family", "class"))
    c.labels(family="lstm", **{"class": "interactive"}).inc(3)
    c.labels(family="lstm", **{"class": 'b"ulk\\'}).inc(0.5)
    g = reg.gauge("depth", "Queue depth", ("family",))
    g.labels(family="nn").set(7)
    g.labels(family="x").set_function(lambda: 2.25)
    h = reg.histogram("lat_seconds", "Latency", ("family",))
    for v in (0.0001, 0.003, 0.003, 0.2, 5.0, 120.0):
        h.labels(family="lstm").observe(v)
    h.labels(family="nn").observe_many([0.01, 0.02])
    other = mod.MetricsRegistry()
    other.counter("req_total", 'Requests with "quotes"\nand a newline',
                  ("family", "class")).labels(
        family="gbt", **{"class": "bulk"}).inc()
    other.gauge("nan_gauge", "Special values").labels().set(float("nan"))
    return mod.render_prometheus(reg, other)


def test_same_registry_operations_render_the_same_bytes():
    got = _registry_ops(metrics)
    assert got == _registry_ops(jax_metrics)
    assert got.count("# TYPE req_total counter") == 1
    assert metrics.LATENCY_BUCKETS == jax_metrics.LATENCY_BUCKETS


def test_percentile_is_the_one_definition():
    assert batcher.percentile is metrics.percentile
    vals = sorted(np.random.default_rng(2).random(37).tolist())
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert metrics.percentile(vals, q) == jax_metrics.percentile(vals, q)
    assert metrics.percentile([], 0.5) == 0.0


def test_spans_stamp_first_wins_and_the_ring_bounds():
    span = Span(1, "bulk")
    for stage in STAGES:
        span.stamp(stage)
    span.stamp("admit", 1e12)  # first wins
    assert span.complete and span.monotonic_ok()
    assert [s for s, _ in span.stages] == list(STAGES)
    assert span.stages[-1][0] == TERMINAL_STAGE
    ring = TraceBuffer(2)
    for i in range(5):
        ring.push(Span(i, "x", (("admit", 0.0), ("reply", 1.0))))
    assert ring.pushed == 5 and ring.dropped == 3 and len(ring) == 2
    assert [d["trace_id"] for d in ring.last(9)] == [3, 4]
    assert ring.last(0) == []


# -- engine telemetry against the JAX engines -------------------------------

def _surface(telemetry):
    """(sample name, label names) pairs of an engine's own registry."""
    fams = top.parse_prometheus(metrics.render_prometheus(
        telemetry.registry))
    return {(name, frozenset(lab)) for name, samples in fams.items()
            for lab, _v in samples
            if not any(name.startswith(n) for n in NOT_PORTED)}, fams


def _counts(fams):
    return {name: sum(v for _l, v in fams.get(name, ()))
            for name in ("serve_requests_total",
                         "serve_requests_completed_total",
                         "serve_rows_total", "serve_requests_failed_total")}


def _engines(kind, lstm, mlp):
    jb, pb = lstm if kind != "rows" else mlp
    if kind == "step":
        return (JaxStepScheduler(jb, max_slots=2, step_block=2,
                                 warmup=False, slo_ms=(50, 2000)),
                StepScheduler(pb, max_slots=2, step_block=2, warmup=False,
                              slo_ms=(50, 2000)))
    if kind == "whole":
        return (JaxWholeSequenceScheduler(jb, slo_ms=(50, 2000)),
                WholeSequenceScheduler(pb, slo_ms=(50, 2000)))
    return (JaxInferenceEngine(JaxModelSession(jb), buckets=(8,),
                               warmup=False, slo_ms=(50, 2000)),
            InferenceEngine(pb, buckets=(8,), warmup=False,
                            slo_ms=(50, 2000)))


@pytest.mark.parametrize("kind", ["step", "whole", "rows"])
def test_families_labels_and_counts_are_the_jax_engines(kind, lstm, mlp,
                                                       seqs, rows):
    payloads = rows if kind == "rows" else seqs
    got = {}
    for side, eng in zip(("jax", "port"), _engines(kind, lstm, mlp)):
        try:
            results([eng.submit(x, cls=("interactive", "bulk")[i % 2])
                     for i, x in enumerate(payloads)])
            got[side] = _surface(eng.telemetry)
            got[side + "_slo"] = eng.telemetry.attainment()
        finally:
            eng.close()
    (jsurf, jfams), (psurf, pfams) = got["jax"], got["port"]
    assert psurf == jsurf
    assert _counts(pfams) == _counts(jfams)
    assert _counts(pfams)["serve_requests_completed_total"] == len(payloads)
    assert set(got["port_slo"]) == set(got["jax_slo"])


def test_spans_are_complete_and_monotonic_for_every_engine(lstm, mlp, seqs,
                                                           rows):
    for kind in ("step", "whole", "rows"):
        eng = _engines(kind, lstm, mlp)[1]
        payloads = rows if kind == "rows" else seqs
        try:
            results([eng.submit(x) for x in payloads])
            spans = list(eng.telemetry.trace._ring)
        finally:
            eng.close()
        assert len(spans) == len(payloads), kind
        for span in spans:
            names = [s for s, _ in span.stages]
            assert span.complete and span.monotonic_ok(), (kind, names)
            assert names == [s for s in STAGES if s in names], kind
            assert {"admit", "dispatch", "compute", "readback",
                    "reply"} <= set(names), (kind, names)


def test_telemetry_off_replies_bit_equal_and_records_no_spans(lstm, seqs):
    _, pb = lstm
    out = {}
    for enabled in (True, False):
        with StepScheduler(pb, max_slots=2, step_block=2, warmup=False,
                           obs_enabled=enabled, slo_ms=(50, 2000)) as eng:
            out[enabled] = results([eng.submit(x) for x in seqs])
            spans = eng.telemetry.trace.pushed
        assert spans == (len(seqs) if enabled else 0)
    assert all(np.array_equal(a, b) for a, b in zip(out[True], out[False]))


def test_slo_ms_longer_than_the_classes_is_loud(lstm):
    with pytest.raises(ValueError, match="at most one deadline per class"):
        StepScheduler(lstm[1], max_slots=2, warmup=False,
                      slo_ms=(1, 2, 3))


def test_serve_obs_overrides_parse_as_the_jax_cli():
    from euromillioner_tpu.config import Config as JaxConfig
    from euromillioner_tpu.config import \
        apply_overrides as jax_apply_overrides

    ov = ["serve.obs.enabled=false", "serve.obs.slo_ms=50,2000",
          "serve.obs.trace_buffer=64", "serve.obs.capture_path=c.jsonl",
          "serve.metrics_jsonl=m.jsonl"]
    got = apply_overrides(Config(), ov).serve
    want = jax_apply_overrides(JaxConfig(), ov).serve
    for key in ("enabled", "slo_ms", "trace_buffer", "capture_path"):
        assert getattr(got.obs, key) == getattr(want.obs, key), key
    assert got.metrics_jsonl == want.metrics_jsonl


# -- /metrics, /trace and obs-top over HTTP ----------------------------------

def test_metrics_trace_and_obs_top_over_http(lstm, seqs):
    eng = StepScheduler(lstm[1], max_slots=4, step_block=2, warmup=False)
    server = make_server(eng, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        results([eng.submit(x) for x in seqs])
        with urllib.request.urlopen(url + "/metrics", timeout=WAIT) as r:
            assert r.headers["Content-Type"] == "text/plain; version=0.0.4"
            fams = top.parse_prometheus(r.read().decode())
        with urllib.request.urlopen(url + "/stats", timeout=WAIT) as r:
            st = json.loads(r.read())
        with urllib.request.urlopen(url + "/trace?n=4", timeout=WAIT) as r:
            tr = json.loads(r.read())
        lines: list[str] = []
        assert top.run_url(url, iterations=1, out=lines.append) == 0
    finally:
        server.shutdown()
        server.server_close()
        eng.close()
    assert _counts(fams)["serve_requests_total"] == len(seqs)
    assert (_counts(fams)["serve_requests_completed_total"]
            == st["sequences"] == len(seqs))
    assert len(tr["spans"]) == 4 and tr["recorded"] == len(seqs)
    for span in tr["spans"]:
        offsets = list(span["stages"].values())
        assert list(span["stages"]) == [s for s in STAGES
                                        if s in span["stages"]]
        assert offsets == sorted(offsets) and "reply" in span["stages"]
    assert len(lines) == 1 and "rps=" in lines[0]


def test_obs_top_summarises_a_jax_written_stream_to_the_same_lines(
        tmp_path, lstm, seqs):
    path = str(tmp_path / "jax.jsonl")
    with JaxStepScheduler(lstm[0], max_slots=2, step_block=2, warmup=False,
                          metrics_jsonl=path) as eng:
        results([eng.submit(x) for x in seqs])
    got, want = [], []
    assert top.run_jsonl(path, out=got.append) == 0
    assert jax_top.run_jsonl(path, out=want.append) == 0
    assert got == want and got


def test_port_jsonl_stream_and_emitter_disable_once(tmp_path, lstm, seqs,
                                                    caplog):
    path = str(tmp_path / "port.jsonl")
    with StepScheduler(lstm[1], max_slots=2, step_block=2, warmup=False,
                       metrics_jsonl=path) as eng:
        results([eng.submit(x) for x in seqs])
    events = {json.loads(ln)["event"] for ln in open(path)}
    assert {"step", "readback"} <= events
    lines: list[str] = []
    assert top.run_jsonl(path, out=lines.append) == 0 and lines
    plan = FaultPlan([FaultSpec("serve.trace", raises=OSError)])
    with inject(plan):
        with StepScheduler(lstm[1], max_slots=2, step_block=2,
                           warmup=False,
                           metrics_jsonl=str(tmp_path / "dead.jsonl")) as eng:
            got = results([eng.submit(x) for x in seqs])
            assert eng._jsonl is None  # the sink disabled itself
            st = eng.stats()
    assert st["failed"] == 0 and plan.fired_count("serve.trace") >= 1
    with StepScheduler(lstm[1], max_slots=2, step_block=2,
                       warmup=False) as eng:
        want = results([eng.submit(x) for x in seqs])
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


# -- the serving fault points -----------------------------------------------

def _outcomes(futures, want):
    out = []
    for f, w in zip(futures, want):
        try:
            out.append(np.array_equal(f.result(timeout=WAIT), w))
        except (RuntimeError, OSError, ServeError) as e:
            assert "injected fault" in str(e) or "shed" in str(e), e
            out.append("faulted")
    return out


def _direct(backend, xs, rows=2):
    with StepScheduler(backend, max_slots=rows, step_block=2,
                       warmup=False) as eng:
        return results([eng.submit(x) for x in xs])


def test_request_and_dispatch_faults_fail_only_their_requests(mlp, rows):
    _, pb = mlp
    plan = FaultPlan([FaultSpec("serve.request", raises=RuntimeError,
                                hits=(2,)),
                      FaultSpec("serve.dispatch", raises=RuntimeError,
                                hits=(1,))])
    with inject(plan):
        with InferenceEngine(pb, buckets=(8,), warmup=False) as eng:
            first = eng.submit(rows[0])
            with pytest.raises(RuntimeError, match="serve.request"):
                eng.submit(rows[1])
            with pytest.raises(RuntimeError, match="serve.dispatch"):
                first.result(timeout=WAIT)
            got = eng.predict(rows[2])
            st = eng.stats()
    assert np.array_equal(got, pb.predict(rows[2]))
    assert st["errors"] == 1 and st["requests"] == 1


@pytest.mark.parametrize("point", ["serve.admit", "serve.step"])
def test_admit_and_step_faults_fail_only_the_slot_holders(lstm, seqs,
                                                          point):
    _, pb = lstm
    want = _direct(pb, seqs)
    plan = FaultPlan([FaultSpec(point, raises=RuntimeError, hits=(1,))])
    with inject(plan):
        eng = StepScheduler(pb, max_slots=2, step_block=2, warmup=False,
                            start=False)
        try:
            futures = [eng.submit(x) for x in seqs]
            eng.start()
            out = _outcomes(futures, want)
            again = eng.predict(seqs[0])
            st = eng.stats()
        finally:
            eng.close()
    lost = 1 if point == "serve.admit" else 2  # admission: one; step: both
    assert plan.fired_count(point) == 1
    assert out.count("faulted") == lost and out.count(True) == len(seqs) - lost
    assert np.array_equal(again, want[0])
    assert st["failed"] == lost and st["active"] == 0


def test_budget_faults_reject_only_the_submit(lstm, mlp, seqs, rows):
    bud = BudgetPolicy(enabled=True)
    plan = FaultPlan([FaultSpec("serve.budget", raises=ServeError,
                                hits=(1, 3))])
    with inject(plan):
        with StepScheduler(lstm[1], max_slots=2, step_block=2, warmup=False,
                           budget=bud) as eng:
            with pytest.raises(ServeError, match="serve.budget"):
                eng.submit(seqs[0])
            ok = eng.predict(seqs[0])
        with InferenceEngine(mlp[1], buckets=(8,), warmup=False,
                             budget=bud) as reng:
            with pytest.raises(ServeError, match="serve.budget"):
                reng.submit(rows[0])
            rok = reng.predict(rows[0])
    assert np.array_equal(ok, _direct(lstm[1], seqs[:1])[0])
    assert np.array_equal(rok, _row_replies(mlp[1], rows[:1])[0])
    assert plan.fired_count("serve.budget") == 2


def _row_replies(backend, xs):
    """Fault-free replies of a row engine at the tests' bucket."""
    with InferenceEngine(backend, buckets=(8,), warmup=False) as eng:
        return [eng.predict(x) for x in xs]


def _mid_flight(eng, xs, dispatches=4):
    futures = [eng.submit(x, cls="bulk") for x in xs]
    with eng._cond:
        eng._admit_locked()
    for _ in range(dispatches):
        eng._dispatch_step()
    return futures


def test_preempt_fault_loses_only_the_victim(lstm):
    _, pb = lstm
    rng = np.random.default_rng(9)
    bulk = [rng.normal(size=(48, FEAT)).astype(np.float32) for _ in range(2)]
    inter = rng.normal(size=(4, FEAT)).astype(np.float32)
    want = _direct(pb, bulk + [inter])
    plan = FaultPlan([FaultSpec("serve.preempt", raises=RuntimeError,
                                hits=(1,))])
    with inject(plan):
        eng = StepScheduler(pb, max_slots=2, step_block=2, warmup=False,
                            preempt=PreemptPolicy(enabled=True),
                            start=False)
        try:
            fb = _mid_flight(eng, bulk)
            fi = eng.submit(inter, cls="interactive")
            eng.start()
            assert np.array_equal(fi.result(timeout=WAIT), want[2])
            out = _outcomes(fb, want[:2])
            st = eng.stats()
        finally:
            eng.close()
    assert plan.fired_count("serve.preempt") == 1
    assert out.count("faulted") == 1 and out.count(True) == 1
    assert st["failed"] == 1 and st["preempt"]["evicted_depth"] == 0


def test_resize_fault_aborts_only_that_resize(lstm, seqs):
    _, pb = lstm
    pol = PreemptPolicy(enabled=True, elastic=True, min_slots=2,
                        grow_load=99.0, shrink_load=-1.0,
                        resize_hysteresis=1)
    plan = FaultPlan([FaultSpec("serve.resize", raises=RuntimeError,
                                hits=(1,))])
    with inject(plan):
        eng = StepScheduler(pb, max_slots=4, step_block=2, warmup=False,
                            preempt=pol, start=False)
        try:
            eng.request_resize(4)
            eng._maybe_resize()
            assert eng.pool_slots == 2  # the faulted resize changed nothing
            eng.request_resize(4)
            eng._maybe_resize()
            assert eng.pool_slots == 4
            eng.start()
            got = results([eng.submit(x) for x in seqs])
            st = eng.stats()
        finally:
            eng.close()
    assert plan.fired_count("serve.resize") == 1
    assert st["preempt"]["resizes"] == 1 and st["failed"] == 0
    assert all(np.array_equal(g, w)
               for g, w in zip(got, _direct(pb, seqs, rows=4)))


def test_spill_fault_loses_only_that_victim(lstm, tmp_path):
    _, pb = lstm
    rng = np.random.default_rng(3)
    bulk = [rng.normal(size=(48, FEAT)).astype(np.float32) for _ in range(2)]
    inter = [rng.normal(size=(4, FEAT)).astype(np.float32) for _ in range(2)]
    want = _direct(pb, bulk + inter)
    plan = FaultPlan([FaultSpec("serve.spill", raises=OSError, hits=(1,))])
    with inject(plan):
        eng = StepScheduler(pb, max_slots=2, step_block=2, warmup=False,
                            preempt=PreemptPolicy(enabled=True),
                            budget=BudgetPolicy(enabled=True,
                                                ledger_bytes=160,
                                                spill_dir=str(tmp_path),
                                                spill_bytes=1 << 20),
                            start=False)
        try:
            fb = _mid_flight(eng, bulk)
            fi = [eng.submit(x, cls="interactive") for x in inter]
            eng.start()
            assert all(np.array_equal(g, w)
                       for g, w in zip(results(fi), want[2:]))
            out = _outcomes(fb, want[:2])
            st = eng.stats()
        finally:
            eng.close()
    assert plan.fired_count("serve.spill") == 1
    assert out.count("faulted") == 1 and out.count(True) == 1
    assert st["failed"] == 1 and os.listdir(tmp_path) == []


def test_page_fault_sheds_only_that_promotion(lstm):
    _, pb = lstm
    rng = np.random.default_rng(5)
    xs = [rng.normal(size=(int(n), FEAT)).astype(np.float32)
          for n in rng.integers(6, 20, size=12)]
    want = _direct(pb, xs, rows=4)
    plan = FaultPlan([FaultSpec("serve.page", raises=RuntimeError,
                                hits=(1,))])
    with inject(plan):
        with StepScheduler(pb, max_slots=4, step_block=2, warmup=False,
                           paging=PagingPolicy(enabled=True, pages=2,
                                               page_slots=2,
                                               max_live=12)) as eng:
            out = _outcomes([eng.submit(x, cls="bulk") for x in xs], want)
            st = eng.stats()
    assert plan.fired_count("serve.page") == 1
    assert out.count("faulted") == 1 and out.count(True) == len(xs) - 1
    assert st["paging"]["shed"] == 1 and st["paging"]["live"] == 0
    assert st["paging"]["free_rows"] == st["paging"]["rows"]


def test_trace_fault_storm_leaves_replies_bit_identical(mlp, rows):
    _, pb = mlp
    plan = FaultPlan([FaultSpec("serve.trace", raises=RuntimeError,
                                probability=0.5)], seed=1)
    with inject(plan):
        with InferenceEngine(pb, buckets=(8,), warmup=False) as eng:
            got = [eng.predict(x) for x in rows]
            st = eng.stats()
    assert all(np.array_equal(g, w)
               for g, w in zip(got, _row_replies(pb, rows)))
    assert st["errors"] == 0 and plan.fired_count("serve.trace") >= 1

"""The port's resilience layer (resilience/inject.py, utils/retry.py,
data/fetch.py, the stale-cache pipeline, the fault points of training,
checkpoints and the supervisor, and the serve.quant fallback) against the
JAX package's on the same inputs. Each behaviour mirrors a test of
tests/test_chaos.py, tests/test_serve_quant.py or tests/test_serve_fast.py.
Every fetch goes to a stub server on localhost or fails at its fault point
before a socket is opened."""

import glob
import http.server
import logging
import os
import pathlib
import re
import threading
import time

import jax
import numpy as np
import pytest
import torch

from euromillioner_tpu.core.precision import PARITY as JAX_PARITY
from euromillioner_tpu.data.fetch import fetch_url as jax_fetch_url
from euromillioner_tpu.data.pipeline import \
    pipeline_from_url as jax_pipeline_from_url
from euromillioner_tpu.models.mlp import build_mlp as jax_build_mlp
from euromillioner_tpu.resilience import FaultPlan as JaxFaultPlan
from euromillioner_tpu.resilience import FaultSpec as JaxFaultSpec
from euromillioner_tpu.resilience import fault_point as jax_fault_point
from euromillioner_tpu.resilience import inject as jax_inject
from euromillioner_tpu.train import optim as jax_optim
from euromillioner_tpu.train.trainer import Trainer as JaxTrainer
from euromillioner_tpu.utils.errors import FetchError as JaxFetchError
from euromillioner_tpu.utils.retry import RetryPolicy as JaxRetryPolicy
from euromillioner_tpu.utils.retry import \
    retry_with_backoff as jax_retry_with_backoff
from euromillioner_tpu_torch.config import DataConfig
from euromillioner_tpu_torch.core.precision import PARITY
from euromillioner_tpu_torch.data.fetch import fetch_url
from euromillioner_tpu_torch.data.pipeline import (draws_from_html,
                                                   pipeline_from_html,
                                                   pipeline_from_url,
                                                   write_cache)
from euromillioner_tpu_torch.dist.failure import (Heartbeat,
                                                  run_with_restart,
                                                  stale_processes)
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.models.mlp import build_mlp
from euromillioner_tpu_torch.resilience import (FaultPlan, FaultSpec,
                                                active_plan, fault_point,
                                                inject)
from euromillioner_tpu_torch.serve import continuous
from euromillioner_tpu_torch.serve.continuous import (RecurrentBackend,
                                                      StepScheduler)
from euromillioner_tpu_torch.serve.engine import InferenceEngine
from euromillioner_tpu_torch.serve.session import NNBackend
from euromillioner_tpu_torch.train import optim
from euromillioner_tpu_torch.train.checkpoint import (checkpoint_step,
                                                      latest_checkpoint,
                                                      load_checkpoint,
                                                      load_train_state,
                                                      save_checkpoint,
                                                      verify_checkpoint)
from euromillioner_tpu_torch.train.trainer import Trainer
from euromillioner_tpu_torch.utils import serialization
from euromillioner_tpu_torch.utils.errors import (CheckpointError,
                                                  FetchError, TrainError)
from euromillioner_tpu_torch.utils.retry import (RetryPolicy,
                                                 retry_with_backoff)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "euromillions.html"
# a localhost URL nothing listens on: a plan that fails to fire could
# only be refused, never leave the machine
NOWHERE = "http://127.0.0.1:9/results"
FAST = dict(max_attempts=3, base_delay_s=0.0, max_delay_s=0.0,
            pre_jitter_s=0.0)
FAST_RETRY = RetryPolicy(**FAST)
# port vs JAX, f32 on both sides: the pin of tests/test_torch_train.py and
# tests/test_torch_mlp.py (the JAX package's NN trajectory pin)
RTOL, ATOL = 1e-5, 1e-6
EPOCHS, BATCH = 4, 256
WAIT = 60


@pytest.fixture(scope="module")
def golden_html():
    return GOLDEN.read_text(encoding="utf-8")


# -- the fault-injection engine ----------------------------------------------

def _fired(plan_cls, spec_cls, inject_fn, point_fn, specs, seed):
    """``(point, hit)`` pairs one package's plan fires over a fixed visit
    sequence of two points, with every raise swallowed."""
    plan = plan_cls([spec_cls(**s) for s in specs], seed=seed)
    with inject_fn(plan):
        for i in range(40):
            for name in ("a.point", "b.point"):
                if name == "b.point" and i % 3:
                    continue
                try:
                    point_fn(name, i=i)
                except RuntimeError:
                    pass
    return plan.fired


@pytest.mark.parametrize("specs,seed", [
    ([{"point": "a.point", "raises": RuntimeError, "hits": (2, 5, 9)}], 0),
    ([{"point": "a.point", "raises": RuntimeError, "times": 3}], 0),
    ([{"point": "a.point", "raises": RuntimeError, "probability": 0.3},
      {"point": "b.point", "raises": RuntimeError, "probability": 0.5,
       "times": 4}], 7),
    ([{"point": "b.point", "action": lambda ctx: None, "hits": (1, 2)},
      {"point": "a.point", "raises": RuntimeError, "probability": 0.1}], 3),
], ids=["hits", "times", "seeded_storm", "action_then_storm"])
def test_plan_fires_at_the_jax_packages_ordinals(specs, seed):
    got = _fired(FaultPlan, FaultSpec, inject, fault_point, specs, seed)
    want = _fired(JaxFaultPlan, JaxFaultSpec, jax_inject, jax_fault_point,
                  specs, seed)
    assert got == want and got


def test_disabled_points_are_inert_and_plans_do_not_nest():
    assert active_plan() is None
    fault_point("anything", x=1)  # no plan: a no-op
    plan = FaultPlan([FaultSpec("p", raises=ValueError)])
    with inject(plan):
        with pytest.raises(RuntimeError, match="do not nest"):
            with inject(FaultPlan([])):
                pass
        with pytest.raises(ValueError, match="injected fault at p"):
            fault_point("p")
    assert active_plan() is None and plan.fired == [("p", 1)]


def test_action_gets_the_context_and_fires_count_in_the_registry():
    from euromillioner_tpu_torch.obs.metrics import global_registry
    from euromillioner_tpu_torch.obs.top import parse_prometheus
    from euromillioner_tpu_torch.obs.metrics import render_prometheus

    seen = []
    plan = FaultPlan([FaultSpec("ctx.point", action=seen.append)])
    with inject(plan):
        fault_point("ctx.point", path="/x", step=3)
    assert seen == [{"path": "/x", "step": 3}]
    fams = parse_prometheus(render_prometheus(global_registry()))
    fired = {lab["point"]: v for lab, v
             in fams["resilience_faults_fired_total"]}
    assert fired["ctx.point"] >= 1


# -- retry ------------------------------------------------------------------

def _retry_calls(retry_fn, policy, exc_cls, statuses):
    calls = []

    def flaky():
        calls.append(1)
        st = statuses[len(calls) - 1]
        if st:
            raise exc_cls(f"status {st}", status=st)
        return "ok"

    try:
        out = retry_fn(flaky, policy=policy, retry_on=(),
                       retry_if=lambda e: e.status >= 500,
                       sleep=lambda s: None, description="op")
    except exc_cls as e:
        out = f"raised {e.status}"
    return out, len(calls)


@pytest.mark.parametrize("statuses", [(503, 503, 0), (404, 0, 0),
                                      (500, 502, 503)],
                         ids=["recovers", "permanent", "exhausts"])
def test_retry_predicate_matches_jax(statuses):
    got = _retry_calls(retry_with_backoff, FAST_RETRY, FetchError, statuses)
    want = _retry_calls(jax_retry_with_backoff, JaxRetryPolicy(**FAST),
                        JaxFetchError, statuses)
    assert got == want


def test_giveup_line_is_the_jax_packages(caplog):
    msgs = {}
    for name, fn, pol in (("euromillioner_tpu_torch", retry_with_backoff,
                           FAST_RETRY),
                          ("euromillioner_tpu", jax_retry_with_backoff,
                           JaxRetryPolicy(**FAST))):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=name):
            with pytest.raises(ValueError):
                fn(lambda: (_ for _ in ()).throw(ValueError("boom")),
                   policy=pol, sleep=lambda s: None,
                   description="doomed op")
        msgs[name] = [r.getMessage() for r in caplog.records
                      if r.name.startswith(name + ".")]
    assert msgs["euromillioner_tpu_torch"] == msgs["euromillioner_tpu"]
    assert msgs["euromillioner_tpu"][-1] == (
        "doomed op failed after 3 attempt(s) (ValueError: boom) — giving up")


# -- fetch against a localhost stub ----------------------------------------

class _Stub(http.server.BaseHTTPRequestHandler):
    script: list  # status codes to answer, in order; the last repeats
    body: bytes = b""
    hits: list

    def do_GET(self):  # noqa: N802 — http.server API
        self.hits.append(self.path)
        status = self.script[min(len(self.hits), len(self.script)) - 1]
        body = self.body if status == 200 else b"no"
        self.send_response(status)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture
def stub(golden_html):
    """``start(script)`` → the URL of a localhost server answering each GET
    with the next status of ``script`` (200 carries the golden page)."""
    servers = []

    def start(script):
        handler = type("H", (_Stub,), {"script": list(script),
                                       "body": golden_html.encode(),
                                       "hits": []})
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return f"http://127.0.0.1:{srv.server_address[1]}/page", handler.hits

    try:
        yield start
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()


def test_fetch_retries_a_503_then_reads_the_page(stub, golden_html, caplog):
    url, hits = stub([503, 200])
    with caplog.at_level(logging.WARNING, logger="euromillioner_tpu_torch"):
        got = fetch_url(url, policy=FAST_RETRY, timeout_s=10)
    assert got == golden_html and len(hits) == 2
    assert sum("retrying" in r.getMessage() for r in caplog.records) == 1
    url2, hits2 = stub([503, 200])
    assert jax_fetch_url(url2, policy=JaxRetryPolicy(**FAST),
                         timeout_s=10) == got
    assert len(hits2) == 2


def test_fetch_permanent_404_fails_fast(stub):
    url, hits = stub([404])
    with pytest.raises(FetchError) as ei:
        fetch_url(url, policy=FAST_RETRY, timeout_s=10)
    assert ei.value.status == 404 and len(hits) == 1


def test_mid_body_failure_is_a_retryable_fetch_error(monkeypatch):
    import urllib.request

    from euromillioner_tpu_torch.data.fetch import is_retryable_fetch_error

    class Resp:
        status = 200
        headers = type("H", (), {"get_content_charset": lambda self: None})()

        def read(self):
            raise ConnectionResetError("peer reset mid-body")

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(urllib.request, "urlopen", lambda *a, **k: Resp())
    with pytest.raises(FetchError, match="Could not read response") as ei:
        fetch_url(NOWHERE, policy=FAST_RETRY)
    assert ei.value.status is None and is_retryable_fetch_error(ei.value)


# -- the stale-cache pipeline ----------------------------------------------

def _storm(spec_cls, err_cls):
    return spec_cls("fetch.request",
                    raises=lambda: err_cls("injected 503", status=503))


def test_stale_cache_serves_data_bit_identical(tmp_path, golden_html):
    cfg = DataConfig(url=NOWHERE)
    cache = str(tmp_path / "draws.csv")
    write_cache(cache, draws_from_html(golden_html, cfg))
    plan = FaultPlan([_storm(FaultSpec, FetchError)])
    with inject(plan):
        tr, va = pipeline_from_url(cfg, cache_path=cache, policy=FAST_RETRY)
    assert plan.fired_count("fetch.request") == FAST_RETRY.max_attempts
    ref_tr, ref_va = pipeline_from_html(golden_html, cfg)
    for a, b in ((tr, ref_tr), (va, ref_va)):
        assert np.array_equal(a.x, b.x) and np.array_equal(a.y, b.y)
    # the JAX package serves the port's cache file to the same rows
    from euromillioner_tpu.config import DataConfig as JaxDataConfig

    jplan = JaxFaultPlan([_storm(JaxFaultSpec, JaxFetchError)])
    with jax_inject(jplan):
        jtr, jva = jax_pipeline_from_url(JaxDataConfig(url=NOWHERE),
                                         cache_path=cache,
                                         policy=JaxRetryPolicy(**FAST))
    assert np.array_equal(np.asarray(jtr.x), tr.x)
    assert np.array_equal(np.asarray(jva.y), va.y)


def test_permanent_4xx_bypasses_the_cache(tmp_path, golden_html, stub):
    cache = str(tmp_path / "draws.csv")
    write_cache(cache, draws_from_html(golden_html))
    url, _ = stub([403])
    with pytest.raises(FetchError) as ei:
        pipeline_from_url(DataConfig(url=url), cache_path=cache,
                          policy=FAST_RETRY)
    assert ei.value.status == 403


def test_a_fetch_refreshes_the_cache_and_a_cache_write_fault_is_harmless(
        tmp_path, golden_html, stub):
    url, _ = stub([200])
    cache = str(tmp_path / "draws.csv")
    plan = FaultPlan([FaultSpec("pipeline.cache_write", raises=OSError,
                                hits=(1,))])
    with inject(plan):
        tr, _ = pipeline_from_url(DataConfig(url=url), cache_path=cache,
                                  policy=FAST_RETRY)
    assert plan.fired_count("pipeline.cache_write") == 1
    assert not os.path.exists(cache)
    tr2, _ = pipeline_from_url(DataConfig(url=url), cache_path=cache,
                               policy=FAST_RETRY)
    assert os.path.exists(cache) and np.array_equal(tr.x, tr2.x)


def test_no_cache_and_an_entry_fault_propagate(tmp_path):
    with inject(FaultPlan([_storm(FaultSpec, FetchError)])):
        with pytest.raises(FetchError, match="injected 503"):
            pipeline_from_url(DataConfig(url=NOWHERE),
                              cache_path=str(tmp_path / "none.csv"),
                              policy=FAST_RETRY)
    plan = FaultPlan([FaultSpec("pipeline.from_url", raises=FetchError)])
    with inject(plan):
        with pytest.raises(FetchError, match="pipeline.from_url"):
            pipeline_from_url(DataConfig(url=NOWHERE))


# -- checkpoint integrity ---------------------------------------------------

def _toy():
    return {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}


def _arrays_file(ckpt: str) -> str:
    (path,) = glob.glob(os.path.join(ckpt, "arrays-*.emt"))
    return path


def _truncate_arrays(ckpt: str) -> None:
    path = _arrays_file(ckpt)
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)


def _swap_arrays(ckpt: str) -> None:
    path = _arrays_file(ckpt)
    arrays = serialization.load(path)
    serialization.save(path, {k: np.asarray(v) + 1.0
                              for k, v in arrays.items()})


@pytest.mark.parametrize("damage", [
    _truncate_arrays,
    lambda ck: os.remove(os.path.join(ck, "manifest.json")),
    _swap_arrays,
], ids=["truncated", "missing_manifest", "checksum_mismatch"])
def test_a_damaged_newest_checkpoint_falls_back_to_the_previous(tmp_path,
                                                                damage):
    d = str(tmp_path)
    save_checkpoint(d, _toy(), step=1)
    newest = save_checkpoint(d, _toy(), step=2)
    damage(newest)
    assert not verify_checkpoint(newest)
    assert latest_checkpoint(d).endswith("step_00000001")
    with pytest.raises(CheckpointError):
        load_checkpoint(newest)


def test_save_write_fault_keeps_the_previous_and_load_fault_surfaces(
        tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, _toy(), step=1)
    plan = FaultPlan([FaultSpec("checkpoint.save.write", raises=OSError,
                                hits=(1,)),
                      FaultSpec("checkpoint.load", raises=CheckpointError,
                                hits=(1,))])
    with inject(plan):
        with pytest.raises(OSError):
            save_checkpoint(d, _toy(), step=2)
        ck = latest_checkpoint(d)
        assert ck.endswith("step_00000001") and checkpoint_step(ck) == 1
        with pytest.raises(CheckpointError, match="checkpoint.load"):
            load_checkpoint(ck)
        got = load_checkpoint(ck)  # the retry reads it
    assert torch.equal(got["w"], _toy()["w"])
    assert plan.fired == [("checkpoint.save.write", 1),
                          ("checkpoint.load", 1)]


# -- heartbeat and supervisor ---------------------------------------------

def test_heartbeat_oserror_does_not_kill_the_loop(tmp_path, caplog):
    plan = FaultPlan([FaultSpec("heartbeat.beat",
                                raises=OSError("injected disk full"),
                                hits=(2, 3))])
    hb = Heartbeat(str(tmp_path), "p0", interval_s=0.02)
    with caplog.at_level(logging.WARNING, logger="euromillioner_tpu_torch"):
        with inject(plan), hb:
            deadline = time.time() + 10.0
            while plan.visits["heartbeat.beat"] < 6:
                assert time.time() < deadline, "heartbeat loop died"
                time.sleep(0.01)
            assert hb._thread.is_alive()
    assert plan.fired_count("heartbeat.beat") == 2
    assert any("retrying next interval" in r.getMessage()
               for r in caplog.records)
    assert stale_processes(str(tmp_path), timeout_s=60.0) == []


def test_supervisor_attempt_fault_restarts():
    plan = FaultPlan([FaultSpec("supervisor.attempt", raises=TrainError,
                                hits=(1,))])
    with inject(plan):
        out = run_with_restart(lambda attempt: attempt, max_restarts=2,
                               backoff_s=0.0)
    assert out == 1 and plan.fired_count("supervisor.attempt") == 1


# -- the chaos run: faulted training equals fault-free, bit for bit --------

@pytest.fixture(scope="module")
def jax_init():
    model = jax_build_mlp((16,), out_dim=1)
    params, _ = model.init(jax.random.PRNGKey(0), (10,))
    return jax.device_get(params)


def _port_run(tr, ckpt_dir, jparams, resume=False):
    trainer = Trainer(build_mlp((16,), 1, device="cpu"), optim.adam(1e-2),
                      loss="mse", precision=PARITY)
    state = trainer.init_state(params_from_jax(jparams, "cpu"))
    start = 0
    if resume:
        ck = latest_checkpoint(ckpt_dir)
        if ck is not None:
            state = load_train_state(ck, state)
            start = checkpoint_step(ck)
    state = trainer.fit(state, tr, epochs=EPOCHS, batch_size=BATCH,
                        shuffle=False, seed=7, checkpoint_dir=ckpt_dir,
                        checkpoint_every=1, start_epoch=start)
    return trainer, state


def test_faulted_run_is_bit_identical_to_the_fault_free_run(
        tmp_path, golden_html, jax_init):
    """A fetch storm served from the stale cache, the second checkpoint
    truncated right after its rename, and a crash mid-epoch 2 restarted
    by the supervisor: the final eval metrics and params equal the
    fault-free run's bitwise, and the params are within the NN pin of the
    JAX package's fault-free run."""
    cfg = DataConfig(url=NOWHERE)
    cache = str(tmp_path / "draws.csv")
    write_cache(cache, draws_from_html(golden_html, cfg))
    ref_tr, ref_va = pipeline_from_html(golden_html, cfg)
    ref_trainer, ref_state = _port_run(ref_tr, str(tmp_path / "ref"),
                                       jax_init)
    steps = -(-len(ref_tr) // BATCH)
    plan = FaultPlan([
        _storm(FaultSpec, FetchError),
        FaultSpec("checkpoint.save.post", hits=(2,),
                  action=lambda ctx: _truncate_arrays(ctx["path"])),
        FaultSpec("train.step", hits=(2 * steps + 2,),
                  raises=lambda: TrainError("injected mid-epoch crash")),
        FaultSpec("train.epoch_end", hits=(1,), action=lambda ctx: None),
    ])
    ckpt_dir = str(tmp_path / "chaos")
    with inject(plan):
        tr, va = pipeline_from_url(cfg, cache_path=cache, policy=FAST_RETRY)
        trainer, state = run_with_restart(
            lambda n: _port_run(tr, ckpt_dir, jax_init, resume=n > 0),
            max_restarts=2, backoff_s=0.0)
    assert plan.fired_count("fetch.request") == FAST_RETRY.max_attempts
    assert plan.fired_count("checkpoint.save.post") == 1
    assert plan.fired_count("train.step") == 1
    for ds in (tr, va):
        assert (trainer.evaluate(state.params, ds)
                == ref_trainer.evaluate(ref_state.params, ds))
    for k, v in ref_state.params.items():
        assert torch.equal(state.params[k], v), k
    jtr = JaxTrainer(jax_build_mlp((16,), out_dim=1),
                     jax_optim.adam(1e-2), loss="mse", precision=JAX_PARITY)
    jstate = jtr.init_state(jax.random.PRNGKey(0), (10,))
    from euromillioner_tpu.data.pipeline import \
        pipeline_from_html as jax_pipeline_from_html

    jtr_ds, _ = jax_pipeline_from_html(golden_html)
    jstate = jtr.fit(jstate, jtr_ds, epochs=EPOCHS, batch_size=BATCH,
                     shuffle=False, rng=jax.random.PRNGKey(7))
    want = params_from_jax(jax.device_get(jstate.params), "cpu")
    for k, v in want.items():
        np.testing.assert_allclose(state.params[k].numpy(), v.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_epoch_end_fault_is_a_retryable_train_error(tmp_path, golden_html,
                                                   jax_init):
    tr, _ = pipeline_from_html(golden_html)
    plan = FaultPlan([FaultSpec("train.epoch_end", hits=(2,),
                                raises=TrainError)])
    with inject(plan):
        trainer, state = run_with_restart(
            lambda n: _port_run(tr, str(tmp_path), jax_init, resume=n > 0),
            max_restarts=1, backoff_s=0.0)
    _, ref = _port_run(tr, str(tmp_path / "ref"), jax_init)
    assert plan.fired_count("train.epoch_end") == 1
    assert all(torch.equal(state.params[k], v)
               for k, v in ref.params.items())


# -- serve.quant: a failed cast falls back to f32, a failed build raises ----

@pytest.fixture(scope="module")
def mlp_model():
    return build_mlp((64, 32), 1, in_features=10, device="cpu")


@pytest.fixture(scope="module")
def rows():
    return np.random.default_rng(0).normal(size=(8, 10)).astype(np.float32)


def test_row_backend_quant_fault_falls_back_to_f32(mlp_model, rows):
    plan = FaultPlan([FaultSpec("serve.quant", raises=RuntimeError,
                                hits=(1,))])
    with inject(plan):
        backend = NNBackend(mlp_model, (10,), compute_dtype=torch.float32,
                            precision="int8w")
    assert plan.fired_count("serve.quant") == 1
    assert backend.precision == "f32" and backend.envelope == 0.0
    with InferenceEngine(backend, buckets=(8,), warmup=False) as eng:
        assert np.array_equal(eng.predict(rows), backend.predict(rows))
        st = eng.stats()
    assert st["errors"] == 0 and st["precision"]["profile"] == "f32"


def test_row_engine_bf16_child_falls_back_and_the_fault_is_in_metrics(
        mlp_model, rows):
    plan = FaultPlan([FaultSpec("serve.quant", raises=RuntimeError,
                                hits=(1,))])
    with inject(plan):
        backend = NNBackend(mlp_model, (10,), compute_dtype=torch.float32,
                            profiles=("bf16",))
    assert backend.fallbacks == {"bf16"} and backend.precision == "f32"
    with InferenceEngine(backend, buckets=(8,), warmup=False,
                         profiles=("bf16",)) as eng:
        want = eng.predict(rows)
        assert np.array_equal(eng.predict(rows, profile="bf16"), want)
        text = eng.telemetry.render()
    assert re.search(r'resilience_faults_fired_total\{point="serve.quant"\}'
                     r' [1-9]', text)


@pytest.mark.parametrize("profile", ["bf16", "fused", "int8w"])
def test_sequence_backend_quant_fault_falls_back_to_f32(profile):
    model = build_lstm(16, 1, 7, fused="off", device="cpu")
    plan = FaultPlan([FaultSpec("serve.quant", raises=OSError, hits=(1,))])
    with inject(plan):
        backend = RecurrentBackend(model, feat_dim=11,
                                   compute_dtype=torch.float32,
                                   precision=profile)
    assert plan.fired_count("serve.quant") == 1
    assert backend.precision == "f32" and backend.serve_params is None
    rng = np.random.default_rng(0)
    seqs = [rng.normal(size=(int(t), 11)).astype(np.float32)
            for t in rng.integers(4, 12, size=4)]
    ref = RecurrentBackend(model, feat_dim=11, compute_dtype=torch.float32)
    with StepScheduler(backend, max_slots=4, step_block=2,
                       warmup=False) as eng:
        got = [eng.submit(s).result(timeout=WAIT) for s in seqs]
        st = eng.stats()
    with StepScheduler(ref, max_slots=4, step_block=2, warmup=False) as eng:
        want = [eng.submit(s).result(timeout=WAIT) for s in seqs]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert st["failed"] == 0 and st["precision"]["profile"] == "f32"


def test_a_failed_kernel_build_is_not_hidden(monkeypatch):
    """The fused tier builds K1 outside the serve.quant try: a build that
    fails raises from the backend, with or without a plan (simulated by a
    card device and a raising ``build``)."""
    from euromillioner_tpu_torch.ops.fused_lstm import FUSED_LSTM_FWD

    def broken_build(*a, **k):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(FUSED_LSTM_FWD, "build", broken_build)
    monkeypatch.setattr(continuous, "resolve_device",
                        lambda d: torch.device("cuda"))
    model = build_lstm(16, 1, 7, fused="off", device="cpu")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        RecurrentBackend(model, feat_dim=11, compute_dtype=torch.float32,
                         precision="fused")
    plan = FaultPlan([FaultSpec("serve.quant", action=lambda ctx: None)])
    with inject(plan):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            RecurrentBackend(model, feat_dim=11,
                             compute_dtype=torch.float32, precision="fused")
    assert plan.fired_count("serve.quant") == 1


# -- the fault-point audit ----------------------------------------------------

# the JAX package's points whose modules the port has not taken yet, each
# queued in ROADMAP queue 1 under the item that ports it: none is left
WAITING: set[str] = set()
_POINT = re.compile(r'fault_point\(\s*"([a-z_.]+)"')


def _points(package: str) -> set[str]:
    names = set()
    for path in (ROOT / package).rglob("*.py"):
        names |= set(_POINT.findall(path.read_text(encoding="utf-8")))
    return names


def test_every_port_fault_point_is_spoken_in_a_port_test():
    port = _points("euromillioner_tpu_torch")
    text = "".join(p.read_text(encoding="utf-8")
                   for p in (ROOT / "tests").glob("test_torch_*.py"))
    missing = sorted(n for n in port if f'"{n}"' not in text)
    assert not missing, missing
    assert len(port) == 31


def test_every_jax_fault_point_is_ported_or_waiting():
    port, jax_points = _points("euromillioner_tpu_torch"), _points(
        "euromillioner_tpu")
    assert jax_points - port == WAITING
    assert port <= jax_points

"""Row serving in the port (euromillioner_tpu_torch/serve/{session,engine,
transport}.py) on the CPU: the engine's replies against a direct predict
at the same bucket shape (the port's mirror of tests/test_serve_quant.py's
Wide&Deep f32 pin), the JAX package's NNBackend against the port's, the
smoke path, and what each family still refuses by name."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.config import Config as JaxConfig
from euromillioner_tpu.models.wide_deep import WideDeep as JaxWideDeep
from euromillioner_tpu.serve.session import NNBackend as JaxNNBackend
from euromillioner_tpu_torch.config import Config, apply_overrides
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.mlp import build_mlp
from euromillioner_tpu_torch.models.wide_deep import WideDeep
from euromillioner_tpu_torch.serve.engine import InferenceEngine
from euromillioner_tpu_torch.serve.session import NNBackend, load_backend
from euromillioner_tpu_torch.serve.transport import (handle_request,
                                                     row_payloads, run_smoke)
from euromillioner_tpu_torch.utils.errors import ConfigError, ServeError

torch.set_num_threads(2)

BUCKET = 8
# tests/test_serve_quant.py's small exact-vocabulary Wide&Deep
SMALL = {"wide_embed_dim": 16, "embed_dim": 8, "ball_vocab": 16,
         "hidden_sizes": (32,), "out_dim": 7}
# replies to single rows coalesced into one bucket against a direct predict
# of each row alone: other GEMM shapes, so rounding only. Measured at most
# 3.6e-7 relative to the outputs' scale over 20 seeded models on the CPU;
# pinned at ~10x.
CROSS_SHAPE_TOL = 4e-6


@pytest.fixture(scope="module")
def jax_backend():
    model = JaxWideDeep(compute_dtype=jnp.float32, **SMALL)
    params, _ = model.init(jax.random.PRNGKey(0), (11,))
    return JaxNNBackend(model, params, (11,), compute_dtype=np.float32)


@pytest.fixture(scope="module")
def backend(jax_backend):
    model = WideDeep(compute_dtype=torch.float32, device="cpu", **SMALL)
    model.load_state_dict(params_from_jax(jax.device_get(jax_backend.params),
                                          device="cpu"))
    return NNBackend(model, (11,), compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(3)
    n = 2 * BUCKET
    return np.concatenate([
        np.stack([rng.integers(1, 8, n), rng.integers(1, 13, n),
                  rng.integers(1, 29, n), rng.integers(2004, 2021, n)], 1),
        rng.integers(1, 51, size=(n, 5)), rng.integers(1, 13, size=(n, 2)),
    ], axis=1).astype(np.float32)


def _engine(backend, **kw):
    return InferenceEngine(backend, buckets=(BUCKET,), max_wait_ms=2.0,
                           **kw)


def test_backend_matches_jax_backend(backend, jax_backend, rows):
    np.testing.assert_allclose(backend.predict(rows),
                               jax_backend.predict(rows), rtol=1e-5,
                               atol=1e-6)
    assert backend.family == "wide_deep" and backend.cast_inputs is False
    assert backend.name == "nn:WideDeep" and backend.envelope == 0.0


def test_engine_replies_bit_equal_to_predict_at_the_bucket(backend, rows):
    want = backend.predict(rows[:BUCKET])
    with _engine(backend) as eng:
        got = eng.predict(rows[:BUCKET])
        assert np.array_equal(got, want)
        st = eng.stats()
    assert st["batches"] == 1 and st["rows"] == BUCKET
    assert st["mean_fill_ratio"] == 1.0


def test_bf16_towers_reply_bit_equal_to_predict(backend, rows):
    model = WideDeep(compute_dtype=torch.bfloat16, device="cpu", **SMALL)
    model.load_state_dict(backend.model.state_dict())
    bf16 = NNBackend(model, (11,))
    with _engine(bf16) as eng:
        assert np.array_equal(eng.predict(rows[:BUCKET]),
                              bf16.predict(rows[:BUCKET]))


def test_single_rows_coalesce_and_pad(backend, rows):
    with _engine(backend, warmup=False) as eng:
        futs = [eng.submit(r) for r in rows[:5]]
        got = np.concatenate([f.result(timeout=60) for f in futs])
        st = eng.stats()
    want = np.concatenate([backend.predict(r[None]) for r in rows[:5]])
    assert got.shape == (5, 7)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= CROSS_SHAPE_TOL, err
    assert st["requests"] == 5 and st["rows"] == 5 and st["errors"] == 0
    assert 0 < st["mean_fill_ratio"] <= 1
    assert set(st) == {"requests", "rows", "batches", "errors",
                       "queue_depth", "mean_fill_ratio", "uptime_s",
                       "classes", "precision", "budget", "p50_ms",
                       "p99_ms"}
    assert st["budget"]["enabled"] is False
    assert set(st["budget"]["bytes"]) == {"params", "queue"}


def test_handle_request_and_smoke(backend, rows):
    with _engine(backend) as eng:
        status, reply = handle_request(eng, {"rows": rows[:3].tolist()})
        assert status == 200 and reply["rows"] == 3
        np.testing.assert_array_equal(np.asarray(reply["predictions"],
                                                 np.float32),
                                      eng.predict(rows[:3]))
        summary = run_smoke(eng, 6)
    assert summary["failed"] == 0 and summary["ok"] == 6
    preds = np.asarray(summary["predictions"], np.float32)
    assert preds.shape == (6, 1, 7) and np.isfinite(preds).all()
    assert np.asarray(row_payloads(6, (11,))).shape == (6, 1, 11)


def test_bad_requests_rejected(backend):
    with _engine(backend, warmup=False) as eng:
        with pytest.raises(ServeError, match="feature shape"):
            eng.submit(np.zeros((2, 10), np.float32))
        # a request past the largest bucket is cut, not refused (F7)
        assert eng.predict(np.zeros((BUCKET + 1, 11), np.float32)).shape \
            == (BUCKET + 1, 7)
        assert eng.predict(np.zeros((0, 11), np.float32)).shape == (0,)
        assert handle_request(eng, {"rows": "abc"})[0] == 400
        assert handle_request(eng, {"rows": [[0.0] * 11],
                                    "max_wait_s": -1})[0] == 400
        assert handle_request(eng, {"rows": [[0.0] * 11],
                                    "class": "bulk"})[0] == 200
        status, body = handle_request(eng, {"rows": [[0.0] * 11],
                                            "class": "premium"})
        assert status == 400 and "unknown request class" in body["error"]
    with pytest.raises(ServeError, match="closed"):
        eng.submit(np.zeros((1, 11), np.float32))


@pytest.fixture(scope="module")
def classic_model_file(tmp_path_factory):
    from euromillioner_tpu_torch.classic import LogisticRegression

    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 5)).astype(np.float32)
    path = tmp_path_factory.mktemp("classic") / "logistic.json"
    LogisticRegression(steps=5, device="cpu").fit(
        x, (x[:, 0] > 0).astype(np.int32)).save_model(str(path))
    return str(path)


@pytest.mark.parametrize("profile", ["bf16", "int8w"])
def test_narrow_profiles_refused_by_name(classic_model_file, profile):
    """The neural row families serve bf16 and int8w; the tree and classic
    families serve f32 only, refused by name before any model file is
    read, and an engine over them refuses the profile as a child."""
    from euromillioner_tpu_torch.serve.session import ClassicBackend
    from euromillioner_tpu_torch.classic import load_classic_model

    cfg = apply_overrides(Config(), [f"serve.precision={profile}"])
    for family in ("gbt", "rf", "classic"):
        with pytest.raises(ConfigError, match=f"{profile}.*f32 only"):
            load_backend(family, None, cfg, device="cpu",
                         model_file="unused")
    backend = ClassicBackend(load_classic_model(classic_model_file,
                                                device="cpu"))
    with pytest.raises(ConfigError, match=profile):
        InferenceEngine(backend, buckets=(BUCKET,), warmup=False,
                        profiles=(profile,))


def test_fused_profile_has_no_wide_deep_envelope(backend):
    with pytest.raises(ConfigError, match="wide_deep"):
        NNBackend(backend.model, (11,), precision="fused")


@pytest.mark.parametrize("family", ["gbt", "rf", "mlp", "classic"])
def test_other_families_refused_by_name(family):
    """What each family still refuses, by name, before a model file or
    checkpoint is read: the mlp's fused profile (no pinned (nn, fused)
    envelope), and the tree families and classic at any profile but f32
    (the tree families' chunked dispatch, refused here until it was
    ported, is held in tests/test_torch_serve_trees.py)."""
    cfg, match = Config(), f"{family} serves f32 only"
    if family == "mlp":
        with pytest.raises(ConfigError, match="'nn' family.*'fused'"):
            NNBackend(build_mlp((4,), device="cpu"), (10,),
                      precision="fused")
        return
    else:
        cfg = apply_overrides(cfg, ["serve.precision=int8w"])
    with pytest.raises(ConfigError, match=match):
        load_backend(family, "unused", cfg, device="cpu",
                     model_file="unused")


@pytest.mark.parametrize("knob", ["serve.trees.chunk_threshold=16",
                                  "serve.trees.approx_mean=true"])
def test_chunked_dispatch_knobs_are_not_accepted(knob):
    """The chunked dispatch's knobs were unknown fields until it was
    ported; now each is a field with the JAX package's default that an
    override sets, and what is not a field of ``serve.trees`` is still
    not accepted."""
    key, value = knob.split("=")
    field = key.rsplit(".", 1)[1]
    assert getattr(Config().serve.trees, field) == getattr(
        JaxConfig().serve.trees, field)
    got = getattr(apply_overrides(Config(), [knob]).serve.trees, field)
    assert str(got).lower() == value
    with pytest.raises(ValueError, match="unknown field"):
        apply_overrides(Config(), [f"serve.trees.{field}_x={value}"])


def test_lstm_and_unknown_families_are_serve_errors():
    with pytest.raises(ServeError, match="sequence family"):
        load_backend("lstm", "unused", Config(), device="cpu")
    with pytest.raises(ServeError, match="unknown model type"):
        load_backend("nope", "unused", Config(), device="cpu")
    with pytest.raises(ServeError, match="--checkpoint"):
        load_backend("wide_deep", None, Config(), device="cpu")


def test_gbt_replies_bit_equal_to_predict_at_any_position():
    """F5: a reg:logistic booster served on the CPU; a 20-row request padded
    to the 32-row bucket replies bit-equal to Booster.predict of the same
    20 rows, so the transform's bits depend on neither a row's position in
    the batch nor the batch's length."""
    from euromillioner_tpu_torch.serve.session import GBTBackend
    from euromillioner_tpu_torch.trees import DMatrix, train

    rng = np.random.default_rng(5)
    x = rng.normal(size=(400, 8)).astype(np.float32)
    y = (x @ rng.normal(size=8) + 0.5 * rng.normal(size=400) > 0).astype(
        np.float32)
    booster = train({"objective": "reg:logistic", "eta": 0.1,
                     "max_depth": 6, "device": "cpu"}, DMatrix(x, y), 60,
                    verbose_eval=False)
    backend = GBTBackend(booster)
    rows = x[:20]
    with InferenceEngine(backend, buckets=(32,), max_wait_ms=2.0) as eng:
        got = eng.predict(rows)
    want = booster.predict(DMatrix(rows))
    assert got.shape == want.shape == (20,)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.fixture(scope="module")
def gbt_backend():
    from euromillioner_tpu_torch.serve.session import GBTBackend
    from euromillioner_tpu_torch.trees import DMatrix, train

    rng = np.random.default_rng(7)
    x = rng.normal(size=(300, 6)).astype(np.float32)
    y = (x[:, 0] + 0.3 * rng.normal(size=300) > 0).astype(np.float32)
    booster = train({"objective": "binary:logistic", "max_depth": 3,
                     "device": "cpu"}, DMatrix(x, y), 5, verbose_eval=False)
    return GBTBackend(booster), x


def test_oversized_request_chunks_and_reassembles(gbt_backend, tmp_path):
    """F7, the JAX package's ``test_oversized_request_chunks_and_
    reassembles``: 100 rows at buckets (8, 32) are cut into bucket-sized
    requests, each admitted with its own trace id; the joined reply is
    bit-equal to ``predict``, at least 4 batches ran and the capture holds
    one replay event for the whole request."""
    import json

    backend, x = gbt_backend
    cap = tmp_path / "cap.jsonl"
    with InferenceEngine(backend, buckets=(8, 32), max_wait_ms=1.0,
                         warmup=False, capture_path=str(cap)) as eng:
        got = eng.predict(x[:100])
        st = eng.stats()
        spans = eng.telemetry.trace_snapshot()["spans"]
    assert np.array_equal(got, backend.predict(x[:100]))
    assert st["batches"] >= 4 and st["rows"] == 100
    assert st["requests"] == 4  # 32 + 32 + 32 + 4 rows, one trace id each
    assert spans == 4
    events = [json.loads(ln) for ln in cap.read_text().splitlines()
              if ln.strip()]
    reqs = [e for e in events if e.get("rows") is not None]
    assert len(reqs) == 1 and reqs[0]["rows"] == 100


def test_oversized_request_unadmits_the_rest_on_a_failed_cut(gbt_backend):
    """A cut the batcher refuses un-admits itself and every cut after it:
    the request counter and the budget's queue bytes are given back."""
    from euromillioner_tpu_torch.serve.session import BudgetPolicy

    backend, x = gbt_backend
    with InferenceEngine(backend, buckets=(8, 32), max_wait_ms=50.0,
                         warmup=False,
                         budget=BudgetPolicy(enabled=True)) as eng:
        real = eng._batcher.submit
        calls = []

        def flaky(req):
            calls.append(req)
            if len(calls) == 2:
                raise ServeError("batcher refused the second cut")
            return real(req)

        eng._batcher.submit = flaky
        with pytest.raises(ServeError, match="second cut"):
            eng.submit(x[:100])
        eng._batcher.submit = real
        # the first cut was admitted and is served; the other three are not
        assert int(eng.telemetry.requests.get()) == 1
        queued = eng._mem.bytes("queue")
        assert queued in (0, calls[0].x.nbytes)
        assert eng.predict(x[:3]).shape == (3,)
    assert eng._mem.bytes("queue") == 0


def test_oversized_request_over_http(gbt_backend):
    """The same 100-row request through ``POST /predict``."""
    import json
    import threading
    import urllib.request

    from euromillioner_tpu_torch.serve.transport import make_server

    backend, x = gbt_backend
    eng = InferenceEngine(backend, buckets=(8, 32), max_wait_ms=1.0,
                          warmup=False)
    server = make_server(eng, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              kwargs={"poll_interval": 0.05})
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/predict"
        body = json.dumps({"rows": x[:100].tolist()}).encode()
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            reply = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        eng.close()
    got = np.asarray(reply["predictions"], np.float32)
    assert np.array_equal(got, backend.predict(x[:100]))

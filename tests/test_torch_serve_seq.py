"""Whole-sequence serving in the port (serve/continuous.py) against the JAX
package's RecurrentBackend on the same weights, plus the port's own
scheduler pins."""

import jax
import numpy as np
import pytest
import torch

from euromillioner_tpu.models.lstm import build_lstm as jax_build_lstm
from euromillioner_tpu.serve import RecurrentBackend as JaxBackend
from euromillioner_tpu_torch.config import Config, apply_overrides
from euromillioner_tpu_torch.core.precision import (SERVE_ENVELOPES,
                                                    is_quantized)
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.serve.continuous import (RecurrentBackend,
                                                      StepScheduler,
                                                      WholeSequenceScheduler,
                                                      make_sequence_engine)
from euromillioner_tpu_torch.serve.session import load_backend
from euromillioner_tpu_torch.serve.transport import handle_request, run_smoke
from euromillioner_tpu_torch.utils.errors import (CheckpointError, ConfigError,
                                                  ServeError)

torch.set_num_threads(2)

FEAT = 11
# f32 on both sides (compute_dtype float32); the port's fused profile is
# the kernel's plain version on the CPU. Measured max abs diff vs the
# JAX oracle 1.5e-8 (outputs up to 0.15); pinned at the JAX package's NN
# trajectory pin (tests/test_train.py).
RTOL = 1e-5
ATOL = 1e-6
LENS = (1, 3, 8, 17)


@pytest.fixture(scope="module")
def models():
    jm = jax_build_lstm(hidden=8, num_layers=2, out_dim=7, fused="off")
    params, _ = jm.init(jax.random.PRNGKey(0), (64, FEAT))
    tm = build_lstm(8, 2, 7, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params), "cpu"))
    return JaxBackend(jm, params, feat_dim=FEAT,
                      compute_dtype=np.float32), tm


@pytest.fixture(scope="module")
def seqs():
    rng = np.random.default_rng(0)
    return {n: rng.normal(size=(n, FEAT)).astype(np.float32) for n in LENS}


def _backend(tm, precision):
    return RecurrentBackend(tm, feat_dim=FEAT, compute_dtype=torch.float32,
                            precision=precision)


@pytest.mark.parametrize("steps", LENS)
def test_predict_matches_jax_predict(models, seqs, steps):
    jb, tm = models
    got = _backend(tm, "f32").predict(seqs[steps])
    assert got.shape == (7,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jb.predict(seqs[steps]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("precision", ["f32", "fused"])
def test_scheduler_replies_match_jax_predict(models, seqs, precision):
    jb, tm = models
    with WholeSequenceScheduler(_backend(tm, precision),
                                row_buckets=(4, 8),
                                time_buckets=(8, 16, 32)) as eng:
        futs = {n: eng.submit(seqs[n]) for n in LENS}
        got = {n: f.result(timeout=60) for n, f in futs.items()}
        assert eng.stats()["sequences"] == len(LENS)
    for n in LENS:
        np.testing.assert_allclose(got[n], jb.predict(seqs[n]), rtol=RTOL,
                                   atol=ATOL, err_msg=f"T={n}")


@pytest.mark.parametrize("precision", ["f32", "fused"])
def test_scheduler_equals_its_program_at_bucket_shape(models, seqs,
                                                      precision):
    """One request at a time is one micro-batch: its reply is BIT-equal to
    the backend's padded program run directly at the same (row bucket,
    time bucket) shape."""
    _, tm = models
    backend = _backend(tm, precision)
    with WholeSequenceScheduler(backend, row_buckets=(4,),
                                time_buckets=(8, 32)) as eng:
        for n in LENS:
            reply = eng.predict(seqs[n])
            tb = 8 if n <= 8 else 32
            x = np.zeros((4, tb, FEAT), np.float32)
            x[0, :n] = seqs[n]
            last = np.array([n - 1, 0, 0, 0])
            want = backend.padded_fn(x, last)[0].numpy()
            np.testing.assert_array_equal(reply, want)


def test_fused_profile_inside_its_envelope_of_f32(models, seqs):
    _, tm = models
    f32, fused = _backend(tm, "f32"), _backend(tm, "fused")
    assert fused.envelope == 1e-1 and f32.envelope == 0.0
    x = np.zeros((4, 32, FEAT), np.float32)
    last = np.zeros(4, np.int64)
    for i, n in enumerate((3, 8, 17, 1)):
        x[i, :n] = seqs[n]
        last[i] = n - 1
    a, b = f32.padded_fn(x, last), fused.padded_fn(x, last)
    rel = float((a - b).abs().max() / a.abs().max())
    assert rel <= fused.envelope


def test_stats_keys_pinned(models, seqs):
    _, tm = models
    with WholeSequenceScheduler(_backend(tm, "f32"), row_buckets=(8,),
                                time_buckets=(8, 32)) as eng:
        for n in (3, 17):
            eng.predict(seqs[n])
        st = eng.stats()
    assert set(st) == {"scheduler", "batches", "sequences", "errors",
                       "queued", "mean_row_fill", "mean_time_fill",
                       "classes", "precision", "uptime_s", "p50_ms",
                       "p99_ms"}
    assert st["classes"]["interactive"]["completed"] == 2
    assert st["scheduler"] == "batch" and st["sequences"] == 2
    assert st["errors"] == 0 and st["batches"] == 2
    assert 0 < st["mean_row_fill"] <= 1 and 0 < st["mean_time_fill"] <= 1


def test_bad_requests_rejected(models):
    _, tm = models
    with WholeSequenceScheduler(_backend(tm, "f32"), row_buckets=(4,),
                                time_buckets=(8,)) as eng:
        with pytest.raises(ServeError, match="outside"):
            eng.submit(np.zeros((9, FEAT), np.float32))
        with pytest.raises(ServeError, match="sequence must be"):
            eng.submit(np.zeros((3, FEAT + 1), np.float32))
        assert handle_request(eng, {"rows": "abc"})[0] == 400
        assert handle_request(eng, [1, 2])[0] == 400
        assert handle_request(eng, {"rows": [[0.0] * FEAT],
                                    "class": "bulk"})[0] == 200
        status, body = handle_request(eng, {"rows": [[0.0] * FEAT],
                                            "class": "premium"})
        assert status == 400 and "unknown request class" in body["error"]
        assert handle_request(eng, {"rows": [[0.0] * FEAT],
                                    "max_wait_s": -1})[0] == 400
    with pytest.raises(ServeError, match="closed"):
        eng.submit(np.zeros((2, FEAT), np.float32))


def test_handle_request_round_trip(models, seqs):
    jb, tm = models
    with WholeSequenceScheduler(_backend(tm, "fused"), row_buckets=(4,),
                                time_buckets=(8, 32)) as eng:
        status, body = handle_request(
            eng, {"rows": seqs[17].tolist(), "max_wait_s": 0.001})
    assert status == 200 and body["rows"] == 1
    np.testing.assert_allclose(body["predictions"], jb.predict(seqs[17]),
                               rtol=RTOL, atol=ATOL)


def test_run_smoke_through_configured_engine(models):
    _, tm = models
    cfg = apply_overrides(Config(), ["serve.buckets=4,8",
                                     "serve.seq_buckets=8,16",
                                     "serve.warmup=true",
                                     "serve.precision=fused"])
    with make_sequence_engine(_backend(tm, "fused"), cfg) as eng:
        summary = run_smoke(eng, 10)
    assert summary["failed"] == 0 and summary["ok"] == 10
    assert summary["stats"]["sequences"] == 10
    preds = np.asarray(summary["predictions"])
    assert preds.shape == (10, 7) and np.isfinite(preds).all()


@pytest.mark.parametrize("override,err", [
    ("serve.scheduler=continuous", None),
    ("serve.scheduler=nonsense", ServeError),
])
def test_unported_or_unknown_scheduler(models, override, err):
    """Both of the JAX package's schedulers are ported; any other name is
    a ServeError."""
    _, tm = models
    cfg = apply_overrides(Config(), [override, "serve.warmup=false"])
    if err is None:
        with make_sequence_engine(_backend(tm, "f32"), cfg) as eng:
            assert isinstance(eng, StepScheduler)
        return
    with pytest.raises(err):
        make_sequence_engine(_backend(tm, "f32"), cfg)


@pytest.mark.parametrize("precision", ["bf16", "int8w", "fp8",
                                       "wide_deep:bf16"])
def test_unported_or_unknown_precision(models, precision):
    """The sequence family serves bf16 and int8w at their pinned
    envelopes; fp8 is no profile; a row family takes bf16 too and gets as
    far as the restore, which finds no checkpoint (CheckpointError, as
    the JAX package's load_backend)."""
    _, tm = models
    if precision == "fp8":
        with pytest.raises(ConfigError, match="fp8"):
            _backend(tm, precision)
    elif precision == "wide_deep:bf16":
        cfg = apply_overrides(Config(), [
            "serve.precision=bf16", "model.wide_deep_target_params=200000"])
        with pytest.raises(CheckpointError, match="no-such-checkpoint"):
            load_backend("wide_deep", "no-such-checkpoint", cfg,
                         device="cpu")
    else:
        backend = _backend(tm, precision)
        assert backend.envelope == SERVE_ENVELOPES[("lstm", precision)]


@pytest.fixture(scope="module")
def padded_batch(seqs):
    x = np.zeros((4, 32, FEAT), np.float32)
    last = np.zeros(4, np.int64)
    for i, n in enumerate((3, 8, 17, 1)):
        x[i, :n] = seqs[n]
        last[i] = n - 1
    return x, last


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# compute dtype bfloat16 (the default) on both sides. fused and int8w
# serve float32 in both packages, so they are held at the f32 pins above.
# bf16 is the scan on both sides in bfloat16; XLA CPU keeps some fused
# elementwise intermediates in f32 where eager PyTorch rounds each op to
# bf16, so the two drift apart by a few ulps over the steps: measured
# 9.1e-3 of the output's scale, pinned at 2e-2, well inside the (lstm,
# bf16) envelope of 8e-2.
BF16_VS_JAX = 2e-2


@pytest.mark.parametrize("profile,act_quant", [
    ("f32", False), ("bf16", False), ("fused", False), ("int8w", False),
    ("int8w", True)])
def test_tiers_match_the_jax_backend_at_the_default_dtype(
        models, padded_batch, profile, act_quant):
    """Each profile's padded program against the JAX RecurrentBackend's at
    the same profile, compute dtype bfloat16, and inside the profile's
    envelope of the f32 oracle program."""
    jb, tm = models
    x, last = padded_batch
    jax_b = JaxBackend(jb.model, jb.params, feat_dim=FEAT,
                       compute_dtype=jax.numpy.bfloat16, precision=profile,
                       act_quant=act_quant)
    want = np.asarray(jax.jit(jax_b.padded_fn)(jax_b.serve_params, x, last))
    port_b = RecurrentBackend(tm, feat_dim=FEAT, compute_dtype=torch.bfloat16,
                              precision=profile, act_quant=act_quant)
    got = port_b.padded_fn(x, last).numpy()
    if port_b.serve_dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert _rel(got, want) <= BF16_VS_JAX
    oracle = _backend(tm, "f32").padded_fn(x, last).numpy()
    assert _rel(got, oracle) <= max(port_b.envelope, BF16_VS_JAX)
    if profile == "int8w":
        assert _rel(got, oracle) > 0  # the weights really are int8


@pytest.mark.parametrize("profile", ["f32", "bf16", "fused", "int8w"])
def test_serve_dtype_is_the_jax_backends(models, profile):
    """Each tier computes in the JAX package's serving dtype at the
    default compute dtype: f32 and bf16 in bfloat16, fused and int8w in
    float32 (its serve/continuous.py sets ``sdt`` to float32 for both)."""
    jb, tm = models
    jax_b = JaxBackend(jb.model, jb.params, feat_dim=FEAT,
                       compute_dtype=jax.numpy.bfloat16, precision=profile)
    port_b = RecurrentBackend(tm, feat_dim=FEAT, compute_dtype=torch.bfloat16,
                              precision=profile)
    assert str(port_b.serve_dtype).split(".")[-1] == np.dtype(
        jax_b.serve_dtype).name


def test_int8w_keeps_int8_and_scales_resident(models, seqs):
    """Quantized once at construction (min_size 16: every matrix), dense
    only inside a call; the shared model and the oracle are untouched."""
    _, tm = models
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    backend = _backend(tm, "int8w")
    for key, leaf in backend.serve_params.items():
        assert is_quantized(leaf) == (before[key].dim() == 2), key
    backend.padded_fn(np.zeros((4, 8, FEAT), np.float32),
                      np.zeros(4, np.int64))
    for key, value in tm.state_dict().items():
        assert torch.equal(value, before[key]), key
    np.testing.assert_array_equal(backend.predict(seqs[8]),
                                  _backend(tm, "f32").predict(seqs[8]))


def test_bf16_tier_casts_once_and_serves_bfloat16(models):
    _, tm = models
    backend = _backend(tm, "bf16")
    assert backend.serve_dtype == torch.bfloat16
    assert {v.dtype for v in backend.serve_params.values()} == {
        torch.bfloat16}
    assert next(tm.parameters()).dtype == torch.float32


@pytest.mark.parametrize("profile", ["bf16", "fused", "int8w"])
def test_scheduler_serves_each_tier_inside_its_envelope(models, seqs,
                                                        profile):
    """Through the scheduler, a sibling from ``with_profile``: every reply
    inside the profile's envelope of the oracle ``predict``."""
    _, tm = models
    oracle = _backend(tm, "f32")
    backend = oracle.with_profile(profile)
    assert backend.model is oracle.model and backend.precision == profile
    with WholeSequenceScheduler(backend, row_buckets=(4, 8),
                                time_buckets=(8, 16, 32)) as eng:
        got = {n: eng.predict(seqs[n]) for n in LENS}
    for n in LENS:
        assert _rel(got[n], oracle.predict(seqs[n])) <= backend.envelope


def test_fused_unroll_is_validated(models):
    _, tm = models
    with pytest.raises(ConfigError, match="fused_unroll"):
        RecurrentBackend(tm, feat_dim=FEAT, precision="fused",
                         fused_unroll=1)
    cfg = apply_overrides(Config(), ["serve.fused_unroll=4",
                                     "serve.act_quant=true"])
    assert cfg.serve.fused_unroll == 4 and cfg.serve.act_quant is True

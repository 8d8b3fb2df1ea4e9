"""The port's classic family (euromillioner_tpu_torch/classic/) against the
JAX package's, on the CPU, on seeded blobs: each fit (KMeans from the JAX
draw's initial indices) and its predictions, JSON model dumps of either
package loaded by the other with identical ids, ``ClassicBackend`` engine
replies bit-equal to ``predict``, and ``serve --model-type classic``."""

import json

import jax
import numpy as np
import pytest
import torch

from euromillioner_tpu import classic as jax_classic
from euromillioner_tpu_torch import classic, cli
from euromillioner_tpu_torch.serve.engine import InferenceEngine
from euromillioner_tpu_torch.serve.session import ClassicBackend
from euromillioner_tpu_torch.serve.transport import row_payloads, run_smoke
from euromillioner_tpu_torch.utils.errors import (ConfigError, DataError,
                                                  ServeError)

torch.set_num_threads(2)

C, F, N = 4, 9, 300
KINDS = ["logistic", "svm", "naive_bayes", "kmeans"]
# f32 on both sides; XLA CPU and PyTorch CPU sum the (N, F) products and
# the reductions in other orders. Measured: logistic regression's w and b
# within 1.4e-7 and 2.9e-7 of their scales after 500 steps, its scores
# within 3.8e-6 abs at magnitudes up to 24; the SVM's (w, b) bit-equal,
# its scores within 1.9e-6 abs (the test rows' product); naive Bayes'
# means and priors bit-equal, variances within 1.4e-6 of their scale (the
# smoothing term's variance), log-probabilities within 3.2e-4 abs at
# magnitudes up to 174; k-means centres bit-equal, inertia 9.2e-8
# relative. Pinned at 1e-5 of each array's scale (rtol and atol); ids
# identical.
RTOL = 1e-5


def _blobs(seed=0, n=N):
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=3, size=(C, F))
    y = rng.integers(0, C, n)
    x = (centres[y] + rng.normal(size=(n, F))).astype(np.float32)
    return x, y.astype(np.int32)


@pytest.fixture(scope="module")
def data():
    x, y = _blobs(0)
    xt, _ = _blobs(1, 64)
    return x, y, xt


def _jax_model(kind):
    return {"logistic": jax_classic.LogisticRegression,
            "svm": jax_classic.LinearSVM,
            "naive_bayes": jax_classic.GaussianNB}[kind]()


def _fit_pair(kind, x, y, seed=3):
    """(JAX model, port model) fitted on the same rows; k-means from the
    JAX fit's own initial draw."""
    if kind == "kmeans":
        jm = jax_classic.KMeans(C, seed=seed).fit(x)
        idx = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), len(x),
                                           (C,), replace=False))
        pm = classic.KMeans(C, seed=seed, device="cpu").fit_from_indices(
            x, idx)
        return jm, pm
    pm = classic.CLASSIC_KINDS[kind](device="cpu")
    return _jax_model(kind).fit(x, y), pm.fit(x, y)


def _close_scaled(got, want, what):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


def _fitted_arrays(kind, m):
    if kind == "kmeans":
        return [m.centers]
    if kind == "naive_bayes":
        return list(m._params)
    return list(m._wb)


@pytest.mark.parametrize("kind", KINDS)
def test_fit_and_predict_match_jax(kind, data):
    x, y, xt = data
    jm, pm = _fit_pair(kind, x, y)
    for got, want in zip(_fitted_arrays(kind, pm), _fitted_arrays(kind, jm)):
        _close_scaled(got, want, kind)
    np.testing.assert_array_equal(pm.predict(xt), jm.predict(xt))
    assert pm.predict(xt).dtype == np.int32
    if kind == "kmeans":
        np.testing.assert_array_equal(pm.labels_, jm.labels_)
        np.testing.assert_allclose(pm.inertia, jm.inertia, rtol=RTOL)
    elif kind == "naive_bayes":
        _close_scaled(pm.predict_log_proba(xt), jm.predict_log_proba(xt),
                      "log_proba")
    else:
        _close_scaled(pm.decision_function(xt), jm.decision_function(xt),
                      "decision_function")
        if kind == "logistic":
            np.testing.assert_allclose(pm.predict_proba(xt),
                                       jm.predict_proba(xt), atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_json_dumps_cross_load(kind, direction, data, tmp_path):
    """A JSON dump of one package, loaded by the other's loader, gives the
    saving model's ids exactly."""
    x, y, xt = data
    jm, pm = _fit_pair(kind, x, y)
    path = str(tmp_path / f"{kind}.json")
    if direction == "jax_to_port":
        jm.save_model(path)
        loaded = classic.load_classic_model(path, device="cpu")
        want = jm.predict(xt)
    else:
        pm.save_model(path)
        loaded = jax_classic.load_classic_model(path)
        want = pm.predict(xt)
    np.testing.assert_array_equal(loaded.predict(xt), want)
    assert json.load(open(path))["kind"] == kind


@pytest.mark.parametrize("kind", KINDS)
def test_engine_replies_bit_equal_to_predict(kind, data):
    """Rows through the row engine (padded to the 32-row bucket) reply the
    model's predict ids, and the smoke path serves."""
    x, y, xt = data
    _, pm = _fit_pair(kind, x, y)
    backend = ClassicBackend(pm)
    assert backend.feat_shape == (F,) and backend.family == "classic"
    with InferenceEngine(backend, buckets=(8, 32), max_wait_ms=2.0) as eng:
        got = eng.predict(xt[:20])
        summary = run_smoke(eng, 6)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, pm.predict(xt[:20]))
    assert summary["failed"] == 0
    rows = np.asarray(row_payloads(6, (F,)), np.float32)[:, 0]
    np.testing.assert_array_equal(
        np.asarray(summary["predictions"])[:, 0], pm.predict(rows))


def test_kmeans_fit_draws_distinct_rows_from_its_seed(data):
    x, _, _ = data
    a = classic.KMeans(C, seed=5, device="cpu").fit(x)
    b = classic.KMeans(C, seed=5, device="cpu").fit(x)
    assert torch.equal(a.centers, b.centers) and a.inertia == b.inertia
    gen = torch.Generator().manual_seed(5)
    idx = torch.randperm(len(x), generator=gen)[:C].numpy()
    assert len(set(idx.tolist())) == C
    c = classic.KMeans(C, seed=5, device="cpu").fit_from_indices(x, idx)
    assert torch.equal(a.centers, c.centers)


def test_errors(data, tmp_path):
    x, y, _ = data
    with pytest.raises(DataError, match="k must be"):
        classic.KMeans(0, device="cpu")
    with pytest.raises(DataError, match="rows"):
        classic.KMeans(5, device="cpu").fit(x[:3])
    with pytest.raises(DataError, match="initial indices"):
        classic.KMeans(C, device="cpu").fit_from_indices(x, [0, 1])
    for kind in ("logistic", "svm", "naive_bayes"):
        with pytest.raises(DataError, match="fit before"):
            classic.CLASSIC_KINDS[kind](device="cpu").predict(x)
        with pytest.raises(ServeError, match="fit/loaded"):
            ClassicBackend(classic.CLASSIC_KINDS[kind](device="cpu"))
    with pytest.raises(DataError, match="bad"):
        classic.LogisticRegression(device="cpu").fit(x, y[:5])
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"kind": "tree"}))
    with pytest.raises(DataError, match="unknown classic model kind"):
        classic.load_classic_model(str(bad), device="cpu")
    with pytest.raises(DataError, match="not a 'svm' dump"):
        classic.LinearSVM.from_payload({"kind": "logistic"})


def test_fits_run_on_the_card_unless_asked(monkeypatch, data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (classic.LogisticRegression, classic.LinearSVM,
                classic.GaussianNB):
        with pytest.raises(ConfigError, match="no CUDA device"):
            cls()
    with pytest.raises(ConfigError, match="no CUDA device"):
        classic.KMeans(C)


@pytest.mark.parametrize("kind", ["logistic", "kmeans"])
def test_cli_serves_a_classic_dump(kind, data, tmp_path, capsys):
    """``serve --model-type classic --model-file M --smoke 8`` on a dump
    the JAX package wrote: replies bit-equal to the port's predict of the
    smoke rows; a narrow profile is refused (17), as in the JAX CLI."""
    x, y, _ = data
    jm, _ = _fit_pair(kind, x, y)
    path = str(tmp_path / "m.json")
    jm.save_model(path)
    capsys.readouterr()
    assert cli.main(["serve", "--model-type", "classic", "--model-file",
                     path, "--smoke", "8", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["failed"] == 0
    rows = np.asarray(row_payloads(8, (F,)), np.float32)[:, 0]
    want = classic.load_classic_model(path, device="cpu").predict(rows)
    np.testing.assert_array_equal(
        np.asarray(summary["predictions"])[:, 0], want)
    assert cli.main(["serve", "--model-type", "classic", "--model-file",
                     path, "--smoke", "8", "--device", "cpu",
                     "serve.precision=bf16"]) == 17

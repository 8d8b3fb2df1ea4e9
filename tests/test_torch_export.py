"""Model export in the port (euromillioner_tpu_torch/core/export.py and the
``export`` / ``predict --model-type exported`` CLI) on the CPU: the
counterpart of the JAX package's ``tests/test_export.py``, and parity with
that package on the same checkpoints.

- the manifest round trip, the torch runtime against the model, a runner
  reused across batches, the load errors (no export dir, a runtime outside
  ``torch|native``, a device or input the program was not exported for);
- the CLI loop train → export → predict (1705 lines, one per draw);
- Wide&Deep exported over raw float rows (its ids are never cast to the
  compute dtype);
- the programs keep K1 and K4a as the opaque ``emtpu::`` custom-op calls
  the native runner registers in C++;
- one seeded checkpoint per family, trained by the JAX CLI at small widths
  and exported by both CLIs: the JAX package's ``run_jax`` against the
  port's ``run_torch`` in f32 at rtol 1e-5 / atol 1e-6 (Wide&Deep, which
  both CLIs build at bfloat16, also at float32 through the API), and the
  two manifests' ``in_specs``, ``out_specs`` and ``meta`` keys equal.

Everything here runs on the torch runtime: nothing is compiled. The native
runtime (an AOTInductor compile a program) is in
tests/test_torch_native_runner.py.
"""

from __future__ import annotations

import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from euromillioner_tpu.cli import main as jax_main
from euromillioner_tpu.core import export as jax_ex
from euromillioner_tpu_torch.cli import main as port_main
from euromillioner_tpu_torch.core import export as ex
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.models.mlp import build_mlp
from euromillioner_tpu_torch.models.wide_deep import build_wide_deep

torch.set_num_threads(2)

GOLDEN = str(pathlib.Path(__file__).parent / "golden" / "euromillions.html")
# the JAX package's NN pin (tests/test_train.py), f32
RTOL, ATOL = 1e-5, 1e-6
# both CLIs build Wide&Deep at bfloat16: its towers agree with the JAX
# package's within one bf16 ulp of the output's scale (XLA keeps some
# bf16 intermediates in f32), as tests/test_torch_wide_deep.py pins
BF16_FWD_TOL = 2.0 ** -8

# small widths of each family for the JAX CLI's train and both exports
FAMILIES = {
    "mlp": ["--model.hidden_sizes=8", "--model.compute_dtype=float32"],
    "lstm": ["--model.lstm_hidden=8", "--model.lstm_layers=2",
             "--model.seq_len=8", "--model.compute_dtype=float32"],
    "wide_deep": ["--model.wide_deep_target_params=4000000",
                  "--model.embed_dim=8"],
}
BATCH = 4


def _rows(b: int, seed: int = 1) -> np.ndarray:
    """Featurized rows as bench.py draws them: dow, month, day, year
    2004-2020, five balls 1-50, two stars 1-12 (a year of 2004 in row 0:
    a bf16 cast before the lookup would alias it)."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        np.stack([rng.integers(1, 8, b), rng.integers(1, 13, b),
                  rng.integers(1, 29, b), rng.integers(2004, 2021, b)], 1),
        rng.integers(1, 51, size=(b, 5)), rng.integers(1, 13, size=(b, 2)),
    ], axis=1).astype(np.float32)
    x[0, 3] = 2004.0
    return x


def _inputs(family: str) -> np.ndarray:
    rng = np.random.default_rng(2)
    if family == "mlp":
        return rng.normal(size=(BATCH, 10)).astype(np.float32)
    if family == "lstm":
        return rng.normal(size=(BATCH, 8, 11)).astype(np.float32)
    return _rows(BATCH)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    model = build_mlp(hidden_sizes=(16,), out_dim=7, device="cpu")
    x = np.random.default_rng(0).normal(size=(8, 10)).astype(np.float32)
    out = str(tmp_path_factory.mktemp("export") / "mlp")
    ex.export_model(model, (x,), out, meta={"model": "mlp"})
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    return out, x, want


def test_manifest_roundtrip(artifact):
    out, x, want = artifact
    code, manifest = ex.load_exported(out)
    assert len(code) > 0
    assert manifest["in_specs"] == [[[8, 10], "float32"]]
    assert manifest["out_specs"] == [[[8, 7], "float32"]]
    assert manifest["meta"]["model"] == "mlp"
    assert manifest["device"] == "cpu"


def test_run_torch_parity(artifact):
    out, x, want = artifact
    got = ex.run_torch(out, x, device="cpu")[0]
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_runner_reuse(artifact):
    out, x, want = artifact
    with ex.ExportedRunner(out, "torch", "cpu") as run:
        a = run(x)[0]
        b = run(x * 2.0)[0]
    np.testing.assert_allclose(a, want, atol=1e-6)
    assert not np.allclose(a, b)


def test_load_errors(tmp_path, artifact):
    with pytest.raises(ex.ExportError, match="not an export dir") as e:
        ex.load_exported(str(tmp_path))
    assert e.value.exit_code == 17
    model = build_mlp(hidden_sizes=(4,), out_dim=1, in_features=3,
                      device="cpu")
    x = np.zeros((2, 3), np.float32)
    out = str(tmp_path / "m")
    ex.export_model(lambda a: model(a), (x,), out)
    for runtime in ("onnx", "jax"):
        with pytest.raises(ex.ExportError, match="runtime must be") as e:
            ex.ExportedRunner(out, runtime, "cpu")
        assert e.value.exit_code == 17
    # an input the program was not exported for is refused, not run
    with ex.ExportedRunner(out, "torch", "cpu") as run:
        with pytest.raises(ex.ExportError, match="the program takes"):
            run(np.zeros((3, 3), np.float32))
        with pytest.raises(ex.ExportError, match="the program takes"):
            run(np.zeros((2, 3), np.float64))


def test_program_exported_for_the_card_is_refused_on_the_cpu(artifact,
                                                             tmp_path):
    """A program runs on the device it was exported for; any other is
    refused by name, under either runtime, before anything compiles."""
    out, _x, _want = artifact
    card = tmp_path / "card"
    card.mkdir()
    (card / "program.pt2").write_bytes(
        (pathlib.Path(out) / "program.pt2").read_bytes())
    manifest = json.loads((pathlib.Path(out) / "manifest.json").read_text())
    (card / "manifest.json").write_text(json.dumps(dict(manifest,
                                                        device="cuda")))
    for runtime in ex.RUNTIMES:
        with pytest.raises(ex.ExportError,
                           match="exported for cuda; it cannot run on cpu"):
            ex.ExportedRunner(str(card), runtime, "cpu")
    assert not (card / "native").exists()


def test_programs_keep_the_kernels_as_custom_op_calls():
    """Under no_grad the LSTM's K1 and Wide&Deep's K4a are the opaque
    ``emtpu::`` calls (never the autograd Functions) that the native
    runner's C++ registration serves."""
    lstm = build_lstm(hidden=8, num_layers=2, fused="on", device="cpu")
    wd = build_wide_deep(target_params=300_000, embed_dim=8,
                         hidden_sizes=(16,), device="cpu")
    for model, x, op in (
            (lstm, torch.zeros(2, 5, 11), torch.ops.emtpu.lstm_sequence),
            (wd, torch.from_numpy(_rows(2)), torch.ops.emtpu.wide_onehot_fwd)):
        ep = ex.exported_program(ex.ModelForward(model, torch.float32), (x,))
        targets = [n.target for n in ep.graph.nodes
                   if n.op == "call_function"]
        calls = targets.count(op.default)
        assert calls == (2 if op is torch.ops.emtpu.lstm_sequence else 1)
        assert not any("autograd" in str(t) for t in targets)


def test_cli_train_export_predict(tmp_path, capsys):
    """The full deployment loop through the product surface: train →
    export → predict --model-type exported."""
    ck = str(tmp_path / "ck")
    rc = port_main(["train", "--model", "mlp", "--html-file", GOLDEN,
                    "--device", "cpu", "--train.epochs=1",
                    "--model.hidden_sizes=8", "--model.compute_dtype=float32",
                    "--save", ck])
    assert rc == 0
    out = str(tmp_path / "exported")
    rc = port_main(["export", "--model", "mlp", "--checkpoint", ck,
                    "--output", out, "--batch", "32", "--device", "cpu",
                    "--model.hidden_sizes=8", "--model.compute_dtype=float32"])
    assert rc == 0
    capsys.readouterr()
    csv = str(tmp_path / "rows.csv")
    rc = port_main(["fetch", "--html-file", GOLDEN, "--output", csv])
    assert rc == 0
    capsys.readouterr()
    rc = port_main(["predict", "--model-type", "exported", "--model-file",
                    out, "--csv", csv, "--has-label", "--device", "cpu"])
    assert rc == 0
    vals = capsys.readouterr().out.strip().splitlines()
    assert len(vals) == 1705  # one prediction per draw row, batch-padded
    assert all(np.isfinite(float(v)) for v in vals)


def test_export_wide_deep_raw_inputs(tmp_path):
    """Models owning their input conversion (cast_inputs=False) export
    with raw float rows — ids must not be cast to the compute dtype."""
    model = build_wide_deep(target_params=200_000, device="cpu")
    x = _rows(4, seed=0)
    out = str(tmp_path / "wd")
    ex.export_model(ex.ModelForward(model, torch.bfloat16), (x,), out,
                    meta={"model": "wide_deep"})
    got = ex.run_torch(out, x, device="cpu")[0]
    with torch.no_grad():
        want = model(torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# -- parity with the JAX package on one checkpoint ----------------------------

@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """Each family trained one epoch by the JAX CLI at small widths."""
    root = tmp_path_factory.mktemp("jax_ck")
    out = {}
    for family, flags in FAMILIES.items():
        ck = str(root / family)
        assert jax_main(["train", "--model", family, "--html-file", GOLDEN,
                         "--train.epochs=1", "--save", ck, *flags]) == 0
        out[family] = ck
    return out


def _export_both(family: str, ck: str, root: pathlib.Path):
    flags = FAMILIES[family]
    jout, tout = str(root / f"{family}_jax"), str(root / f"{family}_port")
    base = ["export", "--model", family, "--checkpoint", ck,
            "--batch", str(BATCH)]
    assert jax_main([*base, "--output", jout, *flags]) == 0
    assert port_main([*base, "--output", tout, "--device", "cpu",
                      *flags]) == 0
    return jout, tout


@pytest.mark.parametrize("family", list(FAMILIES))
def test_run_torch_matches_run_jax(family, jax_checkpoints, tmp_path):
    jout, tout = _export_both(family, jax_checkpoints[family], tmp_path)
    x = _inputs(family)
    want = jax_ex.run_jax(jout, x)[0]
    got = ex.run_torch(tout, x, device="cpu")[0]
    assert got.shape == want.shape and got.dtype == np.float32
    if family == "wide_deep":  # bfloat16 towers in both CLIs
        assert np.abs(got - want).max() <= BF16_FWD_TOL * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _, jman = jax_ex.load_exported(jout)
    _, tman = ex.load_exported(tout)
    assert tman["in_specs"] == jman["in_specs"]
    assert tman["out_specs"] == jman["out_specs"]
    assert sorted(tman["meta"]) == sorted(jman["meta"])
    assert tman["meta"] == jman["meta"]


def test_wide_deep_f32_export_matches_jax(jax_checkpoints, tmp_path):
    """Wide&Deep at float32: the JAX CLI's checkpoint restored in both
    packages, each model rebuilt with f32 towers and exported through the
    API, agrees at the f32 pin."""
    import jax.numpy as jnp

    from euromillioner_tpu.config import Config as JaxConfig
    from euromillioner_tpu.config import apply_overrides as jax_overrides
    from euromillioner_tpu.models import registry as jax_registry
    from euromillioner_tpu.models.wide_deep import \
        build_wide_deep as jax_build_wide_deep
    from euromillioner_tpu_torch.config import Config, apply_overrides
    from euromillioner_tpu_torch.models.registry import restore_for_inference

    flags = [f.lstrip("-") for f in FAMILIES["wide_deep"]] + [
        "model.name=wide_deep"]
    ck = jax_checkpoints["wide_deep"]
    jcfg = jax_overrides(JaxConfig(), flags)
    _m, params, _p, _s, _ck = jax_registry.restore_for_inference(jcfg, ck)
    jm = jax_build_wide_deep(target_params=jcfg.model.wide_deep_target_params,
                             embed_dim=jcfg.model.embed_dim,
                             compute_dtype=jnp.float32)
    x = _rows(BATCH)
    jout = str(tmp_path / "jax")
    jax_ex.export_model(lambda a: jm.apply(params, a).astype(jnp.float32),
                        (x,), jout, meta={"model": "wide_deep"})
    tm, _dt, _shape, _ck = restore_for_inference(
        apply_overrides(Config(), flags), ck, device="cpu")
    tm.compute_dtype = torch.float32
    tout = str(tmp_path / "port")
    ex.export_model(ex.ModelForward(tm, torch.float32), (x,), tout,
                    meta={"model": "wide_deep"})
    want = jax_ex.run_jax(jout, x)[0]
    got = ex.run_torch(tout, x, device="cpu")[0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert jax.device_get(want).shape == (BATCH, 7)


def test_predict_refuses_rows_of_another_shape(jax_checkpoints, tmp_path,
                                               capsys):
    """An LSTM export takes (8, 11) windows: CSV rows are refused with a
    message naming --num-features, as the JAX CLI does."""
    _jout, tout = _export_both("lstm", jax_checkpoints["lstm"], tmp_path)
    csv = str(tmp_path / "rows.csv")
    assert port_main(["fetch", "--html-file", GOLDEN, "--output", csv]) == 0
    with pytest.raises(SystemExit, match="--num-features"):
        port_main(["predict", "--model-type", "exported", "--model-file",
                   tout, "--csv", csv, "--device", "cpu"])


def test_export_and_predict_without_a_card_exit_17(jax_checkpoints, tmp_path,
                                                   monkeypatch):
    """Both entry points run on the card unless asked for the CPU: with no
    card and no ``--device cpu`` they exit 17 before anything is written
    or run."""
    _jout, tout = _export_both("mlp", jax_checkpoints["mlp"], tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "no_card"
    assert port_main(["export", "--model", "mlp", "--checkpoint",
                      jax_checkpoints["mlp"], "--output", str(out),
                      *FAMILIES["mlp"]]) == 17
    assert not out.exists()
    csv = str(tmp_path / "rows.csv")
    assert port_main(["fetch", "--html-file", GOLDEN, "--output", csv]) == 0
    for runtime in ex.RUNTIMES:
        assert port_main(["predict", "--model-type", "exported",
                          "--model-file", tout, "--csv", csv, "--has-label",
                          "--runtime", runtime]) == 17

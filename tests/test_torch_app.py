"""The port's reference pipeline (euromillioner_tpu_torch/app.py) and its
GBT CLI subcommands against the JAX package's, on the CPU, on the golden
results page."""

import json
import pathlib

import numpy as np
import pytest
import torch

from euromillioner_tpu import cli as jax_cli
from euromillioner_tpu.app import run_reference_pipeline as jax_pipeline
from euromillioner_tpu.config import Config as JaxConfig
from euromillioner_tpu.config import apply_overrides as jax_overrides
from euromillioner_tpu.data.csvio import write_csv as jax_write_csv
from euromillioner_tpu.data.pipeline import draws_from_html
from euromillioner_tpu_torch import cli
from euromillioner_tpu_torch.app import run_reference_pipeline
from euromillioner_tpu_torch.config import Config, apply_overrides
from euromillioner_tpu_torch.data.csvio import write_csv
from euromillioner_tpu_torch.serve.session import load_backend
from euromillioner_tpu_torch.serve.transport import row_payloads
from euromillioner_tpu_torch.trees import (Booster, DMatrix, train,
                                           train_classifier, train_regressor)

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "euromillions.html"
ROUNDS = ["gbt.nround=20"]


@pytest.fixture(scope="module")
def html():
    return GOLDEN.read_text()


@pytest.fixture(scope="module")
def jax_run(html):
    return jax_pipeline(jax_overrides(JaxConfig(), ROUNDS), html)


@pytest.mark.parametrize("compat", [False, True], ids=["fixed", "compat"])
def test_pipeline_matches_jax(html, jax_run, compat):
    """Both boosters' trees and predictions and the printed boolean against
    the JAX package's run, and the CSV files byte for byte against its
    writer in the same mode (the compat files cannot be read back, so both
    modes train on the same rows)."""
    port = run_reference_pipeline(
        apply_overrides(Config(), ROUNDS + [f"data.compat_csv={compat}"]),
        html, device="cpu")
    for got, want in ((port.predictions, jax_run.predictions),
                      (port.predictions_test, jax_run.predictions_test)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert port.predicts_equal == jax_run.predicts_equal
    for bst, jbst in ((port.booster, jax_run.booster),
                      (port.booster_test, jax_run.booster_test)):
        assert bst.num_boosted_rounds == jbst.num_boosted_rounds == 20
        for k in ("feature", "split_bin", "is_leaf"):
            np.testing.assert_array_equal(bst.trees[k], jbst.trees[k])
    rows = draws_from_html(html, JaxConfig().data)
    cut = int(0.7 * len(rows))
    for path, part in ((port.train_csv, rows[:cut]),
                       (port.validation_csv, rows[cut:])):
        jax_write_csv(path + ".jax", part, compat=compat)
        assert pathlib.Path(path).read_bytes() == \
            pathlib.Path(path + ".jax").read_bytes()


@pytest.mark.parametrize("compat", [False, True])
def test_write_csv_byte_equal(tmp_path, html, compat):
    rows = draws_from_html(html, JaxConfig().data)[:50] + [[1.5, 2, 3]]
    write_csv(str(tmp_path / "p.csv"), rows, compat=compat)
    jax_write_csv(str(tmp_path / "j.csv"), rows, compat=compat)
    assert (tmp_path / "p.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


# -- the CLI ---------------------------------------------------------------------

def _floats(out: str) -> np.ndarray:
    vals = []
    for ln in out.splitlines():
        try:
            vals.append(float(ln))
        except ValueError:
            pass
    return np.asarray(vals, np.float32)


def test_cli_fetch_train_predict_on_cpu(tmp_path, capsys):
    csv, model = str(tmp_path / "d.csv"), str(tmp_path / "m.json")
    assert cli.main(["fetch", "--html-file", str(GOLDEN), "--output", csv]) == 0
    assert capsys.readouterr().out.strip() == csv
    assert cli.main(["train", "--model", "gbt", "--csv", csv, "--save", model,
                     "--device", "cpu", "gbt.nround=4",
                     "gbt.objective=binary:logistic", "gbt.eta=0.3"]) == 0
    payload = json.loads(pathlib.Path(model).read_text())
    assert len(payload["trees"]["feature"]) == 4
    capsys.readouterr()
    assert cli.main(["predict", "--model-type", "gbt", "--model-file", model,
                     "--csv", csv, "--has-label", "--device", "cpu"]) == 0
    got = _floats(capsys.readouterr().out)
    from euromillioner_tpu_torch.data.csvio import read_csv

    x, _, _ = read_csv(csv, label_column=0)
    want = Booster.load_model(model, device="cpu").predict(DMatrix(x))
    np.testing.assert_array_equal(got, want)


def test_cli_reference_on_cpu(capsys):
    assert cli.main(["reference", "--html-file", str(GOLDEN), "--device",
                     "cpu", "gbt.nround=3"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] in ("True", "False")


@pytest.mark.parametrize("argv,rc", [
    (["reference", "data.url=http://127.0.0.1:9/results"], 10),  # nothing
                                                       # listens: FetchError
    (["fetch", "data.url=http://127.0.0.1:9/results"], 10),  # nothing
                                                       # listens: FetchError
    (["train", "--model", "rf", "--html-file", str(GOLDEN),
      "--distributed", "mesh.model=2"], 15),           # one device: the
                                                       # mesh does not cover
                                                       # it (the JAX CLI's)
    (["train", "--html-file", str(GOLDEN), "gbt.hist_method=matmul"], 13),
    (["train", "--html-file", str(GOLDEN), "gbt.no_such=1"], 2),
])
def test_cli_exit_codes(argv, rc):
    extra = [] if argv[0] == "fetch" else ["--device", "cpu"]
    assert cli.main(argv + extra) == rc


@pytest.mark.parametrize("cmd", ["train", "reference", "predict"])
def test_cli_without_a_card_exits_17(monkeypatch, tmp_path, cmd):
    model = str(tmp_path / "m.json")
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    from euromillioner_tpu_torch.trees import train

    train({"device": "cpu"}, DMatrix(x, x[:, 0] > 9), 1,
          verbose_eval=False).save_model(model)
    write_csv(str(tmp_path / "x.csv"), x, header="a,b")
    argv = {"train": ["train", "--html-file", str(GOLDEN)],
            "reference": ["reference", "--html-file", str(GOLDEN)],
            "predict": ["predict", "--model-file", model, "--csv",
                        str(tmp_path / "x.csv")]}[cmd]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(argv) == 17


# -- the random forest through the CLI ----------------------------------------

RF_ARGV = ["train", "--model", "rf", "--num-classes", "6", "--html-file",
           str(GOLDEN), "forest.bootstrap=false", "forest.feature_subset=all",
           "forest.num_trees=3"]


def test_cli_rf_train_predict_matches_jax_cli(tmp_path, capsys):
    """``train --model rf --num-classes 6 ... --save`` then ``predict
    --model-type rf`` through both CLIs on the same argv (the port's with
    ``--device cpu``): the same trees, the same printed predictions."""
    csv = str(tmp_path / "d.csv")
    assert cli.main(["fetch", "--html-file", str(GOLDEN), "--output",
                     csv]) == 0
    printed = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, [])):
        model = str(tmp_path / f"{name}.json")
        assert main(RF_ARGV + ["--save", model] + extra) == 0
        capsys.readouterr()
        assert main(["predict", "--model-type", "rf", "--model-file", model,
                     "--csv", csv, "--has-label"] + extra) == 0
        printed[name] = capsys.readouterr().out.split()
    trees = [json.loads((tmp_path / f"{n}.json").read_text())["trees"]
             for n in ("port", "jax")]
    assert trees[0] == trees[1]
    assert len(printed["port"]) == 1705
    assert printed["port"] == printed["jax"]


@pytest.fixture(scope="module")
def tree_models(tmp_path_factory):
    """A booster at the CLI's defaults, a forest classifier and a forest
    regressor, saved as model JSON (10 features, as the golden rows)."""
    d = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 10)).astype(np.float32)
    y = (x[:, 0] + x[:, 3] > 0).astype(np.float32)
    paths = {k: str(d / f"{k}.json") for k in ("gbt", "rf", "rf_reg")}
    train({"device": "cpu"}, DMatrix(x, y), 5,
          verbose_eval=False).save_model(paths["gbt"])
    kw = dict(num_trees=5, max_depth=4, device="cpu")
    train_classifier(x, y, 2, **kw).save_model(paths["rf"])
    train_regressor(x, x[:, 1], **kw).save_model(paths["rf_reg"])
    return paths


@pytest.mark.parametrize("model", ["gbt", "rf", "rf_reg"])
def test_cli_serves_tree_models_bit_equal_to_predict(tree_models, capsys,
                                                     model):
    """``serve --model-type gbt|rf --model-file M --smoke 8``: no failed
    request, and every reply (one row each, coalesced and padded by the
    engine) bit-equal to the backend's direct predict of the same rows."""
    family = model.split("_")[0]
    assert cli.main(["serve", "--model-type", family, "--model-file",
                     tree_models[model], "--smoke", "8", "--device",
                     "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["failed"] == 0 and summary["ok"] == 8
    backend = load_backend(family, cfg=Config(), device="cpu",
                           model_file=tree_models[model])
    want = backend.predict(np.concatenate(
        [np.asarray(r, np.float32) for r in row_payloads(8, (10,))]))
    got = np.asarray([p[0] for p in summary["predictions"]],
                     backend.out_dtype)
    assert want.dtype == backend.out_dtype
    np.testing.assert_array_equal(got, want)


# -- Wide&Deep through the CLI -------------------------------------------------

WD_SMALL = ["model.wide_deep_target_params=200000"]


def test_cli_wide_deep_trains_then_serves_on_cpu(tmp_path, capsys):
    """``train --model wide_deep`` as tests/test_app_cli.py drives the JAX
    CLI (one epoch, a 200k-parameter target), then ``serve --model-type
    wide_deep --smoke 8`` on the checkpoint it saved."""
    ck, jsonl = str(tmp_path / "ck"), tmp_path / "train.jsonl"
    assert cli.main(["train", "--model", "wide_deep", "--html-file",
                     str(GOLDEN), "--device", "cpu", "train.epochs=1",
                     f"train.metrics_jsonl={jsonl}", *WD_SMALL, "--save",
                     ck]) == 0
    rounds = [r for r in map(json.loads, jsonl.read_text().splitlines())
              if "round" in r]
    assert len(rounds) == 1
    assert all(np.isfinite(rounds[0][k]) for k in ("train-rmse",
                                                   "test-rmse"))
    capsys.readouterr()
    assert cli.main(["serve", "--model-type", "wide_deep", "--checkpoint",
                     ck, "--smoke", "8", "--device", "cpu", *WD_SMALL]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["failed"] == 0 and summary["ok"] == 8
    assert summary["stats"]["rows"] == 8
    assert np.isfinite(np.asarray(summary["predictions"])).all()


@pytest.mark.parametrize("argv,rc", [
    (["serve", "--model-type", "gbt", "--checkpoint", "x", "--smoke", "2",
      "serve.precision=bf16"], 17),                    # trees serve f32
    (["serve", "--model-type", "wide_deep", "--smoke", "2",
      "serve.precision=int8w"], 16),          # served at int8w: needs a ckpt
    (["serve", "--model-type", "wide_deep", "--smoke", "2"], 16),
])
def test_cli_wide_deep_serve_exit_codes(argv, rc):
    assert cli.main(argv + ["--device", "cpu"]) == rc

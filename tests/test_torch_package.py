"""The port as a package: it stands without jax and without the JAX
package, its entry points refuse to run without a card unless asked for
the CPU, and its CLI serves a checkpoint the JAX package wrote."""

import ast
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from euromillioner_tpu import cli as jax_cli
from euromillioner_tpu.core.precision import from_names
from euromillioner_tpu.models.lstm import build_lstm as jax_build_lstm
from euromillioner_tpu.train.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from euromillioner_tpu.train.optim import from_config
from euromillioner_tpu.train.trainer import Trainer
from euromillioner_tpu_torch import cli
from euromillioner_tpu_torch.app import run_reference_pipeline
from euromillioner_tpu_torch.config import Config, apply_overrides
from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.core.mesh import build_mesh
from euromillioner_tpu_torch.dist.bootstrap import \
    initialize as dist_initialize
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.models.wide_deep import build_wide_deep
from euromillioner_tpu_torch.models.registry import restore_for_inference
from euromillioner_tpu_torch.serve.continuous import load_recurrent_backend
from euromillioner_tpu_torch.serve.session import load_backend
from euromillioner_tpu_torch.trees import DMatrix
from euromillioner_tpu_torch.trees import train as gbt_train
from euromillioner_tpu_torch.trees.gbt import Booster, booster_from_arrays
from euromillioner_tpu_torch.trees.random_forest import (RandomForestModel,
                                                         train_classifier)
from euromillioner_tpu_torch.utils.errors import ConfigError

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "euromillioner_tpu_torch"
TINY = ["model.lstm_hidden=8", "model.lstm_layers=1", "model.seq_len=8",
        "model.compute_dtype=float32"]

# imports every port module and every module chip_smoke.py imports (at
# top level or inside its functions), then reports what got loaded
_PROBE = r"""
import ast, importlib, json, pkgutil, sys
import euromillioner_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
tree = ast.parse(open("chip_smoke.py").read())
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        for a in node.names:
            importlib.import_module(a.name)
    elif isinstance(node, ast.ImportFrom) and node.module:
        importlib.import_module(node.module)
import chip_smoke
print(json.dumps(sorted(sys.modules)))
"""


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env.pop("JAX_PLATFORMS", None)
    return env


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib") or root == "euromillioner_tpu"


def test_forbidden_predicate():
    assert _forbidden("euromillioner_tpu")
    assert _forbidden("euromillioner_tpu.ops.fused_lstm")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert not _forbidden("euromillioner_tpu_torch")
    assert not _forbidden("euromillioner_tpu_torch.ops.fused_lstm")


def test_port_and_chip_smoke_import_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         env=_child_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("serve.continuous", "trees.gbt", "trees.growth", "app",
                 "trees.random_forest",
                 "ops.fused_histogram", "ops.wide_onehot", "models.wide_deep",
                 "serve.engine", "serve.session", "serve.transport",
                 "serve.batcher", "models.mlp", "classic.linear",
                 "classic.naive_bayes", "classic.kmeans", "core.mesh",
                 "dist", "dist.bootstrap", "dist.collectives",
                 "dist.sharded", "dist.param_avg", "dist.failure"):
        assert f"euromillioner_tpu_torch.{name}" in loaded
    assert "chip_smoke" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PKG.rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_source_names_no_jax_module(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert [n for n in names if _forbidden(n)] == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_ck")
    model = jax_build_lstm(hidden=8, num_layers=1)
    tr = Trainer(model, from_config("adam", 1e-3),
                 precision=from_names("float32", "float32"))
    jax_save_checkpoint(str(d), tr.init_state(jax.random.PRNGKey(0),
                                              (8, 11)), step=1)
    return str(d)


@pytest.fixture(scope="module")
def gbt_model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gbt") / "m.json")
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    gbt_train({"device": "cpu"}, DMatrix(x, x[:, 0] > 9), 2,
              verbose_eval=False).save_model(path)
    return path


@pytest.fixture(scope="module")
def rf_model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rf") / "m.json")
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    train_classifier(x, x[:, 0] > 9, 2, num_trees=2, max_depth=2,
                     device="cpu").save_model(path)
    return path


@pytest.mark.parametrize("entry", ["resolve_device", "build_lstm",
                                   "params_from_jax", "restore",
                                   "load_recurrent_backend", "gbt_train",
                                   "gbt_load_model", "booster_from_arrays",
                                   "run_reference_pipeline",
                                   "build_wide_deep", "load_backend",
                                   "rf_train", "rf_load_model",
                                   "load_backend_gbt", "load_backend_rf",
                                   "build_mesh", "dist_initialize"])
def test_entry_points_default_to_cuda_and_refuse_without_it(
        no_cuda, jax_ckpt, gbt_model, rf_model, entry):
    cfg = apply_overrides(Config(), TINY)
    x = np.zeros((4, 2), np.float32)
    calls = {
        "gbt_train": lambda: gbt_train({}, DMatrix(x, x[:, 0]), 1),
        "gbt_load_model": lambda: Booster.load_model(gbt_model),
        "booster_from_arrays": lambda: booster_from_arrays(
            {"max_depth": 1, "objective": "reg:logistic"}, [[0.5], [0.5]],
            {k: [] for k in ("feature", "split_bin", "is_leaf",
                             "leaf_value")}, 0.0),
        "run_reference_pipeline": lambda: run_reference_pipeline(
            html="<html></html>"),
        "resolve_device": lambda: resolve_device(),
        "build_lstm": lambda: build_lstm(8, 1, 7),
        "params_from_jax": lambda: params_from_jax(
            {"w": np.zeros(2, np.float32)}),
        "restore": lambda: restore_for_inference(cfg, jax_ckpt),
        "load_recurrent_backend": lambda: load_recurrent_backend(
            cfg, jax_ckpt),
        "build_wide_deep": lambda: build_wide_deep(
            target_params=200_000),
        "load_backend": lambda: load_backend("wide_deep", jax_ckpt, cfg),
        "rf_train": lambda: train_classifier(x, x[:, 0], 2),
        "rf_load_model": lambda: RandomForestModel.load_model(rf_model),
        "load_backend_gbt": lambda: load_backend("gbt", cfg=cfg,
                                                 model_file=gbt_model),
        "load_backend_rf": lambda: load_backend("rf", cfg=cfg,
                                                model_file=rf_model),
        "build_mesh": lambda: build_mesh(),
        "dist_initialize": lambda: dist_initialize("127.0.0.1:1", 1, 0),
    }
    with pytest.raises(ConfigError, match="--device cpu"):
        calls[entry]()


def test_cli_without_cuda_exits_17(no_cuda, jax_ckpt):
    rc = cli.main(["serve", "--model-type", "lstm", "--checkpoint", jax_ckpt,
                   "--smoke", "2", *TINY])
    assert rc == 17


@pytest.mark.parametrize("argv", [
    ["train", "--model", "wide_deep", "--html-file",
     str(ROOT / "tests" / "golden" / "euromillions.html"),
     "model.wide_deep_target_params=200000"],
    ["serve", "--model-type", "wide_deep", "--checkpoint", "unused",
     "--smoke", "2"],
], ids=["train", "serve"])
def test_wide_deep_cli_without_cuda_exits_17(no_cuda, argv):
    assert cli.main(argv) == 17


@pytest.mark.parametrize("model", ["mlp", "lstm", "wide_deep", "rf"])
def test_train_distributed_without_cuda_exits_17(no_cuda, model):
    """``train --distributed`` defaults to the card (NCCL) and refuses to
    start without one, before any rank or group exists."""
    page = str(ROOT / "tests" / "golden" / "euromillions.html")
    assert cli.main(["train", "--model", model, "--distributed",
                     "--html-file", page]) == 17
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("cmd", ["train", "predict", "reference"])
def test_gbt_cli_without_cuda_exits_17(no_cuda, gbt_model, tmp_path, cmd):
    page = str(ROOT / "tests" / "golden" / "euromillions.html")
    csv = tmp_path / "x.csv"
    csv.write_text("a,b\n1,2\n")
    argv = {"train": ["train", "--model", "gbt", "--html-file", page],
            "predict": ["predict", "--model-type", "gbt", "--model-file",
                        gbt_model, "--csv", str(csv)],
            "reference": ["reference", "--html-file", page]}[cmd]
    assert cli.main(argv) == 17


def test_cli_serves_jax_checkpoint_on_cpu(jax_ckpt):
    """The documented command, as a user runs it, in its own process."""
    out = subprocess.run(
        [sys.executable, "-m", "euromillioner_tpu_torch", "serve",
         "--model-type", "lstm", "--checkpoint", jax_ckpt, "--smoke", "6",
         "--device", "cpu", "serve.precision=fused", *TINY],
        cwd=ROOT, env=_child_env(), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["failed"] == 0 and summary["ok"] == 6
    assert np.isfinite(np.asarray(summary["predictions"])).all()


@pytest.mark.parametrize("argv,rc", [
    (["--model-type", "lstm", "serve.scheduler=continuous"], 0),
    (["--model-type", "lstm", "--scheduler", "continuous",
      "serve.step_blocks=2,8", "serve.profiles=bf16"], 0),
    (["--model-type", "lstm", "serve.profiles=fp8"], 17),
    # a field the port's (and the JAX package's) section lacks
    (["--model-type", "lstm", "serve.preempt.no_such_field=1"], 2),
    (["--model-type", "wide_deep", "--scheduler", "continuous"], 16),
    (["--model-type", "lstm", "serve.precision=bf16"], 0),
    (["--model-type", "lstm", "serve.precision=fp8"], 17),
    (["--model-type", "lstm", "serve.no_such_field=1"], 2),
    # the neural row families take bf16 and restore the checkpoint, which
    # holds an LSTM: a CheckpointError (14), as the JAX CLI exits on the
    # same command
    (["--model-type", "wide_deep", "serve.precision=bf16",
      "model.wide_deep_target_params=200000"], 14),
    (["--model-type", "mlp", "serve.precision=bf16"], 14),
    (["--model-type", "mlp", "serve.profiles=int8w"], 14),
    # classic serves a model JSON at f32 only (JAX CLI: 16 and 17)
    (["--model-type", "classic"], 16),
    (["--model-type", "classic", "serve.precision=int8w"], 17),
    # the step scheduler's governance sections parse as the JAX CLI's;
    # the batch scheduler warns that it has no slots and serves
    (["--model-type", "lstm", "serve.preempt.enabled=true"], 0),
    (["--model-type", "lstm", "--scheduler", "continuous",
      "serve.preempt.enabled=true", "serve.preempt.elastic=true",
      "serve.max_slots=4", "serve.budget.enabled=true",
      "serve.budget.queue_bytes=100000"], 0),
    (["--model-type", "lstm", "--scheduler", "continuous",
      "serve.paging.enabled=true", "serve.paging.page_slots=2"], 0),
    (["--model-type", "lstm", "--scheduler", "continuous",
      "serve.preempt.elastic=true", "serve.paging.enabled=true"], 16),
])
def test_cli_exit_codes(jax_ckpt, argv, rc):
    assert cli.main(["serve", "--checkpoint", jax_ckpt, "--smoke", "2",
                     "--device", "cpu", *TINY, *argv]) == rc


def test_cli_without_smoke_is_a_serve_error(jax_ckpt):
    """Without --smoke, serve binds serve.host:serve.port; an address
    already bound is a ServeError (16), as in the JAX CLI."""
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = taken.getsockname()[1]
        assert cli.main(["serve", "--model-type", "lstm", "--checkpoint",
                         jax_ckpt, "--device", "cpu", f"serve.port={port}",
                         *TINY]) == 16


@pytest.mark.parametrize("extra,rc", [([], 16),
                                      (["serve.precision=bf16"], 17)],
                         ids=["no_model_file", "bf16"])
def test_serve_default_family_exits_as_the_jax_cli(monkeypatch, extra, rc):
    """serve's default family is gbt in both CLIs: without --model-file
    it is a ServeError (16), and at bf16 a ConfigError (17) first. The
    JAX CLI's compile-cache set-up is stubbed out (it would write into the
    working directory); its exit code is what is compared."""
    monkeypatch.setattr("euromillioner_tpu.utils.compile_cache.enable",
                        lambda *a, **k: None)
    argv = ["serve", "--checkpoint", "/nonexistent", "--smoke", "2", *extra]
    assert cli.main(argv) == jax_cli.main(argv) == rc

"""The port's mesh, bootstrap, failure detection and ``train
--distributed`` front door against the JAX package's: ``MeshSpec.resolve``
over a table of cases, ``mesh.*`` overrides, the environment that
``initialize`` reads, the ``model`` and ``seq`` axes resolving as there,
the heartbeat and restart supervisor, and the CLI on the CPU — a group of
one in this process (bit-equal to the plain trainer), two ranks as child
processes, gbt's warning and a failing rank's exit code.
"""

import json
import logging
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from euromillioner_tpu import config as jax_config
from euromillioner_tpu.core.mesh import MeshSpec as JaxMeshSpec
from euromillioner_tpu.dist import failure as jax_failure
from euromillioner_tpu.utils import errors as jax_errors
from euromillioner_tpu_torch import cli
from euromillioner_tpu_torch.config import Config, apply_overrides
from euromillioner_tpu_torch.core.mesh import (Mesh, MeshSpec, build_mesh,
                                               mesh_desc, round_up_multiple)
from euromillioner_tpu_torch.dist import bootstrap, failure
from euromillioner_tpu_torch.utils.errors import (ConfigError,
                                                  DistributedError,
                                                  TrainError)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PAGE = str(ROOT / "tests" / "golden" / "euromillions.html")
ENV_KEYS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
            "LOCAL_RANK", "EUROMILLIONER_CPU_DEVICES")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)


# -- mesh ---------------------------------------------------------------------

@pytest.mark.parametrize("spec,n", [
    ((-1, 1, 1), 8), ((4, 1, 1), 8), ((4, 2, 1), 8), ((-1, 2, 2), 8),
    ((-1, 3, 1), 8), ((-1, -1, 1), 4), ((2, 1, 1), 2), ((3, 1, 1), 4),
    ((-1, 1, 1), 1), ((1, -1, 1), 6), ((2, 2, 2), 8), ((5, 1, 1), 5)])
def test_resolve_matches_jax(spec, n):
    """The same sizes, or DistributedError (exit 15) with the same
    message in both packages."""
    try:
        want = JaxMeshSpec(*spec).resolve(n)
    except jax_errors.DistributedError as e:
        with pytest.raises(DistributedError) as got:
            MeshSpec(*spec).resolve(n)
        assert str(got.value) == str(e)
        assert got.value.exit_code == e.exit_code == 15
    else:
        assert MeshSpec(*spec).resolve(n) == want


def test_mesh_overrides_parse_as_in_jax():
    argv = ["mesh.data=4", "mesh.model=2", "mesh.seq=1"]
    got = MeshSpec.from_config(apply_overrides(Config(), argv).mesh)
    want = JaxMeshSpec.from_config(
        jax_config.apply_overrides(jax_config.Config(), argv).mesh)
    assert (got.data, got.model, got.seq) == (want.data, want.model,
                                              want.seq) == (4, 2, 1)
    assert MeshSpec.from_config(Config().mesh) == MeshSpec(-1, 1, 1)


@pytest.mark.parametrize("spec", [(-1, 2, 1), (-1, 1, 2), (1, -1, 1)])
def test_model_and_seq_axes_resolve_as_in_jax(spec):
    """The specs that were refused before the model and seq axes were
    ported now resolve to the JAX package's sizes, on 8 devices and on 4."""
    for n in (8, 4):
        assert MeshSpec(*spec).resolve(n) == JaxMeshSpec(*spec).resolve(n)


def test_mesh_helpers():
    m = Mesh(data=4, rank=1, device=torch.device("cpu"))
    assert m.shape == {"data": 4, "seq": 1, "model": 1}
    assert mesh_desc(m) == "4x1"
    assert [round_up_multiple(n, 4) for n in (0, 1, 4, 701)] == [0, 4, 4,
                                                                 704]


# -- bootstrap ------------------------------------------------------------------

def test_initialize_without_a_coordinator_is_a_no_op():
    bootstrap.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert bootstrap.is_primary()
    info = bootstrap.runtime_info()
    assert (info.process_index, info.process_count) == (0, 1)


@pytest.mark.parametrize("env,kw,err", [
    ({}, {"num_processes": 2}, DistributedError),
    ({"PROCESS_ID": "0"}, {"process_id": 0}, DistributedError),
    ({"COORDINATOR_ADDRESS": "127.0.0.1:1"}, {}, DistributedError),
    ({"COORDINATOR_ADDRESS": "127.0.0.1:1", "NUM_PROCESSES": "2",
      "PROCESS_ID": "2"}, {}, DistributedError),
    ({}, {"auto": True}, ConfigError),
])
def test_initialize_refuses_a_partial_topology(monkeypatch, env, kw, err):
    """Ids without an address, an address without ids, an id outside the
    group (DistributedError, as the JAX package raises for ids without an
    address) and ``auto`` (TPU pod metadata: ConfigError)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(err):
        bootstrap.initialize(device="cpu", **kw)
    assert not torch.distributed.is_initialized()


def test_jax_initialize_refuses_ids_without_an_address():
    from euromillioner_tpu.dist import bootstrap as jax_bootstrap

    with pytest.raises(jax_errors.DistributedError):
        jax_bootstrap.initialize(num_processes=2)


def test_group_of_one_from_the_environment(monkeypatch):
    """COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID form a gloo group of
    one; the mesh counts its ranks, or EUROMILLIONER_CPU_DEVICES."""
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{cli._free_port()}")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    monkeypatch.setenv("PROCESS_ID", "0")
    with pytest.raises(DistributedError, match="no process group"):
        build_mesh(device="cpu")
    bootstrap.initialize(device="cpu", timeout_s=30)
    try:
        assert torch.distributed.get_backend() == "gloo"
        info = bootstrap.runtime_info()
        assert (info.process_index, info.process_count,
                info.global_device_count, info.platform) == (0, 1, 1, "cpu")
        mesh = build_mesh(MeshSpec(), device="cpu")
        assert (mesh.data, mesh.rank, mesh.device.type) == (1, 0, "cpu")
        with pytest.raises(DistributedError, match="does not cover"):
            build_mesh(MeshSpec(data=2), device="cpu")
        monkeypatch.setenv("EUROMILLIONER_CPU_DEVICES", "2")
        with pytest.raises(DistributedError, match="1 ranks"):
            build_mesh(MeshSpec(), device="cpu")
        with pytest.raises(DistributedError, match="1 ranks"):
            build_mesh(MeshSpec(model=2), device="cpu")
    finally:
        bootstrap.shutdown()
    assert not torch.distributed.is_initialized()


# -- failure detection (the port's own copy of the jax-free module) -----------

@pytest.mark.parametrize("pkg", [failure, jax_failure], ids=["port", "jax"])
def test_heartbeat_and_stale_processes(tmp_path, pkg):
    hb = pkg.Heartbeat(str(tmp_path), "w0", interval_s=0.05).start()
    try:
        time.sleep(0.15)
        assert pkg.stale_processes(str(tmp_path), timeout_s=5.0) == []
    finally:
        hb.stop()
    beat = json.loads((tmp_path / "heartbeat-w0.json").read_text())
    assert beat["name"] == "w0"
    (tmp_path / "heartbeat-w1.json").write_text("{broken")
    assert pkg.stale_processes(str(tmp_path), timeout_s=5.0) == [
        "heartbeat-w1.json"]
    assert sorted(pkg.stale_processes(str(tmp_path), timeout_s=-1.0)) == [
        "heartbeat-w1.json", "w0"]


def test_run_with_restart_as_in_jax():
    for pkg, err in ((failure, TrainError),
                     (jax_failure, jax_errors.TrainError)):
        seen = []

        def fn(attempt):
            seen.append(attempt)
            if attempt < 2:
                raise err("transient")
            return attempt

        assert pkg.run_with_restart(fn, max_restarts=2, backoff_s=0.0) == 2
        assert seen == [0, 1, 2]
        with pytest.raises(err):
            pkg.run_with_restart(lambda a: (_ for _ in ()).throw(err("x")),
                                 max_restarts=1, backoff_s=0.0)
        with pytest.raises(ValueError):
            pkg.run_with_restart(lambda a: (_ for _ in ()).throw(
                ValueError("not retryable")), backoff_s=0.0)


# -- the CLI ---------------------------------------------------------------------

@pytest.mark.parametrize("extra,env,rc", [
    (["mesh.model=2"], {}, 15),
    (["mesh.seq=2"], {}, 15),
    (["--auto-coordinator"], {}, 17),
    (["mesh.data=3"], {"EUROMILLIONER_CPU_DEVICES": "2"}, 15),
    ([], {"EUROMILLIONER_CPU_DEVICES": "two"}, 2),
], ids=["model", "seq", "auto_coordinator", "uncovered", "bad_env"])
def test_distributed_front_door_exit_codes(monkeypatch, extra, env, rc):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert cli.main(["train", "--model", "mlp", "--distributed", "--device",
                     "cpu", "--html-file", PAGE, *extra]) == rc


TINY_LSTM = ["model.lstm_hidden=8", "model.lstm_layers=1", "model.seq_len=8",
             "train.epochs=1"]


def test_group_of_one_in_process_is_bit_equal_to_train(tmp_path, caplog):
    """No coordinator and one device: the group of one runs in this
    process, logs the mesh, and saves the checkpoint a plain ``train``
    saves, bit for bit."""
    base = ["train", "--model", "lstm", "--device", "cpu", "--html-file",
            PAGE, *TINY_LSTM]
    with caplog.at_level(logging.INFO, logger="euromillioner_tpu_torch"):
        assert cli.main([*base, "--distributed", "--save",
                         str(tmp_path / "dp")]) == 0
    assert "device mesh: {'data': 1, 'seq': 1, 'model': 1}" in caplog.text
    assert not torch.distributed.is_initialized()
    assert cli.main([*base, "--save", str(tmp_path / "plain")]) == 0
    dp = (tmp_path / "dp" / "step_00000001" / "arrays-00000.emt")
    plain = (tmp_path / "plain" / "step_00000001" / "arrays-00000.emt")
    assert dp.read_bytes() == plain.read_bytes()


@pytest.mark.parametrize("model,extra,out", [
    ("mlp", ["model.hidden_sizes=16", "train.epochs=1"],
     "step_00000001/arrays-00000.emt"),
    ("wide_deep", ["model.wide_deep_target_params=200000", "train.epochs=1"],
     "step_00000001/arrays-00000.emt"),
    ("rf", ["--num-classes", "6", "forest.num_trees=4",
            "forest.max_depth=3"], None)], ids=["mlp", "wide_deep", "rf"])
def test_group_of_one_cli_is_bit_equal_for_the_row_families(tmp_path, model,
                                                            extra, out):
    """The other families ``train --distributed`` covers, as the LSTM
    above: a group of one in this process writes what the plain ``train``
    writes, bit for bit (the forest's model file; the others' shard)."""
    base = ["train", "--model", model, "--device", "cpu", "--html-file",
            PAGE, *extra]
    assert cli.main([*base, "--distributed", "--save",
                     str(tmp_path / "dp")]) == 0
    assert not torch.distributed.is_initialized()
    assert cli.main([*base, "--save", str(tmp_path / "plain")]) == 0
    dp, plain = tmp_path / "dp", tmp_path / "plain"
    if out is not None:
        dp, plain = dp / out, plain / out
    assert dp.read_bytes() == plain.read_bytes()


def _cli(argv, env, timeout=120):
    full = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **env)
    full.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-m", "euromillioner_tpu_torch",
                           *argv], cwd=ROOT, env=full, capture_output=True,
                          text=True, timeout=timeout)


def test_two_cpu_ranks_train_the_mlp_and_save_one_checkpoint(tmp_path):
    out = _cli(["train", "--model", "mlp", "--distributed", "--device", "cpu",
                "--html-file", PAGE, "model.hidden_sizes=16", "train.epochs=1",
                "model.compute_dtype=float32", "--save",
                str(tmp_path / "ck")], {"EUROMILLIONER_CPU_DEVICES": "2"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "device mesh: {'data': 2, 'seq': 1, 'model': 1}" in out.stdout
    assert out.stdout.count("train-rmse") == 1  # rank 0 alone logs
    steps = list((tmp_path / "ck").iterdir())
    assert [p.name for p in steps] == ["step_00000001"]
    manifest = json.loads((steps[0] / "manifest.json").read_text())
    assert manifest["num_processes"] == 2
    assert sorted(p.name for p in steps[0].iterdir()) == [
        "arrays-00000.emt", "arrays-00001.emt", "manifest.json"]


def test_a_failing_rank_fails_the_run(tmp_path):
    out = _cli(["train", "--model", "mlp", "--distributed", "--device", "cpu",
                "--html-file", str(tmp_path / "missing.html")],
               {"EUROMILLIONER_CPU_DEVICES": "2"})
    assert out.returncode != 0
    assert "exited" in out.stdout


def test_gbt_distributed_warns_and_trains_on_one_device(tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger="euromillioner_tpu_torch"):
        assert cli.main(["train", "--model", "gbt", "--distributed",
                         "--device", "cpu", "--html-file", PAGE,
                         "gbt.nround=2", "--save",
                         str(tmp_path / "m.json")]) == 0
    assert "gbt trains as one single-device program" in caplog.text
    assert json.loads((tmp_path / "m.json").read_text())

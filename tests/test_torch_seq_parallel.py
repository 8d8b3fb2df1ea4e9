"""Sequence parallelism over ``seq`` in the port against the JAX
package's ``seq_parallel_forward`` (the five tests of
``tests/test_seq_parallel.py``): time chunks over the seq ranks, the carry
handed from rank k to k + 1 by an all-reduce inside autograd, the
microbatch pipeline. The forward and its gradients match the JAX
pipelined scan on the same parameters; the flagship trained on the
pipelined scan (``DistributedTrainer(shard_sequence=True)``) matches one
process's scan; the refusals come first with the JAX messages; and
``train --distributed mesh.seq=2`` and ``--tbptt`` under a mesh run on the
CPU.

The ranks are one gloo group of two processes (``tests/torch_dist_worker.py``
case set ``seq``, torch only); a ``slow`` case runs ``data=2, seq=2`` on
four.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.core.mesh import MeshSpec as JaxMeshSpec
from euromillioner_tpu.core.mesh import build_mesh as jax_build_mesh
from euromillioner_tpu.dist.seq_parallel import \
    seq_parallel_forward as jax_seq_parallel_forward
from euromillioner_tpu.models import build_tbptt_lstm as jax_build_tbptt
from euromillioner_tpu_torch.core.mesh import Mesh
from euromillioner_tpu_torch.dist import seq_parallel_forward
from euromillioner_tpu_torch.models.lstm import build_lstm, build_tbptt_lstm
from euromillioner_tpu_torch.utils.errors import DistributedError
from torch_dist_worker import Ranks

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PAGE = str(ROOT / "tests" / "golden" / "euromillions.html")
# the JAX package's pins (tests/test_seq_parallel.py): the forward against
# the single-device stateful forward, the gradients through the chain
FWD_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 2e-4
B, T, F, H, OUT = 8, 24, 5, 16, 3


def _x(b=B, t=T, f=F, seed=0):
    return np.random.default_rng(seed).normal(size=(b, t, f)).astype(
        np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _run(tmp_path_factory, data, seq):
    """(each rank's results, the JAX references) of the ``seq`` case set
    on a (data, 1, seq) mesh."""
    out = tmp_path_factory.mktemp(f"seq_parallel_{data}x{seq}")
    model = jax_build_tbptt(hidden=H, num_layers=2, out_dim=OUT)
    params, _ = model.init(jax.random.PRNGKey(0), (T, F))
    x = _x()
    y = np.random.default_rng(1).normal(size=(B, T, OUT)).astype(np.float32)
    rng = np.random.default_rng(2)
    inputs = {
        "mesh": (data, 1, seq),
        "tbptt": {"hidden": H, "out": OUT, "features": F,
                  "params": jax.device_get(params), "x": x, "y": y,
                  "n_micro": (0, 4)},
        "flagship": {"hidden": 16, "lr": 0.01, "epochs": 1, "batch": 32,
                     "data": (rng.normal(size=(64, 8, 11)).astype(
                         np.float32), rng.normal(size=(64, 7)).astype(
                         np.float32))},
    }
    ranks = Ranks("seq", data * seq, out, inputs)
    try:
        mesh = jax_build_mesh(JaxMeshSpec(data=data, model=1, seq=seq),
                              devices=jax.devices()[:data * seq])
        ref = {f"forward_{n}": np.asarray(jax_seq_parallel_forward(
            mesh, model, params, jnp.asarray(x), n_micro=n))
            for n in (0, 4)}

        def loss(p):
            o = jax_seq_parallel_forward(mesh, model, p, jnp.asarray(x))
            return jnp.mean((o - y) ** 2)

        ref["grads"] = _flat(jax.device_get(jax.jit(jax.grad(loss))(params)))
        results = ranks.results()
    finally:
        ranks.close()
    return results, ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _run(tmp_path_factory, 1, 2)


def _block(full, res, data, seq):
    i, j = res["block"]
    b, t = full.shape[0] // data, full.shape[1] // seq
    return full[i * b:(i + 1) * b, j * t:(j + 1) * t]


def test_forward_matches_jax(run):
    results, ref = run
    for res in results:
        np.testing.assert_allclose(res["forward_0"],
                                   _block(ref["forward_0"], res, 1, 2),
                                   atol=FWD_TOL, rtol=FWD_TOL)


def test_forward_matches_with_more_microbatches(run):
    results, ref = run
    for res in results:
        np.testing.assert_allclose(res["forward_4"],
                                   _block(ref["forward_4"], res, 1, 2),
                                   atol=FWD_TOL, rtol=FWD_TOL)
        np.testing.assert_allclose(res["forward_4"], res["forward_0"],
                                   atol=FWD_TOL, rtol=FWD_TOL)


def test_gradients_flow_through_the_carry_handoff(run):
    """The gradients of the mean squared error through the pipeline match
    ``jax.grad`` through the JAX one, the cross-chunk paths included (a
    broken backward of the hand-off would zero them)."""
    results, ref = run
    for res in results:
        assert set(res["grads"]) == set(ref["grads"])
        for k, v in ref["grads"].items():
            np.testing.assert_allclose(res["grads"][k], v, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=k)


def test_flagship_trains_on_the_pipeline_as_one_process(run):
    """``DistributedTrainer(shard_sequence=True)``: the flagship's LSTMs on
    the pipelined scan, the last step broadcast from the last seq rank,
    against one process's scan, at the gradient pin."""
    results, _ = run
    for res in results:
        got = res["flagship"]
        for k, v in got["plain"].items():
            np.testing.assert_allclose(got["sp"][k], v, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=k)
        np.testing.assert_allclose(got["eval"]["rmse"],
                                   got["plain_eval"]["rmse"], rtol=GRAD_RTOL)
    for k, v in results[0]["flagship"]["sp"].items():
        np.testing.assert_array_equal(results[1]["flagship"]["sp"][k], v)


def _mesh(data=2, model=1, seq=4):
    return Mesh(data=data, rank=0, device=torch.device("cpu"), model=model,
                seq=seq)


def test_validation_errors():
    """The JAX refusals, before any collective: T the seq axis does not
    divide, B not a multiple of data x microbatches, an LSTM without
    return_sequences, a model axis, an active Dropout."""
    gen = torch.Generator().manual_seed(0)
    model = build_tbptt_lstm(hidden=H, num_layers=2, out_dim=OUT,
                             in_features=F, generator=gen, device="cpu")
    x = torch.from_numpy(_x())
    with pytest.raises(DistributedError, match="not divisible by seq"):
        seq_parallel_forward(_mesh(), model, None,
                             torch.from_numpy(_x(t=22)))
    with pytest.raises(DistributedError, match="batch"):
        seq_parallel_forward(_mesh(), model, None,
                             torch.from_numpy(_x(b=6)))
    plain = build_lstm(hidden=H, num_layers=1, out_dim=OUT, in_features=F,
                       fused="off", device="cpu")
    with pytest.raises(DistributedError, match="return_sequences"):
        seq_parallel_forward(_mesh(), plain, None, x)
    with pytest.raises(DistributedError, match="model=1"):
        seq_parallel_forward(_mesh(2, 2, 2), model, None, x)
    dropout = build_tbptt_lstm(hidden=8, num_layers=2, out_dim=OUT,
                               in_features=F, dropout=0.5, device="cpu")
    with pytest.raises(DistributedError, match="Dropout"):
        seq_parallel_forward(_mesh(), dropout, None, x)


@pytest.mark.slow
def test_data_and_seq_axes_together(tmp_path_factory):
    """data=2 x seq=2 on four ranks: the forward and the gradients."""
    results, ref = _run(tmp_path_factory, 2, 2)
    for res in results:
        np.testing.assert_allclose(res["forward_0"],
                                   _block(ref["forward_0"], res, 2, 2),
                                   atol=FWD_TOL, rtol=FWD_TOL)
        for k, v in ref["grads"].items():
            np.testing.assert_allclose(res["grads"][k], v, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=k)


# -- the CLI -----------------------------------------------------------------------

def _cli(argv, env, timeout=120):
    full = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **env)
    full.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-m", "euromillioner_tpu_torch",
                           *argv], cwd=ROOT, env=full, capture_output=True,
                          text=True, timeout=timeout)


TINY = ["model.lstm_hidden=8", "model.lstm_layers=2", "model.seq_len=8",
        "train.epochs=1", "data.batch_size=128",
        "model.compute_dtype=float32"]


def test_cli_trains_the_lstm_at_seq_2(tmp_path):
    out = _cli(["train", "--model", "lstm", "--distributed", "--device",
                "cpu", "--html-file", PAGE, "mesh.data=1", "mesh.seq=2",
                *TINY, "--save", str(tmp_path / "ck")],
               {"EUROMILLIONER_CPU_DEVICES": "2"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "device mesh: {'data': 1, 'seq': 2, 'model': 1}" in out.stdout
    assert out.stdout.count("train-rmse") == 1
    assert (tmp_path / "ck" / "step_00000001" / "manifest.json").exists()


@pytest.mark.parametrize("extra,env,rc", [
    (["mesh.seq=2"], {"EUROMILLIONER_CPU_DEVICES": "2"}, 0),
    (["mesh.data=3"], {"EUROMILLIONER_CPU_DEVICES": "2"}, 15),
], ids=["covered", "uncovered"])
def test_cli_tbptt_under_a_mesh_warns_and_trains_on_one_device(
        tmp_path, extra, env, rc):
    """As the JAX CLI: a mesh its devices cover is built, then ignored
    with a warning; one they do not cover fails first (exit 15)."""
    out = _cli(["train", "--model", "lstm", "--tbptt", "--distributed",
                "--device", "cpu", "--html-file", PAGE, *extra,
                "model.lstm_hidden=8", "train.epochs=1",
                "train.tbptt_chunk_len=50"], env)
    assert out.returncode == rc, out.stdout + out.stderr
    if rc == 0:
        assert "--tbptt trains as one single-device program; mesh " \
               "ignored" in out.stdout


@pytest.mark.slow
def test_cli_trains_the_lstm_on_all_three_axes(tmp_path):
    """data=2 x seq=2 x model=2 on eight CPU ranks (the JAX CLI's
    distributed recipe)."""
    out = _cli(["train", "--model", "lstm", "--distributed", "--device",
                "cpu", "--html-file", PAGE, "mesh.data=2", "mesh.seq=2",
                "mesh.model=2", *TINY], {"EUROMILLIONER_CPU_DEVICES": "8"},
               timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "device mesh: {'data': 2, 'seq': 2, 'model': 2}" in out.stdout

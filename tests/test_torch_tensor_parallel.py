"""Tensor parallelism over ``model`` in the port against the JAX
package's: ``shard_params`` placing the same trees leaf for leaf (which
leaves split, on which dim, the row-parallel fallback and the warning),
the MLP trained on two ranks at ``model=2`` against the JAX
``DistributedTrainer`` at (4, 2), an SGD step of Wide&Deep on its own
layout (K4a/K4b on the table's column shards), the LSTM with its shards
gathered whole, sharded checkpoints (saved global, restored onto the mesh
bit-equal, loaded by the one-device port and by the JAX package) and
``train --distributed mesh.model=2`` on the CPU.

The ranks are one gloo group of two processes (``tests/torch_dist_worker.py``
case set ``tp``, torch only) while pytest runs the JAX references on its
virtual CPU devices; parameters start as the JAX package initialised them.
"""

import json
import logging
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
from euromillioner_tpu.core.mesh import shard_params as jax_shard_params
from euromillioner_tpu.core.precision import Precision as JaxPrecision
from euromillioner_tpu.data.dataset import Dataset as JaxDataset
from euromillioner_tpu.dist import DistributedTrainer as JaxDistTrainer
from euromillioner_tpu.dist.sharded import \
    GENERIC_TP_RULES as JAX_GENERIC_RULES
from euromillioner_tpu.models.lstm import build_lstm as jax_build_lstm
from euromillioner_tpu.models.mlp import build_mlp as jax_build_mlp
from euromillioner_tpu.models.wide_deep import \
    build_wide_deep as jax_build_wide_deep
from euromillioner_tpu.train import checkpoint as jax_ck
from euromillioner_tpu.train.optim import sgd as jax_sgd
from euromillioner_tpu.train.trainer import Trainer as JaxTrainer
from euromillioner_tpu_torch.core.mesh import (Mesh, P, shard_params,
                                               shard_specs)
from euromillioner_tpu_torch.dist import GENERIC_TP_RULES, tp_rules_for
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.mlp import build_mlp
from euromillioner_tpu_torch.models.wide_deep import build_wide_deep
from euromillioner_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                      load_checkpoint,
                                                      load_train_state)
from euromillioner_tpu_torch.train.optim import sgd
from euromillioner_tpu_torch.train.trainer import Trainer
from torch_dist_worker import Ranks

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PAGE = str(ROOT / "tests" / "golden" / "euromillions.html")
# the JAX package's TP pin against one device (tests/test_dist.py
# ::test_tp_sharded_params_and_parity)
TP_RTOL, TP_ATOL = 2e-5, 2e-6
F32 = JaxPrecision(param_dtype=jnp.float32, compute_dtype=jnp.float32)
MLP = {"hidden": (16, 16), "features": 11, "lr": 0.05, "epochs": 3,
       "batch": 32}
LSTM = {"hidden": 16, "layers": 2, "lr": 0.01, "batch": 32}
WD = {"kw": {"target_params": 300_000, "embed_dim": 8,
             "hidden_sizes": (16,)}, "lr": 0.01, "batch": 32}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _regression_ds(n=96, f=11, seed=0):
    """The JAX package's TP test data (tests/test_dist.py)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=(f,)).astype(np.float32)
    y = x @ w + 0.1 * rng.normal(size=(n,)).astype(np.float32)
    return x, y


def _rows(b, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.stack([rng.integers(1, 8, b), rng.integers(1, 13, b),
                  rng.integers(1, 29, b), rng.integers(2004, 2021, b)], 1),
        rng.integers(1, 51, size=(b, 5)), rng.integers(1, 13, size=(b, 2)),
    ], axis=1).astype(np.float32)


# -- shard_params against the JAX package's -----------------------------------

def _port_mesh(data, model, model_rank=0):
    return Mesh(data=data, rank=0, device=torch.device("cpu"), model=model,
                model_rank=model_rank)


def _jax_trees():
    """(name, JAX params, the JAX rules, the port rules) of the trees both
    packages place."""
    mlp = jax_build_mlp((16, 16), out_dim=1)
    narrow = jax_build_mlp((15,), out_dim=1)
    lstm = jax_build_lstm(hidden=16, num_layers=2, fused="off")
    wd = jax_build_wide_deep(target_params=400_000, hidden_sizes=(64, 32))
    port_wd = build_wide_deep(target_params=400_000, hidden_sizes=(64, 32),
                              device="cpu")
    key = jax.random.PRNGKey(1)
    return [
        ("mlp", mlp.init(key, (11,))[0], JAX_GENERIC_RULES,
         GENERIC_TP_RULES),
        ("narrow_mlp", narrow.init(key, (10,))[0], JAX_GENERIC_RULES,
         GENERIC_TP_RULES),
        ("lstm", lstm.init(key, (8, 11))[0], JAX_GENERIC_RULES,
         GENERIC_TP_RULES),
        ("wide_deep", wd.init(key, (11,))[0], wd.sharding_rules(),
         tp_rules_for(port_wd)),
    ]


@pytest.fixture(scope="module")
def trees():
    return _jax_trees()


@pytest.mark.parametrize("axes", [(4, 2), (1, 4)], ids=["4x2", "1x4"])
def test_shard_params_places_leaves_as_jax(trees, axes, caplog):
    """The same leaves split, on the same dims, to the same shard shapes;
    a leaf no candidate divides replicates with the same warning."""
    data, model = axes
    jmesh = jax_build_mesh(JaxMeshSpec(data=data, model=model),
                           devices=jax.devices()[:data * model])
    for name, jparams, jrules, rules in trees:
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            placed = jax_shard_params(jparams, jmesh, jrules)
            jax_warned = caplog.text.count("replicating (tensor")
            caplog.clear()
            tree = params_from_jax(jax.device_get(jparams), device="cpu")
            mesh = _port_mesh(data, model, model_rank=model - 1)
            specs = shard_specs(tree, mesh, rules)
            port_warned = caplog.text.count("replicating (tensor")
        local = shard_params(tree, mesh, rules)
        assert port_warned == jax_warned, name
        want = {"/".join(str(getattr(k, "key", k)) for k in path).replace(
            "/", "."): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(placed)[0]}
        assert set(want) == set(specs), name
        for k, leaf in want.items():
            jspec = tuple(leaf.sharding.spec)
            assert tuple(specs[k]) == jspec, (name, k)
            assert tuple(local[k].shape) == tuple(
                leaf.sharding.shard_shape(leaf.shape)), (name, k)
            assert local[k].is_contiguous()
            # this rank's block: the last along each split dim
            full = tree[k]
            for dim, entry in enumerate(specs[k]):
                if entry:
                    w = full.shape[dim] // model
                    full = full.narrow(dim, (model - 1) * w, w)
            assert torch.equal(local[k], full), (name, k)


def test_fallback_and_warning_cases(trees, caplog):
    """The narrow MLP's (10, 15) kernel falls back to row-parallel, its
    (15, 1) head divides no candidate and replicates with the warning; an
    explicit all-None spec places a leaf whole without one."""
    _, jparams, _, rules = trees[1]
    tree = params_from_jax(jax.device_get(jparams), device="cpu")
    with caplog.at_level(logging.WARNING):
        specs = shard_specs(tree, _port_mesh(4, 2), rules)
    assert specs["0_Dense.kernel"] == P("model", None)
    assert specs["1_Dense.kernel"] == P()
    assert "param 1_Dense.kernel (15, 1) does not divide" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        specs = shard_specs(tree, _port_mesh(4, 2),
                            [("kernel", P(None, None))])
    assert specs["0_Dense.kernel"] == P(None, None) and not caplog.text


def test_batch_and_replicated_specs_match_jax():
    from euromillioner_tpu.core.mesh import batch_sharding as jax_batch
    from euromillioner_tpu.core.mesh import replicated as jax_replicated

    from euromillioner_tpu_torch.core.mesh import batch_sharding, replicated

    jmesh = jax_build_mesh(JaxMeshSpec(data=2, model=1, seq=2),
                           devices=jax.devices()[:4])
    mesh = _port_mesh(2, 1)
    for ndim, seq_axis in ((2, None), (3, None), (3, 1)):
        assert tuple(batch_sharding(mesh, ndim, seq_axis)) == tuple(
            jax_batch(jmesh, ndim, seq_axis).spec)
    assert tuple(replicated(mesh)) == tuple(jax_replicated(jmesh).spec)


def _norm(rules, spec_cls):
    """Rules as (pattern, [candidate spec tuples])."""
    return [(pat, [tuple(c)] if isinstance(c, spec_cls)
             else [tuple(x) for x in c]) for pat, c in rules]


def test_rules_are_the_jax_rules():
    from jax.sharding import PartitionSpec as JaxP

    assert _norm(GENERIC_TP_RULES, P) == _norm(JAX_GENERIC_RULES, JaxP)
    wd = build_wide_deep(target_params=300_000, embed_dim=8,
                         hidden_sizes=(16,), device="cpu")
    jwd = jax_build_wide_deep(target_params=300_000, embed_dim=8,
                              hidden_sizes=(16,))
    assert _norm(tp_rules_for(wd), P) == _norm(jwd.sharding_rules(), JaxP)


# -- two ranks at model=2 ---------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(each rank's results, the JAX references, the output directory)."""
    out = tmp_path_factory.mktemp("tensor_parallel")
    x, y = _regression_ds()
    jmesh = jax_build_mesh(JaxMeshSpec(data=4, model=2),
                           devices=jax.devices()[:8])
    jdt = JaxDistTrainer(jax_build_mlp(MLP["hidden"], out_dim=1),
                         jax_sgd(MLP["lr"]), loss="mse", precision=F32,
                         mesh=jmesh)
    jstate = jdt.init_state(jax.random.PRNGKey(7), (MLP["features"],))
    mlp_params = jax.device_get(jstate.params)
    wd_model = jax_build_wide_deep(compute_dtype=jnp.float32, **WD["kw"])
    wd_params, _ = wd_model.init(jax.random.PRNGKey(3), (11,))
    wd_params = jax.device_get(wd_params)
    wd_data = (_rows(WD["batch"], 4), np.random.default_rng(6).normal(
        size=(WD["batch"], 7)).astype(np.float32))
    rng = np.random.default_rng(8)
    inputs = {
        "mesh": (1, 2, 1), "ckpt_out": str(out / "tp_ckpt"),
        "mlp": dict(MLP, data=(x, y), params=mlp_params),
        "lstm": dict(LSTM, data=(rng.normal(size=(64, 8, 11)).astype(
            np.float32), rng.normal(size=(64, 7)).astype(np.float32))),
        "wide_deep": dict(WD, data=wd_data, params=wd_params),
    }
    ranks = Ranks("tp", 2, out, inputs)
    try:
        ref = {}
        ds = JaxDataset(x=x, y=y)
        s = jdt.fit(jstate, ds, epochs=MLP["epochs"],
                    batch_size=MLP["batch"], shuffle=False)
        ref["mlp"] = {"params": _flat(jax.device_get(s.params)),
                      "eval": jdt.evaluate(s.params, ds, MLP["batch"]),
                      "predict": jdt.predict(s.params, ds, MLP["batch"])}
        jt = JaxTrainer(wd_model, jax_sgd(WD["lr"]), loss="mse",
                        precision=F32)
        ws = jt.init_state(jax.random.PRNGKey(3), (11,))
        ws = ws.replace(params=jax.tree.map(jnp.asarray, wd_params)) \
            if hasattr(ws, "replace") else type(ws)(
                params=jax.tree.map(jnp.asarray, wd_params),
                opt_state=ws.opt_state, step=ws.step)
        ws = jt.fit(ws, JaxDataset(*wd_data), epochs=1,
                    batch_size=WD["batch"], shuffle=False)
        ref["wide_deep"] = _flat(jax.device_get(ws.params))
        results = ranks.results()
    finally:
        ranks.close()
    return results, ref, out


def test_tp_mlp_matches_the_jax_distributed_trainer(run):
    """model=2 on two ranks against the JAX trainer at (4, 2): params,
    the watch metric and predictions at the JAX TP pin."""
    results, ref, _ = run
    for res in results:
        got = res["mlp"]
        for k, v in ref["mlp"]["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=TP_RTOL,
                                       atol=TP_ATOL, err_msg=k)
        np.testing.assert_allclose(got["eval"]["rmse"],
                                   ref["mlp"]["eval"]["rmse"], rtol=TP_RTOL)
        np.testing.assert_allclose(got["predict"], ref["mlp"]["predict"],
                                   rtol=TP_RTOL, atol=TP_ATOL)


def test_tp_ranks_hold_their_shards(run):
    """Each rank holds half of every kernel (column-parallel) and the
    ranks agree on the joined params bit for bit."""
    results, _, _ = run
    local = results[0]["mlp"]["local"]
    assert local["0_Dense.kernel"] == (11, 8)
    assert local["1_Dense.kernel"] == (16, 8)
    assert local["2_Dense.kernel"] == (8, 1)   # (16, 1): row-parallel
    assert local["0_Dense.bias"] == (16,)      # no rule: replicated
    assert results[0]["mlp"]["dims"]["2_Dense.kernel"] == 0
    for k, v in results[0]["mlp"]["params"].items():
        np.testing.assert_array_equal(results[1]["mlp"]["params"][k], v)


def test_tp_wide_deep_step_matches_jax(run):
    """One SGD step of Wide&Deep (f32 towers) on its own layout: the wide
    table split by columns (K4a/K4b's plain versions at the shard width),
    wide_proj by rows, the head row-parallel; against the JAX Trainer."""
    results, ref, _ = run
    got = results[0]["wide_deep"]
    dims = got["dims"]
    assert (dims["wide_table"], dims["wide_proj"], dims["ball_embed"],
            dims["field_embed.0"]) == (1, 0, 1, None)
    e = ref["wide_deep"]["wide_table"].shape[1]
    assert got["local"]["wide_table"][1] == e // 2
    for k, v in ref["wide_deep"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=TP_RTOL,
                                   atol=TP_ATOL, err_msg=k)
        np.testing.assert_array_equal(
            results[1]["wide_deep"]["params"][k], got["params"][k])


def test_tp_lstm_gathers_whole_weights_bit_equal_to_one_process(run):
    results, _, _ = run
    for res in results:
        assert res["lstm"]["dims"]["0_LSTM.wx"] == 1
        assert res["lstm"]["dims"]["0_LSTM.wh"] == 1
        for k, v in res["lstm"]["plain"].items():
            np.testing.assert_array_equal(res["lstm"]["tp"][k], v,
                                          err_msg=k)


def test_tp_checkpoint_restores_onto_the_mesh_bit_equal(run):
    results, _, _ = run
    for res in results:
        ck = res["ckpt"]
        assert ck["step"] == 9
        for k, v in ck["before"].items():
            np.testing.assert_array_equal(ck["after"][k], v, err_msg=k)
        assert ck["opt_before"] == ck["opt_after"] == ()  # sgd


def test_tp_checkpoint_loads_in_the_port_and_in_jax(run):
    """The checkpoint holds the global leaves under the JAX names and
    shapes: the one-device port and the JAX package load it whole."""
    results, _, out = run
    path = latest_checkpoint(str(out / "tp_ckpt"))
    assert path is not None
    manifest = json.loads((pathlib.Path(path) / "manifest.json").read_text())
    assert manifest["num_processes"] == 2
    want = results[0]["mlp"]["params"]
    model = build_mlp(MLP["hidden"], out_dim=1, in_features=MLP["features"],
                      device="cpu")
    plain = Trainer(model, sgd(MLP["lr"]))
    state = load_train_state(path, plain.init_state())
    for k, v in want.items():
        np.testing.assert_array_equal(state.params[k].numpy(), v,
                                      err_msg=k)
    jt = JaxTrainer(jax_build_mlp(MLP["hidden"], out_dim=1),
                    jax_sgd(MLP["lr"]), precision=F32)
    like = jt.init_state(jax.random.PRNGKey(0), (MLP["features"],))
    restored = _flat(jax.device_get(jax_ck.load_checkpoint(path,
                                                           like).params))
    for k, v in want.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)


# -- the CLI -----------------------------------------------------------------------

def _cli(argv, env, timeout=120):
    full = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **env)
    full.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-m", "euromillioner_tpu_torch",
                           *argv], cwd=ROOT, env=full, capture_output=True,
                          text=True, timeout=timeout)


def test_cli_trains_the_mlp_at_model_2(tmp_path):
    out = _cli(["train", "--model", "mlp", "--distributed", "--device",
                "cpu", "--html-file", PAGE, "mesh.data=1", "mesh.model=2",
                "model.hidden_sizes=16", "train.epochs=1",
                "model.compute_dtype=float32", "--save",
                str(tmp_path / "ck")], {"EUROMILLIONER_CPU_DEVICES": "2"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "device mesh: {'data': 1, 'seq': 1, 'model': 2}" in out.stdout
    assert out.stdout.count("train-rmse") == 1  # rank 0 alone logs
    params = load_checkpoint(latest_checkpoint(str(tmp_path / "ck")))
    model = build_mlp((16,), out_dim=1, in_features=10, device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}

"""The port's data-parallel layer on four gloo ranks against the JAX
package's on four of its virtual CPU devices: collectives, the
data-parallel trainer (MLP, LSTM, Wide&Deep; a padded last batch),
parameter averaging and checkpoints written by two ranks.

One group of four rank processes (``tests/torch_dist_worker.py``, torch
only) runs every port case once per module while this process runs the
JAX references; parameters start as the JAX package initialised them
(``models/convert.params_from_jax``). Each rank waits on its peers at
most ``GROUP_TIMEOUT_S`` and the whole set at most ``LAUNCH_TIMEOUT_S``;
every rank still alive is killed in ``finally``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.core.mesh import MeshSpec as JaxMeshSpec
from euromillioner_tpu.core.mesh import build_mesh as jax_build_mesh
from euromillioner_tpu.core.precision import Precision as JaxPrecision
from euromillioner_tpu.data.dataset import Dataset as JaxDataset
from euromillioner_tpu.dist import DistributedTrainer as JaxDistTrainer
from euromillioner_tpu.dist import fit_parameter_averaging as jax_param_avg
from euromillioner_tpu.dist import psum_stacked as jax_psum
from euromillioner_tpu.dist import tree_aggregate as jax_tree_aggregate
from euromillioner_tpu.dist.collectives import pmean_stacked as jax_pmean
from euromillioner_tpu.dist.collectives import shard_stacked
from euromillioner_tpu.models.lstm import build_lstm as jax_build_lstm
from euromillioner_tpu.models.mlp import build_mlp as jax_build_mlp
from euromillioner_tpu.models.wide_deep import \
    build_wide_deep as jax_build_wide_deep
from euromillioner_tpu.train import checkpoint as jax_ck
from euromillioner_tpu.train.optim import sgd as jax_sgd
from euromillioner_tpu.train.trainer import Trainer as JaxTrainer
from euromillioner_tpu.utils.errors import DistributedError as JaxDistError
from torch_dist_worker import Ranks

torch.set_num_threads(2)

WORLD = 4
# the JAX package's own pin for data parallelism against one device
# (tests/test_dist.py::test_dp_matches_single_device)
DP_RTOL, DP_ATOL = 2e-5, 2e-6
# parameter averaging against the JAX package's (its single-worker pin)
PA_RTOL, PA_ATOL = 1e-5, 1e-6
# Wide&Deep's towers compute in bfloat16 on both sides, and a bias
# gradient's batch sum rounds to bf16 one ulp apart in XLA and in PyTorch
# (tests/test_torch_wide_deep.py); 12 sgd steps carry that into the
# params. Measured on 4 ranks against 4 devices: the biases 6.0e-3 of
# their scale (deep.0), every weight at most 1.2e-4. Pinned at the bf16
# step pin of adam's first moments there: two bf16 ulps, 2^-6
WD_REL_TOL = 2.0 ** -6
TINY_WD = {"target_params": 300_000, "embed_dim": 8, "hidden_sizes": (16,)}
F32 = JaxPrecision(param_dtype=jnp.float32, compute_dtype=jnp.float32)
BF16 = JaxPrecision(compute_dtype=jnp.bfloat16)

TRAINERS = {
    "mlp": {"family": "mlp", "hidden": (16,), "features": 10,
            "dtype": "float32", "opt": "sgd", "lr": 0.05, "epochs": 3,
            "batch": 32, "solo": True, "errors": True, "checkpoint": True},
    "lstm": {"family": "lstm", "hidden": 16, "layers": 2,
             "dtype": "float32", "opt": "sgd", "lr": 0.01, "epochs": 3,
             "batch": 32, "solo": True},
    "wide_deep": {"family": "wide_deep", "kw": TINY_WD,
                  "dtype": "bfloat16", "opt": "sgd", "lr": 0.01,
                  "epochs": 3, "batch": 32},
}
PARAM_AVG = {"hidden": (8,), "features": 10, "lr": 0.05, "epochs": 2,
             "batch": 16}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _rows(b, seed):
    """Featurized 11-column rows (dow, month, day, year, 5 balls, 2
    stars), as Wide&Deep reads them."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.stack([rng.integers(1, 8, b), rng.integers(1, 13, b),
                  rng.integers(1, 29, b), rng.integers(2004, 2021, b)], 1),
        rng.integers(1, 51, size=(b, 5)), rng.integers(1, 13, size=(b, 2)),
    ], axis=1).astype(np.float32)


def _data(name, n=100, seed=0):
    """n rows (the last batch of 32 holds 4: padded under mask 0)."""
    rng = np.random.default_rng(seed)
    if name == "mlp":
        x = rng.normal(size=(n, 10)).astype(np.float32)
        y = (x @ rng.normal(size=10) + 0.1 * rng.normal(size=n))
        return x, y.astype(np.float32)
    if name == "lstm":
        return (rng.normal(size=(n, 8, 11)).astype(np.float32),
                rng.normal(1.0, 2.0, size=(n, 7)).astype(np.float32))
    return _rows(n, seed), rng.normal(size=(n, 7)).astype(np.float32)


def _jax_trainer(name, mesh=None):
    spec = TRAINERS[name]
    if name == "mlp":
        model, in_shape = jax_build_mlp(spec["hidden"], out_dim=1), (10,)
    elif name == "lstm":
        model = jax_build_lstm(hidden=16, num_layers=2, fused="off")
        for _, layer in model.named_layers():  # rolled: a smaller program
            if hasattr(layer, "unroll"):
                layer.unroll = 1
        in_shape = (8, 11)
    else:
        model, in_shape = jax_build_wide_deep(**TINY_WD), (11,)
    precision = F32 if spec["dtype"] == "float32" else BF16
    kw = dict(loss="mse", precision=precision)
    trainer = (JaxDistTrainer(model, jax_sgd(spec["lr"]), mesh=mesh, **kw)
               if mesh is not None else JaxTrainer(model, jax_sgd(spec["lr"]),
                                                   **kw))
    return trainer, in_shape


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(each rank's results, the JAX references, the output directory)."""
    out = tmp_path_factory.mktemp("dist_train")
    mesh = jax_build_mesh(JaxMeshSpec(data=WORLD),
                          devices=jax.devices()[:WORLD])
    rng = np.random.default_rng(5)
    inputs = {
        "stacked": {"a": rng.normal(size=(WORLD, 3)).astype(np.float32),
                    "b": rng.normal(size=(WORLD, 2, 2)).astype(np.float32)},
        "ids": rng.integers(0, 4, size=(WORLD, 16)).astype(np.int32),
        "trainers": TRAINERS, "params": {}, "data": {},
        "ckpt_out": str(out / "port_ckpt"),
        "subgroup_ckpt": str(out / "subgroup_ckpt"),
    }
    jax_states = {}
    for name in TRAINERS:
        trainer, in_shape = _jax_trainer(name, mesh)
        state = trainer.init_state(jax.random.PRNGKey(7), in_shape)
        inputs["params"][name] = jax.device_get(state.params)
        inputs["data"][name] = _data(name)
        jax_states[name] = (trainer, state)
    # a JAX TrainState checkpoint of the MLP, for the ranks to restore
    plain, _ = _jax_trainer("mlp")
    jstate = plain.init_state(jax.random.PRNGKey(11), (10,))
    inputs["jax_ckpt"] = jax_ck.save_checkpoint(str(out / "jax_ckpt"),
                                                jstate, step=1)
    pa_trainer = JaxTrainer(jax_build_mlp(PARAM_AVG["hidden"], out_dim=1),
                            jax_sgd(PARAM_AVG["lr"]), precision=F32)
    pa_state = pa_trainer.init_state(jax.random.PRNGKey(3), (10,))
    pa_data = _data("mlp", n=128, seed=9)
    inputs["param_avg"] = dict(PARAM_AVG, data=pa_data,
                               params=jax.device_get(pa_state.params))

    ranks = Ranks("train", WORLD, out, inputs)
    try:
        ref = {"inputs": inputs, "jax_ckpt_state": jax.device_get(jstate)}
        for name, (trainer, state) in jax_states.items():
            ds = JaxDataset(*inputs["data"][name])
            batch = TRAINERS[name]["batch"]
            state = trainer.fit(state, ds, epochs=TRAINERS[name]["epochs"],
                                batch_size=batch, shuffle=False)
            ref[name] = {"params": jax.device_get(state.params),
                         "eval": trainer.evaluate(state.params, ds, batch),
                         "predict": trainer.predict(state.params, ds, batch)}
            if name == "mlp":
                errs = {}
                for what, call in (
                        ("fit", lambda: trainer.fit(
                            trainer.init_state(jax.random.PRNGKey(0),
                                               (10,)),
                            ds, epochs=1, batch_size=30)),
                        ("evaluate", lambda: trainer.evaluate(
                            state.params, ds, 30)),
                        ("predict", lambda: trainer.predict(
                            state.params, ds, 30))):
                    with pytest.raises(JaxDistError) as e:
                        call()
                    errs[what] = str(e.value)
                ref["errors"] = errs
        pa = jax_param_avg(pa_trainer, pa_state, JaxDataset(*pa_data),
                           mesh=mesh, epochs=PARAM_AVG["epochs"],
                           batch_size=PARAM_AVG["batch"], sync_every=2,
                           rng=jax.random.PRNGKey(0), shuffle=False)
        ref["param_avg"] = {"params": jax.device_get(pa.params),
                            "step": int(pa.step)}
        stk = shard_stacked(inputs["stacked"], mesh)
        ref["psum"] = jax.device_get(jax_psum(stk, mesh))
        ref["pmean"] = jax.device_get(jax_pmean(stk, mesh))
        ref["aggregate"] = np.asarray(jax_tree_aggregate(
            _jax_bincount, shard_stacked({"ids": inputs["ids"]}, mesh),
            mesh))
        results = ranks.results()
    finally:
        ranks.close()
    return results, ref, out


def _jax_bincount(d):
    return jnp.zeros(4).at[d["ids"]].add(1.0)


# -- collectives ---------------------------------------------------------------

def test_collectives_match_the_jax_helpers(run):
    results, ref, _ = run
    for res in results:
        np.testing.assert_allclose(res["psum"]["a"], ref["psum"]["a"],
                                   rtol=1e-6)
        np.testing.assert_allclose(res["psum"]["b"][0], ref["psum"]["b"],
                                   rtol=1e-6)
        np.testing.assert_allclose(res["pmean"]["a"], ref["pmean"]["a"],
                                   rtol=1e-6)
        np.testing.assert_array_equal(res["aggregate"], ref["aggregate"])
        np.testing.assert_array_equal(res["psum"]["a"],
                                      results[0]["psum"]["a"])


def test_mismatched_slices_raise_on_every_rank(run):
    results, _, _ = run
    for res in results:
        assert res["mismatch"] and "one slice per worker" in res["mismatch"]


# -- the data-parallel trainer -------------------------------------------------

@pytest.mark.parametrize("name", ["mlp", "lstm"])
def test_dp_matches_the_jax_distributed_trainer(run, name):
    """3 epochs of B=32 over 100 rows (the last batch: 4 real rows, all on
    rank 0) on 4 ranks against the JAX trainer on 4 devices: params,
    the watch metric and predictions."""
    results, ref, _ = run
    want = _flat(ref[name]["params"])
    for res in results:
        got = res[name]
        assert set(got["params"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got["params"][k], v, rtol=DP_RTOL,
                                       atol=DP_ATOL, err_msg=k)
        np.testing.assert_allclose(got["eval"]["rmse"],
                                   ref[name]["eval"]["rmse"], rtol=DP_RTOL)
        np.testing.assert_allclose(got["predict"], ref[name]["predict"],
                                   rtol=DP_RTOL, atol=DP_ATOL)


@pytest.mark.parametrize("name", list(TRAINERS))
def test_ranks_stay_bit_identical(run, name):
    results, _, _ = run
    first = results[0][name]
    for res in results[1:]:
        for k, v in first["params"].items():
            np.testing.assert_array_equal(res[name]["params"][k], v,
                                          err_msg=k)
        assert res[name]["eval"] == first["eval"]
        np.testing.assert_array_equal(res[name]["predict"], first["predict"])


@pytest.mark.parametrize("name", ["mlp", "lstm"])
def test_group_of_one_is_bit_equal_to_the_trainer(run, name):
    results, _, _ = run
    for res in results:
        got = res[name]
        for k, v in got["plain"].items():
            np.testing.assert_array_equal(got["solo"][k], v, err_msg=k)
        assert got["solo_eval"] == got["plain_eval"]


def test_wide_deep_matches_jax_within_the_pinned_bf16_tolerance(run):
    results, ref, _ = run
    want = _flat(ref["wide_deep"]["params"])
    for k, v in want.items():
        got = results[0]["wide_deep"]["params"][k]
        err = np.abs(got - v).max() / max(np.abs(v).max(), 1e-30)
        assert err <= WD_REL_TOL, (k, err)


def test_one_ranks_stop_request_stops_every_rank(run):
    """The epoch boundary's SIGTERM flag is all-reduced: rank 2's request
    is every rank's decision, and no request is no one's."""
    results, _, _ = run
    assert [res["mlp"]["agree"] for res in results] == [(True, False)] * 4


def test_divisibility_errors_match_jax(run):
    """Batch sizes the data axis does not divide raise DistributedError in
    fit, evaluate and predict, on every rank, as in the JAX package."""
    results, ref, _ = run
    for res in results:
        for what, msg in res["mlp"]["errors"].items():
            assert msg is not None and "not divisible" in msg, what
            assert "not divisible" in ref["errors"][what]


# -- parameter averaging -------------------------------------------------------

def test_param_averaging_single_worker_equals_the_replay(run):
    results, _, _ = run
    for res in results:
        solo = res["param_avg_solo"]
        assert solo["step"] == 8  # 128 rows / 16 = 8 batches, 4 rounds of 2
        for k, v in solo["replay"].items():
            np.testing.assert_allclose(solo["params"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_param_averaging_matches_jax(run):
    results, ref, _ = run
    want = _flat(ref["param_avg"]["params"])
    for res in results:
        got = res["param_avg"]
        assert got["step"] == ref["param_avg"]["step"] == 4
        for k, v in want.items():
            np.testing.assert_allclose(got["params"][k], v, rtol=PA_RTOL,
                                       atol=PA_ATOL, err_msg=k)


# -- checkpoints ---------------------------------------------------------------

def test_two_rank_checkpoint_loads_in_jax(run):
    results, _, out = run
    path = jax_ck.latest_checkpoint(str(out / "port_ckpt"))
    assert path is not None and jax_ck.verify_checkpoint(path)
    manifest = jax_ck._read_manifest(path)
    assert manifest["num_processes"] == 2
    assert sorted(p.name for p in (out / "port_ckpt").glob("*/*")) == [
        "arrays-00000.emt", "arrays-00001.emt", "manifest.json"]
    plain, _ = _jax_trainer("mlp")
    like = plain.init_state(jax.random.PRNGKey(0), (10,))
    restored = jax_ck.load_checkpoint(path, like)
    got = _flat(jax.device_get(restored.params))
    for k, v in results[0]["mlp"]["params"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(restored.step) == 12


def test_jax_checkpoint_restores_on_two_ranks(run):
    results, ref, _ = run
    want = _flat(ref["jax_ckpt_state"].params)
    for res in results[:2]:
        for k, v in want.items():
            np.testing.assert_array_equal(res["mlp"]["jax_ckpt"][k], v,
                                          err_msg=k)


def test_fit_saves_over_a_subgroup_mesh(run):
    """A DistributedTrainer over a mesh of two ranks out of four saves its
    periodic checkpoints over that pair's group (each pair its own
    two-shard checkpoint, intact), and each rank reads its shard back."""
    results, _, out = run
    for p in range(2):
        d = out / "subgroup_ckpt" / f"pair{p}"
        assert sorted(c.name for c in d.iterdir()) == ["step_00000001",
                                                       "step_00000002"]
        path = jax_ck.latest_checkpoint(str(d))
        assert path is not None and jax_ck.verify_checkpoint(path)
        assert jax_ck._read_manifest(path)["num_processes"] == 2
    for res in results:
        for k, v in results[0]["mlp"]["subgroup"].items():
            np.testing.assert_array_equal(res["mlp"]["subgroup"][k], v,
                                          err_msg=k)
            np.testing.assert_array_equal(res["mlp"]["subgroup_loaded"][k],
                                          v, err_msg=k)

"""The port's GBT path (euromillioner_tpu_torch/trees/) against the JAX
package's (euromillioner_tpu/trees/) on the CPU: binning, objectives,
growth from identical inputs, routing and prediction of carried-across
boosters, model JSON both ways, and whole training trajectories."""

import json
import logging
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.config import Config as JaxConfig
from euromillioner_tpu.data.pipeline import draws_from_html as jax_draws
from euromillioner_tpu.trees import Booster as JaxBooster
from euromillioner_tpu.trees import DMatrix as JaxDMatrix
from euromillioner_tpu.trees import binning as jax_binning
from euromillioner_tpu.trees import growth as jax_growth
from euromillioner_tpu.trees import objectives as jax_obj
from euromillioner_tpu.trees import train as jax_train
from euromillioner_tpu_torch.trees import Booster, DMatrix, binning, growth
from euromillioner_tpu_torch.trees import gbt, objectives, train
from euromillioner_tpu_torch.utils.errors import ConfigError, TrainError

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden"
PIN = json.loads((GOLDEN / "gbt_trajectory.json").read_text())
HYPERS = {"eta": 0.3, "reg_lambda": 1.0, "gamma": 0.0,
          "min_child_weight": 1.0}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- binning and objectives --------------------------------------------------

def _features(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(600, 5)).astype(np.float32)
    x[:, 1] = rng.integers(0, 7, size=600)     # few distinct values
    x[:, 2] = 3.0                               # constant
    x[::17, 3] = np.nan                         # missing
    x[:, 4] = np.round(x[:, 4], 1)              # ~60 distinct values
    return x


@pytest.mark.parametrize("max_bins", [16, 256])
def test_binning_bit_equal(max_bins):
    x = _features()
    cuts = binning.quantile_cuts(x, max_bins)
    want = jax_binning.quantile_cuts(x, max_bins)
    assert len(cuts) == len(want)
    for c, w in zip(cuts, want):
        assert c.dtype == w.dtype and np.array_equal(c, w)
    np.testing.assert_array_equal(binning.apply_bins(x, cuts),
                                  jax_binning.apply_bins(x, want))
    assert binning.num_bins(cuts) == jax_binning.num_bins(want)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b).max()


@pytest.mark.parametrize("name", sorted(objectives.OBJECTIVES))
def test_objectives_within_two_ulp(name):
    rng = np.random.default_rng(1)
    margin = (rng.normal(size=4000) * 6).astype(np.float32)
    y = rng.integers(0, 2, size=4000).astype(np.float32)
    got = objectives.get_objective(name)
    want = jax_obj.get_objective(name)
    for g, w in zip(got.grad_hess(*_t(margin, y)),
                    jax.jit(want.grad_hess)(margin, y)):
        assert _ulps(g.numpy(), w) <= 2
    assert _ulps(got.transform(torch.from_numpy(margin)).numpy(),
                 jax.jit(want.transform)(margin)) <= 2
    assert got.base_margin(0.3) == want.base_margin(0.3)
    assert got.default_metric == want.default_metric


@pytest.mark.parametrize("name", sorted(objectives.EVAL_METRICS))
def test_metrics_match(name):
    rng = np.random.default_rng(2)
    pred = rng.uniform(0, 1, size=1193).astype(np.float32)
    y = rng.integers(0, 2, size=1193).astype(np.float32)
    got = float(objectives.get_metric(name)(*_t(pred, y)))
    want = float(jax.jit(jax_obj.get_metric(name))(pred, y))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_unknown_objective_and_metric_raise():
    with pytest.raises(TrainError):
        objectives.get_objective("multi:softmax")
    with pytest.raises(TrainError):
        objectives.get_metric("auc")


# -- growth from identical inputs ----------------------------------------------

@pytest.mark.parametrize("n", [5, 16, 32, 33, 37, 44, 256, 300, 1193])
def test_ordered_sums_bit_equal_to_jax(n):
    """The histogram sums and scans in the JAX package's CPU order."""
    x = np.random.default_rng(n).normal(size=(3, n)).astype(np.float32)
    np.testing.assert_array_equal(growth.ordered_sum(torch.from_numpy(x)),
                                  np.asarray(jnp.asarray(x).sum(-1)))
    np.testing.assert_array_equal(growth.ordered_cumsum(torch.from_numpy(x)),
                                  np.asarray(jnp.cumsum(jnp.asarray(x), -1)))


def _level_case(n, f, n_bins, depth, seed):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, n_bins, size=(n, f)).astype(np.int32)
    # some rows sit in earlier levels (leaves) and stay out of this one
    node = (rng.integers(0, 1 << depth, size=n) + (1 << depth) - 1)
    node[::7] = rng.integers(0, max(1, (1 << depth) - 1), size=len(node[::7]))
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.05, 0.25, size=n).astype(np.float32)
    sampled = (rng.uniform(size=n) < 0.8).astype(np.float32)
    return binned, node.astype(np.int32), sampled, grad, hess


# one compiled program per level (eager dispatch compiles every op apart)
jax_grow_level_sub = jax.jit(
    jax_growth.grow_level_sub,
    static_argnames=("depth", "n_bins", "hist_method", "onehot_reads"))


def _jax_hypers():
    return {k: jnp.float32(v) for k, v in HYPERS.items()}


@pytest.mark.parametrize("n,f,n_bins,depth,final,masked", [
    (1193, 10, 44, 0, False, False), (1193, 10, 44, 2, False, True),
    (1193, 10, 44, 2, True, False), (2000, 6, 256, 3, False, False),
    (2000, 6, 256, 3, True, True), (1500, 4, 300, 1, False, True)])
def test_grow_level_identical(n, f, n_bins, depth, final, masked):
    case = _level_case(n, f, n_bins, depth, seed=depth)
    fmask = (np.arange(f) % 2 == 0).astype(np.float32) if masked else None
    want = jax_growth.grow_level(
        *map(jnp.asarray, case), depth=depth, n_bins=n_bins, final=final,
        hist_method="scatter", onehot_reads=False,
        feature_mask=None if fmask is None else jnp.asarray(fmask),
        **_jax_hypers())
    got = growth.grow_level(
        *_t(*case), depth=depth, n_bins=n_bins, final=final,
        feature_mask=None if fmask is None else torch.from_numpy(fmask),
        **HYPERS)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_grow_level_sub_identical():
    """Sibling subtraction level by level, the JAX side with its exact
    scatter histograms: equal splits and bit-equal leaf values and
    histograms."""
    binned, _, sampled, grad, hess = _level_case(1193, 10, 44, 0, seed=5)
    node_j = jnp.zeros(1193, jnp.int32)
    node_p = torch.zeros(1193, dtype=torch.int32)
    hists_j = hists_p = None
    for depth in range(3):
        res_j, hists_j = jax_grow_level_sub(
            *map(jnp.asarray, (binned,)), node_j,
            *map(jnp.asarray, (sampled, grad, hess)), hists_j, depth=depth,
            n_bins=44, hist_method="scatter", onehot_reads=False,
            **_jax_hypers())
        res_p, hists_p = growth.grow_level_sub(
            torch.from_numpy(binned), node_p, *_t(sampled, grad, hess),
            hists_p, depth=depth, n_bins=44, **HYPERS)
        for name in res_j._fields:
            np.testing.assert_array_equal(getattr(res_p, name).numpy(),
                                          np.asarray(getattr(res_j, name)),
                                          err_msg=f"depth {depth} {name}")
        for hp, hj in zip(hists_p, hists_j):
            np.testing.assert_array_equal(hp.numpy(), np.asarray(hj))
        node_j, node_p = res_j.node_id, res_p.node_id


def test_final_node_sums_are_exact():
    """The sibling-subtraction path's final level: per-node sums agree
    with float64 sums to f32 accumulation, and its leaf values with the
    full histogram's."""
    binned, node, sampled, grad, hess = _level_case(2000, 3, 8, 2, seed=3)
    res = growth.grow_level(*_t(binned, node, sampled, grad, hess), depth=2,
                            n_bins=8, final=True, final_sums=True, **HYPERS)
    full = growth.grow_level(*_t(binned, node, sampled, grad, hess), depth=2,
                             n_bins=8, final=True, **HYPERS)
    want = [np.sum((grad * sampled)[node == 3 + k], dtype=np.float64)
            for k in range(4)]
    np.testing.assert_allclose(res.grad_sum.numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(res.leaf_value.numpy(),
                               full.leaf_value.numpy(), rtol=1e-5, atol=1e-6)


# -- golden data, JAX-trained boosters -----------------------------------------

@pytest.fixture(scope="module")
def golden():
    html = (GOLDEN / "euromillions.html").read_text()
    rows = np.asarray(jax_draws(html, JaxConfig().data), np.float32)
    cut = int(0.7 * len(rows))
    x = np.delete(rows, 0, axis=1)
    y_ref = rows[:, 0]
    y_bin = (rows[:, 0] > rows[:, 0].mean()).astype(np.float32)
    return {"reference": (x[:cut], y_ref[:cut], x[cut:], y_ref[cut:]),
            "binary": (x[:cut], y_bin[:cut], x[cut:], y_bin[cut:])}


def _run_both(golden, key, rounds=20, **kw):
    xt, yt, xv, yv = golden[key]
    params = dict(PIN[key]["params"])
    res_j, res_p = {}, {}
    bj = jax_train(params, JaxDMatrix(xt, yt), rounds,
                   evals={"train": JaxDMatrix(xt, yt),
                          "test": JaxDMatrix(xv, yv)},
                   verbose_eval=False, evals_result=res_j, **kw)
    bp = train(dict(params, device="cpu"), DMatrix(xt, yt), rounds,
               evals={"train": DMatrix(xt, yt), "test": DMatrix(xv, yv)},
               verbose_eval=False, evals_result=res_p, **kw)
    return bj, bp, res_j, res_p


@pytest.fixture(scope="module")
def trajectories(golden):
    return {key: _run_both(golden, key) for key in ("reference", "binary")}


def _structure(trees, r):
    leaf = trees["is_leaf"][r]
    return (tuple(leaf), tuple(trees["feature"][r][~leaf]),
            tuple(trees["split_bin"][r][~leaf]))


def test_reference_trajectory_matches_pin_and_jax(trajectories):
    bj, bp, res_j, res_p = trajectories["reference"]
    for name in ("train", "test"):
        got = res_p[name]["logloss"]
        assert len(got) == PIN["n_rounds"]
        np.testing.assert_allclose(
            got, PIN["reference"]["trajectory"][name]["logloss"],
            rtol=1e-5, atol=1e-6, err_msg=f"{name} vs pin")
        np.testing.assert_allclose(got, res_j[name]["logloss"], rtol=1e-5,
                                   atol=1e-6, err_msg=f"{name} vs jax")
    for r in range(PIN["n_rounds"]):
        assert _structure(bp.trees, r) == _structure(bj.trees, r)


def _node_gains(golden, bp, r, node):
    """Gain of every (feature, bin) candidate at ``node`` of round r's
    tree, from the port's margins after r rounds."""
    xt, yt, _, _ = golden["binary"]
    cuts = bp.cuts
    binned = torch.from_numpy(binning.apply_bins(xt, cuts))
    margin = torch.from_numpy(bp.predict(DMatrix(xt), output_margin=True,
                                         iteration_range=(0, r)))
    grad, hess = objectives.get_objective("reg:logistic").grad_hess(
        margin, torch.from_numpy(yt))
    t = {k: torch.from_numpy(v[r]) for k, v in bp.trees.items()}
    depth = int(np.floor(np.log2(node + 1)))
    node_id = growth.route(binned, t["feature"], t["split_bin"],
                           t["is_leaf"], max_depth=depth).int()
    w = (node_id == node).float()
    hg, hh = growth.node_histograms(binned, torch.zeros_like(node_id),
                                    grad * w, hess * w, 1,
                                    binning.num_bins(cuts))
    return growth.split_gains(hg, hh, 1.0, 0.0)[0][0]


def test_binary_trajectory_matches_live_jax(golden, trajectories):
    """Equal tree structure, and logloss within rtol 1e-5, for every round
    up to the first round whose structure differs; a differing tree must
    come from a near-tie: the gains of the two packages' splits at the
    first differing node within 1e-5 relative of each other."""
    bj, bp, res_j, res_p = trajectories["binary"]
    rounds = PIN["n_rounds"]
    differ = next((r for r in range(rounds)
                   if _structure(bp.trees, r) != _structure(bj.trees, r)),
                  rounds)
    for name in ("train", "test"):
        np.testing.assert_allclose(res_p[name]["logloss"][:differ],
                                   res_j[name]["logloss"][:differ],
                                   rtol=1e-5, err_msg=name)
    if differ < rounds:
        r = differ
        node = int(next(i for i in range(bp.trees["feature"].shape[1])
                        if (bp.trees["is_leaf"][r][i], bp.trees["feature"]
                            [r][i], bp.trees["split_bin"][r][i])
                        != (bj.trees["is_leaf"][r][i], bj.trees["feature"]
                            [r][i], bj.trees["split_bin"][r][i])))
        gains = _node_gains(golden, bp, r, node)

        def gain(trees):
            if trees["is_leaf"][r][node]:
                return 0.0
            return float(gains[trees["feature"][r][node],
                               trees["split_bin"][r][node]])
        a, b = gain(bp.trees), gain(bj.trees)
        assert abs(a - b) <= 1e-5 * max(abs(a), abs(b)), (r, node, a, b)


def test_carried_across_boosters_predict_bit_equal(golden, tmp_path,
                                                   trajectories):
    """A JAX-trained booster, carried across by booster_from_arrays and by
    its saved JSON: margins bit-equal on fresh rows, in full and over an
    iteration range; transformed predictions within the 1-ulp sigmoid
    difference."""
    bj = trajectories["binary"][0]
    _, _, xv, _ = golden["binary"]
    path = tmp_path / "jax.json"
    bj.save_model(str(path))
    carried = [gbt.booster_from_arrays(bj.params, bj.cuts, bj.trees,
                                       bj.base_margin, device="cpu"),
               Booster.load_model(str(path), device="cpu")]
    for bst in carried:
        for kw in ({}, {"iteration_range": (3, 11)}, {"ntree_limit": 7}):
            np.testing.assert_array_equal(
                bst.predict(DMatrix(xv), output_margin=True, **kw),
                bj.predict(JaxDMatrix(xv), output_margin=True, **kw))
        assert _ulps(bst.predict(DMatrix(xv)),
                     bj.predict(JaxDMatrix(xv))) <= 2


def test_route_bit_equal(golden, trajectories):
    bj = trajectories["binary"][0]
    xt = golden["binary"][0]
    binned = binning.apply_bins(xt, bj.cuts)
    for r in (0, 7, 19):
        want = jax_growth.route(jnp.asarray(binned),
                                *(jnp.asarray(bj.trees[k][r]) for k in
                                  ("feature", "split_bin", "is_leaf")),
                                max_depth=3)
        got = growth.route(torch.from_numpy(binned),
                           *_t(*(bj.trees[k][r] for k in
                                 ("feature", "split_bin", "is_leaf"))),
                           max_depth=3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_json_loads_in_jax(golden, tmp_path, trajectories):
    bp = trajectories["binary"][1]
    _, _, xv, _ = golden["binary"]
    path = tmp_path / "port.json"
    bp.save_model(str(path))
    loaded = JaxBooster.load_model(str(path))
    np.testing.assert_array_equal(
        loaded.predict(JaxDMatrix(xv), output_margin=True),
        bp.predict(DMatrix(xv), output_margin=True))
    assert _ulps(loaded.predict(JaxDMatrix(xv)), bp.predict(DMatrix(xv))) <= 2
    again = Booster.load_model(str(path), device="cpu")
    for k, v in bp.trees.items():
        assert np.array_equal(again.trees[k], v) and again.trees[k].dtype == v.dtype


# -- train's options -------------------------------------------------------------

def _small(seed=0, n=600, f=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] + rng.normal(size=n) > 0).astype(np.float32)
    return DMatrix(x, y), DMatrix(x[:200], y[:200])


def _fit(params=None, rounds=6, **kw):
    dtrain, dval = _small()
    res = {}
    bst = train(dict({"device": "cpu", "eta": 0.3, "gamma": 0.0},
                     **(params or {})), dtrain, rounds,
                evals={"train": dtrain, "test": dval}, verbose_eval=False,
                evals_result=res, **kw)
    return bst, res


def test_results_identical_across_fuse_rounds():
    runs = [_fit(fuse_rounds=f, params={"subsample": 0.7,
                                        "colsample_bytree": 0.5})
            for f in (1, 5, None)]
    for bst, res in runs[1:]:
        assert res == runs[0][1]
        for k in bst.trees:
            np.testing.assert_array_equal(bst.trees[k], runs[0][0].trees[k])


def test_sampling_draws_rows_and_features():
    """subsample keeps about that share of rows per tree and
    colsample_bytree exactly round(share x F) features; the draws follow
    params["seed"]."""
    n, f = 20_000, 10
    gen = torch.Generator().manual_seed(3)
    shares, counts = [], []
    for _ in range(5):
        sampled, fmask = gbt.draw_sample(gen, n, f, 0.3, 4,
                                         torch.device("cpu"))
        shares.append(float(sampled.mean()))
        counts.append(int(fmask.sum()))
        assert set(sampled.unique().tolist()) <= {0.0, 1.0}
    assert all(abs(s - 0.3) < 0.02 for s in shares) and counts == [4] * 5
    a, _ = _fit({"subsample": 0.5, "colsample_bytree": 0.5, "seed": 1})
    b, _ = _fit({"subsample": 0.5, "colsample_bytree": 0.5, "seed": 1})
    c, _ = _fit({"subsample": 0.5, "colsample_bytree": 0.5, "seed": 2})
    assert np.array_equal(a.trees["leaf_value"], b.trees["leaf_value"])
    assert not np.array_equal(a.trees["leaf_value"], c.trees["leaf_value"])
    used = [set(a.trees["feature"][r][~a.trees["is_leaf"][r]])
            for r in range(6)]
    assert all(len(u) <= 3 for u in used)


@pytest.mark.parametrize("fuse_rounds", [1, None])
def test_early_stopping(fuse_rounds):
    """xgboost's rule, as the JAX package applies it: stop once the last
    watch has not improved for the patience; the first best round is
    recorded and prediction defaults to it."""
    dtrain, _ = _small(1)
    dval, _ = _small(2, n=200)
    res = {}
    bst = train({"device": "cpu", "eta": 1.0, "gamma": 0.0, "max_depth": 4,
                 "objective": "binary:logistic"}, dtrain, 40,
                evals=[(dtrain, "train"), (dval, "test")], verbose_eval=False,
                evals_result=res, early_stopping_rounds=3,
                fuse_rounds=fuse_rounds)
    history = res["test"]["logloss"]
    best = int(np.argmin(history))
    assert bst.best_iteration == best and bst.best_ntree_limit == best + 1
    assert bst.best_score == history[best]
    # the stop lands on the first chunk boundary past the patience
    assert best + 3 < bst.num_boosted_rounds == len(history) < 40
    assert len(history) - 1 - best < 3 + (fuse_rounds or 3)
    np.testing.assert_array_equal(
        bst.predict(dval), bst.predict(dval, iteration_range=(0, best + 1)))


def test_sibling_subtraction_grows_the_same_trees():
    direct, res_d = _fit()
    sub, res_s = _fit({"hist_method": "pallas"})
    for k in ("feature", "split_bin", "is_leaf"):
        np.testing.assert_array_equal(sub.trees[k], direct.trees[k])
    np.testing.assert_allclose(sub.trees["leaf_value"],
                               direct.trees["leaf_value"], rtol=1e-5,
                               atol=1e-6)


def test_custom_obj_and_feval():
    """obj and feval get tensors on the training device; a custom
    squared-error objective grows reg:squarederror's trees."""
    def sq(margin, dm):
        return margin - dm.get_label(), torch.ones_like(margin)

    def mae(margin, dm):
        return "mae", torch.mean(torch.abs(margin - dm.get_label()))

    custom, res = _fit(obj=sq, feval=mae)
    plain, _ = _fit({"objective": "reg:squarederror"})
    assert custom.params["objective"] == "custom" and "mae" in res["test"]
    for k in plain.trees:
        np.testing.assert_array_equal(custom.trees[k], plain.trees[k])


def test_param_aliases_ignored_and_unsupported(caplog):
    with caplog.at_level(logging.WARNING):
        a, _ = _fit({"learning_rate": 0.3, "reg_lambda": 2.0, "nthread": 6,
                     "silent": 1, "alpha": 0.5, "max_bin": 64})
    assert any("'alpha'" in r.getMessage() for r in caplog.records)
    b, _ = _fit({"eta": 0.3, "lambda": 2.0, "max_bins": 64})
    assert a.params == b.params
    for k in a.trees:
        np.testing.assert_array_equal(a.trees[k], b.trees[k])


@pytest.mark.parametrize("params,err", [
    ({"colour": 1}, TrainError), ({"booster": "dart"}, TrainError),
    ({"hist_method": "matmul"}, TrainError),
    ({"hist_method": "bogus"}, TrainError), ({"device": "tpu"}, ConfigError),
    ({"device": "fpga"}, TrainError), ({"subsample": 0.0}, TrainError),
    ({"eval_metric": "auc"}, TrainError)])
def test_bad_params_raise(params, err):
    with pytest.raises(err):
        _fit(params, rounds=1)


def test_scatter_is_refused_on_the_card():
    with pytest.raises(TrainError, match="scatter"):
        gbt._resolve_hist_method("scatter", torch.device("cuda", 0))
    assert gbt._resolve_hist_method("auto", torch.device("cuda", 0)) == \
        "direct"
    assert gbt._resolve_hist_method("pallas", torch.device("cpu")) == "sub"


def test_eval_set_and_iteration_range_errors():
    bst, res = _fit()
    dtrain, dval = _small()
    line = bst.eval_set([(dval, "test")], iteration=5)
    assert line.startswith("[5]\ttest-rmse:")   # reg:logistic's default
    assert float(line.split(":")[1]) == pytest.approx(res["test"]["rmse"][-1],
                                                      abs=1e-6)
    with pytest.raises(TrainError):
        bst.predict(dval, iteration_range=(0, 99))
    with pytest.raises(TrainError):
        bst.predict(dval, iteration_range=(0, 2), ntree_limit=2)


def test_dmatrix_from_csv_uri(tmp_path):
    from euromillioner_tpu_torch.data.csvio import write_csv

    path = str(tmp_path / "d.csv")
    write_csv(path, [[1, 10, 100], [0, 20, 200], [1, 30, 300]],
              header="label,a,b")
    dm = DMatrix(path + "?format=csv&label_column=0")
    assert dm.num_col == 2
    np.testing.assert_array_equal(dm.y, [1, 0, 1])
    np.testing.assert_array_equal(dm.x[:, 0], [10, 20, 30])

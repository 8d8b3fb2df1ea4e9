"""The port's random forest (euromillioner_tpu_torch/trees/random_forest.py)
against the JAX package's (euromillioner_tpu/trees/random_forest.py) on the
CPU: feature subsets, both histogram forms, the level step fed the JAX
package's own draws, whole forests with nothing drawn, the port's draws,
model JSON both ways, and the error cases.

K3's set form itself is held to its plain version on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.trees import random_forest as jrf
from euromillioner_tpu.utils import errors as jax_errors
from euromillioner_tpu_torch.trees import random_forest as rf
from euromillioner_tpu_torch.trees import binning
from euromillioner_tpu_torch.utils.errors import (ConfigError, DataError,
                                                  TrainError)

torch.set_num_threads(2)

KEYS = ("feature", "split_bin", "is_leaf", "leaf_value")
# a forest that draws nothing: no bootstrap, every feature at every node
NO_DRAWS = dict(num_trees=4, max_depth=4, max_bins=16, bootstrap=False,
                feature_subset="all")


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _data(seed=0, n=700, f=5, n_classes=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[:, 1] = rng.integers(0, 6, size=n)          # few distinct values
    y_cls = ((x[:, 0] > 0).astype(int) + (x[:, 2] > 0.5)).astype(np.float32)
    y_cls = np.minimum(y_cls, n_classes - 1)
    y_reg = (2 * x[:, 0] - x[:, 3] + 0.3 * rng.normal(size=n)).astype(
        np.float32)
    return x, y_cls, y_reg


# -- feature subsets ---------------------------------------------------------

@pytest.mark.parametrize("classification", [True, False])
@pytest.mark.parametrize("strategy", ["auto", "all", "sqrt", "log2",
                                      "onethird", 0.3, 1.0, 0.01])
def test_feature_subset_matches_jax(strategy, classification):
    for n in (1, 2, 5, 10, 28, 100):
        assert (rf.resolve_feature_subset(strategy, n, classification)
                == jrf.resolve_feature_subset(strategy, n, classification))


def test_unknown_feature_subset_raises_in_both():
    with pytest.raises(TrainError, match="feature_subset"):
        rf.resolve_feature_subset("half", 10, True)
    with pytest.raises(jax_errors.TrainError, match="feature_subset"):
        jrf.resolve_feature_subset("half", 10, True)


# -- histograms --------------------------------------------------------------

def _hist_case(seed, n=600, f=5, n_bins=16, n_nodes=4, n_classes=3,
               trees=2):
    """Per-tree node ids and Poisson-like integer weights over one shared
    binned matrix, as a level of a forest hands them to the histograms."""
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, n_bins, (n, f)).astype(np.int32)
    y_cls = rng.integers(0, n_classes, n).astype(np.int32)
    y = rng.normal(size=n).astype(np.float32)
    local = rng.integers(0, n_nodes, (trees, n)).astype(np.int32)
    w = rng.integers(0, 3, (trees, n)).astype(np.float32)
    return binned, y_cls, y, local, w


# hist_method=scatter runs the kernel form too: on CPU tensors K3's plain
# version is the JAX scatter's order. Its case takes the trees one set
# launch at a time, as the JAX scatter path's vmap takes them one by one.
@pytest.mark.parametrize("form", ["kernel", "scatter"])
def test_class_histograms_bit_equal_to_jax_scatter(form):
    """C=3 leaves the second slot of the second class pair empty."""
    binned, y_cls, _, local, w = _hist_case(0)
    want = np.stack([np.asarray(jrf._class_histograms(
        jnp.asarray(binned), jnp.asarray(y_cls), jnp.asarray(local[t]),
        jnp.asarray(w[t]), 4, 16, 3)) for t in range(2)])
    b, yc, lc, wt = _t(binned, y_cls, local, w)
    if form == "kernel":
        got = rf.class_histograms_sets(b, yc, lc, wt, 4, 16, 3)
    else:
        got = torch.cat([rf.class_histograms_sets(b, yc, lc[t:t + 1],
                                                  wt[t:t + 1], 4, 16, 3)
                         for t in range(2)])
    assert got.shape == (2, 4, 5, 16, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("form", ["kernel", "scatter"])
def test_reg_histograms_bit_equal_to_jax_scatter(form):
    binned, _, y, local, w = _hist_case(1, n=500, f=4, n_bins=12, n_nodes=2)
    want = [np.stack(m) for m in zip(*[
        [np.asarray(a) for a in jrf._reg_histograms(
            jnp.asarray(binned), jnp.asarray(y), jnp.asarray(local[t]),
            jnp.asarray(w[t]), 2, 12)] for t in range(2)])]
    b, yt, lc, wt = _t(binned, y, local, w)
    if form == "kernel":
        got = rf.reg_histograms_sets(b, yt, lc, wt, 2, 12)
    else:
        got = [torch.cat(m) for m in zip(*[
            rf.reg_histograms_sets(b, yt, lc[t:t + 1], wt[t:t + 1], 2, 12)
            for t in range(2)])]
    for g, w_ in zip(got, want):
        assert g.shape == (2, 2, 4, 12)
        np.testing.assert_array_equal(g.numpy(), w_)


def test_histograms_match_jax_pallas_kernel():
    """Against the Pallas kernel's forms (interpret mode), within the JAX
    package's own tolerances (tests/test_random_forest.py)."""
    binned, y_cls, y, local, w = _hist_case(2, n=256, f=3, trees=1)
    jb, jl, jw = jnp.asarray(binned), jnp.asarray(local[0]), jnp.asarray(w[0])
    b, yc, yt, lc, wt = _t(binned, y_cls, y, local, w)
    # under jit, as the JAX package runs them (eager interpret mode
    # dispatches the kernel body op by op)
    want = jax.jit(jrf._class_histograms_pallas, static_argnums=(4, 5, 6))(
        jb, jnp.asarray(y_cls), jl, jw, 4, 16, 3)
    got = rf.class_histograms_sets(b, yc, lc, wt, 4, 16, 3)[0]
    assert got.shape == (4, 3, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    for g, w_ in zip(rf.reg_histograms_sets(b, yt, lc, wt, 4, 16),
                     jax.jit(jrf._reg_histograms_pallas,
                             static_argnums=(4, 5))(jb, jnp.asarray(y), jl,
                                                    jw, 4, 16)):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w_), atol=1e-4,
                                   rtol=1e-4)


# -- the level step, fed the JAX package's draws -----------------------------

LEVEL_DEPTH = 3


@pytest.fixture(scope="module")
def level_case():
    """Binned rows, labels and JAX-drawn bootstrap weights and feature
    masks (3 of 5 features) for 3 trees of depth 3, and the JAX package's
    level outputs at every depth, run once per impurity and JAX method
    (``scatter``, or ``pallas`` in interpret mode with its sibling
    subtraction fed the previous level's hists)."""
    x, y_cls, y_reg = _data(3, n=500)
    cuts = binning.quantile_cuts(x, 16)
    binned, n_bins = binning.apply_bins(x, cuts), binning.num_bins(cuts)
    key = jax.random.PRNGKey(3)
    key, bk = jax.random.split(key)
    boot = np.asarray(jrf._poisson_bootstrap(bk, 3, len(x)))
    # one draw for the nodes of every level, cut into levels
    every = np.array(jrf._feature_mask(key, 3, (2 << LEVEL_DEPTH) - 1, 5, 3))
    masks = [every[:, (1 << d) - 1:(2 << d) - 1]
             for d in range(LEVEL_DEPTH + 1)]
    jax_levels = {}

    def case(classification: bool, jax_method: str = "scatter"):
        y = y_cls if classification else y_reg
        n_classes = 3 if classification else 1
        ycls = np.clip(y, 0, n_classes - 1).astype(np.int32)
        if (classification, jax_method) not in jax_levels:
            jlevel = jrf._make_level_step(classification, lambda h: h,
                                          jax_method)
            node, parent = np.zeros((3, len(y)), np.int32), None
            outs = []
            for d in range(LEVEL_DEPTH + 1):
                out = jax.jit(lambda b, yy, yc, nd, bw, mk, ph, d=d: jlevel(
                    b, yy, yc, nd, bw, mk, ph, depth=d, n_bins=n_bins,
                    n_classes=n_classes, final=d == LEVEL_DEPTH,
                    min_info_gain=0.0))(
                    *map(jnp.asarray, (binned, y, ycls, node, boot,
                                       masks[d])), parent)
                outs.append([np.asarray(o) for o in out[:5]])
                node, parent = outs[-1][4], out[5]
            jax_levels[classification, jax_method] = outs
        return (*_t(binned, y, ycls, boot), masks, n_bins, n_classes,
                jax_levels[classification, jax_method])

    return case


# the variance level under sibling subtraction: the Pallas kernel's moment
# sums, parent − left and the final level's per-node sums (the JAX package
# takes those from a bf16 hi/lo one-hot product) round apart from the
# port's; leaf means within this of the JAX package's (measured 3.6e-6 at
# depth 3, pinned at the JAX package's own tree tolerance,
# tests/test_random_forest.py)
SUB_LEAF_ATOL = 1e-5


@pytest.mark.parametrize("method", ["direct", "scatter", "sub"])
@pytest.mark.parametrize("classification", [True, False],
                         ids=["gini", "variance"])
def test_level_steps_bit_equal_to_jax(level_case, classification, method):
    """Depths 0-3 (3 final) from the same inputs: every table and the
    rows' next node ids, bit for bit. ``scatter`` is the hist_method that
    resolves to ``direct`` on the CPU; ``sub`` is held to the JAX pallas
    level step (interpret mode), each level fed its own previous hists —
    bit for bit but the variance leaf means (``SUB_LEAF_ATOL``)."""
    if method == "scatter":
        method = rf._resolve_rf_hist("scatter", torch.device("cpu"))
    b, yt, yc, bw, masks, n_bins, n_classes, want = level_case(
        classification, "pallas" if method == "sub" else "scatter")
    node, parent = torch.zeros((3, b.shape[0]), dtype=torch.int32), None
    for d in range(LEVEL_DEPTH + 1):
        got = rf.level_step(b, yt, yc, node, bw, torch.from_numpy(masks[d]),
                            parent, classification=classification, depth=d,
                            n_bins=n_bins, n_classes=n_classes,
                            final=d == LEVEL_DEPTH, min_info_gain=0.0,
                            method=method)
        for name, g, w in zip(KEYS[:3] + ("leaf_pred", "node_id"), got[:5],
                              want[d]):
            if name == "leaf_pred" and method == "sub" and not classification:
                np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                           atol=SUB_LEAF_ATOL,
                                           err_msg=f"depth {d} {name}")
            else:
                np.testing.assert_array_equal(g.numpy(), w,
                                              err_msg=f"depth {d} {name}")
        node, parent = got[4], got[5]


# -- whole forests -----------------------------------------------------------

@pytest.fixture(scope="module")
def forests():
    """The JAX package's forests on data with nothing drawn, built once."""
    x, y_cls, y_reg = _data(0)
    return (x, y_cls, y_reg,
            jrf.train_classifier(x, y_cls, 3, **NO_DRAWS),
            jrf.train_regressor(x, y_reg, **NO_DRAWS))


@pytest.mark.parametrize("hist_method", ["auto", "scatter"])
@pytest.mark.parametrize("classification", [True, False],
                         ids=["classifier", "regressor"])
def test_forest_bit_equal_to_jax(forests, classification, hist_method):
    """With nothing drawn the two packages grow the same trees and
    predict the same bits. Measured for the regressor too: its sums run
    in the same order here, so it is pinned bit-equal as well."""
    x, y_cls, y_reg, jcls, jreg = forests
    kw = dict(NO_DRAWS, device="cpu", hist_method=hist_method)
    if classification:
        got, want = rf.train_classifier(x, y_cls, 3, **kw), jcls
    else:
        got, want = rf.train_regressor(x, y_reg, **kw), jreg
    for k in KEYS:
        assert got.trees[k].dtype == np.asarray(want.trees[k]).dtype
        np.testing.assert_array_equal(got.trees[k], np.asarray(want.trees[k]),
                                      err_msg=k)
    pred, jpred = got.predict(x), np.asarray(want.predict(x))
    assert pred.dtype == jpred.dtype
    np.testing.assert_array_equal(pred, jpred)


@pytest.mark.parametrize("trees", [40])
def test_regression_mean_is_xla_order_over_many_trees(trees):
    """Above 32 trees the mean is XLA's blocked reduce times the f32
    reciprocal, not a left-to-right sum over a division."""
    x, _, y_reg = _data(4, n=200)
    kw = dict(NO_DRAWS, num_trees=trees, max_depth=1)
    got = rf.train_regressor(x, y_reg, device="cpu", **kw)
    jm = jrf.train_regressor(x, y_reg, **kw)
    np.testing.assert_array_equal(got.trees["leaf_value"],
                                  np.asarray(jm.trees["leaf_value"]))
    np.testing.assert_array_equal(got.predict(x), np.asarray(jm.predict(x)))


def test_sibling_subtraction_grows_the_same_classifier():
    """pallas (sibling subtraction, final level from per-node sums) and
    auto (direct) grow the same classifier from the port's own draws:
    class counts are exact, so the reachable trees agree bit for bit."""
    x, y_cls, _ = _data(5)
    kw = dict(num_trees=4, max_depth=5, max_bins=16, seed=5, device="cpu")
    direct = rf.train_classifier(x, y_cls, 3, **kw)
    sub = rf.train_classifier(x, y_cls, 3, hist_method="pallas", **kw)
    a, b = (rf.reachable_trees(m.trees, 5) for m in (direct, sub))
    for k in KEYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(direct.predict(x), sub.predict(x))


def test_sibling_subtraction_grows_the_same_regressor():
    """pallas and auto grow the same regressor from the port's own draws,
    up to equal partitions: parent − left leaves rounding residue in bins
    that none of a node's rows reach, so its split may land on another
    bin that sends the same rows left. Every node whose split differs
    does so, and leaf means and predictions agree within the JAX
    package's tree tolerance (measured 8.2e-6 and 2.1e-6)."""
    from euromillioner_tpu_torch.trees import growth

    x, _, y = _data(5)
    kw = dict(num_trees=4, max_depth=5, max_bins=16, seed=5, device="cpu")
    direct = rf.train_regressor(x, y, **kw)
    sub = rf.train_regressor(x, y, hist_method="pallas", **kw)
    a, b = (rf.reachable_trees(m.trees, 5) for m in (direct, sub))
    np.testing.assert_array_equal(a["is_leaf"], b["is_leaf"])
    binned = torch.from_numpy(binning.apply_bins(x, direct.cuts))
    for t, node in np.argwhere((a["feature"] != b["feature"])
                               | (a["split_bin"] != b["split_bin"])):
        tree = {k: torch.from_numpy(direct.trees[k][t]) for k in KEYS[:3]}
        at = growth.route(binned, *tree.values(),
                          max_depth=int(np.log2(node + 1))) == node
        left = [binned[at, m["feature"][t, node]] <= m["split_bin"][t, node]
                for m in (a, b)]
        assert torch.equal(*left), f"tree {t} node {node}"
    np.testing.assert_allclose(a["leaf_value"], b["leaf_value"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(direct.predict(x), sub.predict(x), rtol=0,
                               atol=1e-5)


# -- the port's own draws ----------------------------------------------------

def test_bootstrap_is_poisson_one():
    w = rf.poisson_bootstrap(torch.Generator().manual_seed(0), 4, 50_000)
    assert w.dtype == torch.float32 and w.shape == (4, 50_000)
    assert torch.equal(w, w.round()) and w.min() >= 0
    assert abs(w.mean().item() - 1.0) < 0.01
    assert abs(w.var().item() - 1.0) < 0.03


@pytest.mark.parametrize("m", [1, 3, 7])
def test_masks_hold_exactly_m_features(m):
    masks = rf.feature_masks(torch.Generator().manual_seed(1), 5, 16, 7, m)
    assert masks.shape == (5, 16, 7) and masks.dtype == torch.bool
    assert (masks.sum(-1) == m).all()
    if m < 7:  # the chosen features vary over nodes
        assert len({tuple(r.tolist()) for r in masks.reshape(-1, 7)}) > 1


def test_same_seed_same_forest_other_seed_other_forest():
    x, y_cls, _ = _data(6)
    kw = dict(num_trees=3, max_depth=4, max_bins=16, device="cpu")
    a, b, c = (rf.train_classifier(x, y_cls, 3, seed=s, **kw)
               for s in (7, 7, 8))
    for k in KEYS:
        np.testing.assert_array_equal(a.trees[k], b.trees[k])
    assert any(not np.array_equal(a.trees[k], c.trees[k]) for k in KEYS)


# -- model JSON ---------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_model_json_loads_both_ways(forests, tmp_path, writer):
    x, _, _, jcls, jreg = forests
    for i, jm in enumerate((jcls, jreg)):
        path = str(tmp_path / f"m{i}.json")
        if writer == "jax":
            jm.save_model(path)
            got = rf.RandomForestModel.load_model(path, device="cpu")
            want = np.asarray(jm.predict(x))
        else:
            pm = rf.RandomForestModel(jm.cuts, {k: np.asarray(v) for k, v in
                                                jm.trees.items()},
                                      jm.max_depth, jm.classification,
                                      jm.num_classes, device="cpu")
            pm.save_model(path)
            got = jrf.RandomForestModel.load_model(path)
            want = pm.predict(x)
        assert got.classification == jm.classification
        np.testing.assert_array_equal(np.asarray(got.predict(x)), want)


# -- errors ------------------------------------------------------------------

@pytest.mark.parametrize("case,err", [
    ("shape", DataError), ("classes", DataError), ("labels", DataError),
    ("fraction_labels", DataError), ("subset", TrainError),
    ("hist_method", TrainError)])
def test_errors_match_jax(case, err):
    """The same inputs raise the same error class (and so exit code) in
    both packages."""
    x, y, _ = _data(7, n=60)
    kw, n_classes = {}, 3
    if case == "shape":
        y = y[:-1]
    elif case == "classes":
        n_classes = 1
    elif case == "labels":
        y = y + 3
    elif case == "fraction_labels":
        y = y + 0.5
    elif case == "subset":
        kw = {"feature_subset": "half"}
    else:
        kw = {"hist_method": "bogus"}
    jerr = getattr(jax_errors, err.__name__)
    assert err.exit_code == jerr.exit_code
    with pytest.raises(err):
        rf.train_classifier(x, y, n_classes, device="cpu", **kw)
    with pytest.raises(jerr):
        jrf.train_classifier(x, y, n_classes, **kw)


def test_refusals_by_name():
    """Under a mesh, hist_method=pallas is refused as the JAX package
    refuses it, and a forest device other than the mesh's is a
    ConfigError (both before any collective: a group of one's record is
    enough)."""
    from euromillioner_tpu_torch.core.mesh import Mesh

    x, y, _ = _data(8, n=40)
    cpu_mesh = Mesh(data=1, rank=0, device=torch.device("cpu"))
    with pytest.raises(TrainError, match="pallas"):
        rf.train_classifier(x, y, 3, mesh=cpu_mesh, hist_method="pallas",
                            device="cpu")
    with pytest.raises(jax_errors.TrainError, match="pallas"):
        jrf.train_classifier(x, y, 3, mesh=object(), hist_method="pallas")
    card_mesh = Mesh(data=1, rank=0, device=torch.device("cuda", 0))
    with pytest.raises(ConfigError, match="mesh"):
        rf.train_classifier(x, y, 3, mesh=card_mesh, device="cpu")
    with pytest.raises(TrainError, match="scatter"):
        rf._resolve_rf_hist("scatter", torch.device("cuda"))
    model = rf.train_regressor(x, y, num_trees=1, max_depth=1, device="cpu")
    with pytest.raises(DataError, match="features"):
        model.predict_program(4)

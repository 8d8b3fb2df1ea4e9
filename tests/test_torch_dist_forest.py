"""The port's row-sharded random forest on four gloo ranks against the JAX
package's mesh path on four of its virtual CPU devices and against the
port's own single-device forest: whole forests with nothing drawn, and
the level step fed the JAX package's draws on each rank's rows.

One group of four rank processes (``tests/torch_dist_worker.py``) runs
every port case once per module; see that module for the timeouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.core.mesh import MeshSpec as JaxMeshSpec
from euromillioner_tpu.core.mesh import build_mesh as jax_build_mesh
from euromillioner_tpu.trees import random_forest as jrf
from euromillioner_tpu_torch.trees import binning
from euromillioner_tpu_torch.trees import random_forest as rf
from torch_dist_worker import Ranks

torch.set_num_threads(2)

WORLD = 4
KEYS = ("feature", "split_bin", "is_leaf", "leaf_value")
# a forest that draws nothing: no bootstrap, every feature at every node
NO_DRAWS = dict(num_trees=4, max_depth=4, max_bins=16, bootstrap=False,
                feature_subset="all")
LEVEL_DEPTH = 3
# the regressor's moments are summed per rank, then across ranks: another
# order than one device's. Measured on 4 ranks: leaf means within 3.6e-7
# of the JAX mesh path's and 7.2e-7 of one device's (the level step fed
# the JAX draws: 2.4e-7), every split the same; pinned at the JAX
# package's own tree tolerance (tests/test_random_forest.py), as the
# port's sibling subtraction is
REG_LEAF_ATOL = 1e-5


def _data(seed=0, n=701, f=5, n_classes=3):
    """701 rows: not a multiple of 4, so the last rank's share is padded."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[:, 1] = rng.integers(0, 6, size=n)          # few distinct values
    y_cls = ((x[:, 0] > 0).astype(int) + (x[:, 2] > 0.5)).astype(np.float32)
    y_cls = np.minimum(y_cls, n_classes - 1)
    y_reg = (2 * x[:, 0] - x[:, 3] + 0.3 * rng.normal(size=n)).astype(
        np.float32)
    return x, y_cls, y_reg


def _levels(seed=3, n=501):
    """Binned rows, labels and JAX-drawn bootstrap weights and feature
    masks (3 of 5 features) for 3 trees of depth 3, and the JAX package's
    single-device level outputs at every depth."""
    x, y_cls, y_reg = _data(seed, n=n)
    cuts = binning.quantile_cuts(x, 16)
    binned, n_bins = binning.apply_bins(x, cuts), binning.num_bins(cuts)
    key = jax.random.PRNGKey(seed)
    key, bk = jax.random.split(key)
    boot = np.asarray(jrf._poisson_bootstrap(bk, 3, n))
    every = np.array(jrf._feature_mask(key, 3, (2 << LEVEL_DEPTH) - 1, 5, 3))
    masks = [every[:, (1 << d) - 1:(2 << d) - 1]
             for d in range(LEVEL_DEPTH + 1)]
    want = {}
    for classification in (True, False):
        y = y_cls if classification else y_reg
        n_classes = 3 if classification else 1
        ycls = np.clip(y, 0, n_classes - 1).astype(np.int32)
        level = jrf._make_level_step(classification, lambda h: h, "scatter")
        node, outs = np.zeros((3, n), np.int32), []
        for d in range(LEVEL_DEPTH + 1):
            out = jax.jit(lambda b, yy, yc, nd, bw, mk, d=d: level(
                b, yy, yc, nd, bw, mk, None, depth=d, n_bins=n_bins,
                n_classes=n_classes, final=d == LEVEL_DEPTH,
                min_info_gain=0.0))(
                *map(jnp.asarray, (binned, y, ycls, node, boot, masks[d])))
            outs.append([np.asarray(o) for o in out[:5]])
            node = outs[-1][4]
        want[classification] = outs
    inputs = {"binned": binned, "y_cls": y_cls, "y_reg": y_reg,
              "boot": boot, "masks": masks, "n_bins": n_bins}
    return inputs, want


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(each rank's results, the JAX mesh forests, the port's
    single-device forests, the JAX level outputs)."""
    out = tmp_path_factory.mktemp("dist_forest")
    x, y_cls, y_reg = _data()
    levels, want_levels = _levels()
    inputs = {"x": x, "y_cls": y_cls, "y_reg": y_reg, "levels": levels,
              "forest_kw": dict(NO_DRAWS, device="cpu")}
    ranks = Ranks("forest", WORLD, out, inputs)
    try:
        mesh = jax_build_mesh(JaxMeshSpec(data=WORLD),
                              devices=jax.devices()[:WORLD])
        jax_mesh = {
            "classifier": jrf.train_classifier(x, y_cls, 3, mesh=mesh,
                                               **NO_DRAWS).trees,
            "regressor": jrf.train_regressor(x, y_reg, mesh=mesh,
                                             **NO_DRAWS).trees}
        single = {
            "classifier": rf.train_classifier(x, y_cls, 3, device="cpu",
                                              **NO_DRAWS).trees,
            "regressor": rf.train_regressor(x, y_reg, device="cpu",
                                            **NO_DRAWS).trees}
        results = ranks.results()
    finally:
        ranks.close()
    return results, jax_mesh, single, want_levels


@pytest.mark.parametrize("reference", ["jax_mesh", "port_single_device"])
def test_classifier_trees_equal(run, reference):
    """Class counts are integers: exact in any order, so the trees are
    the same bits on every rank, the JAX mesh path's and one device's."""
    results, jax_mesh, single, _ = run
    want = (jax_mesh if reference == "jax_mesh" else single)["classifier"]
    for res in results:
        for k in KEYS:
            np.testing.assert_array_equal(res["classifier"][k],
                                          np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("reference", ["jax_mesh", "port_single_device"])
def test_regressor_trees_equal(run, reference):
    """The same splits, leaf means within REG_LEAF_ATOL (a split at a near
    tie would part here; none does at these rows)."""
    results, jax_mesh, single, _ = run
    want = (jax_mesh if reference == "jax_mesh" else single)["regressor"]
    for res in results:
        for k in KEYS[:3]:
            np.testing.assert_array_equal(res["regressor"][k],
                                          np.asarray(want[k]), err_msg=k)
        np.testing.assert_allclose(res["regressor"]["leaf_value"],
                                   np.asarray(want["leaf_value"]), rtol=0,
                                   atol=REG_LEAF_ATOL)


def test_ranks_grow_identical_forests(run):
    results, _, _, _ = run
    for res in results[1:]:
        for model in ("classifier", "regressor"):
            for k in KEYS:
                np.testing.assert_array_equal(res[model][k],
                                              results[0][model][k])


def test_pallas_is_refused_under_a_mesh(run):
    results, _, _, _ = run
    for res in results:
        assert res["pallas"] and "single-device only" in res["pallas"]


@pytest.mark.parametrize("classification", [True, False],
                         ids=["gini", "variance"])
def test_level_steps_on_each_ranks_rows_match_jax(run, classification):
    """Depths 0-3 fed the JAX draws, rows sharded over 4 ranks and the
    histograms all-reduced: the tables of every level as one device's JAX
    level gives them, and each rank's rows routed to the same nodes."""
    results, _, _, want = run
    for res in results:
        start, stop, n = res["rows"]
        real = slice(start, min(stop, n))
        for d, (got, ref) in enumerate(zip(res["levels"][classification],
                                           want[classification])):
            for name, g, w in zip(KEYS[:3] + ("leaf_pred",), got[:4],
                                  ref[:4]):
                if name == "leaf_pred" and not classification:
                    np.testing.assert_allclose(g, w, rtol=0,
                                               atol=REG_LEAF_ATOL,
                                               err_msg=f"depth {d}")
                else:
                    np.testing.assert_array_equal(g, w, err_msg=f"depth {d} "
                                                  f"{name}")
            np.testing.assert_array_equal(
                got[4][:, :real.stop - real.start], ref[4][:, real],
                err_msg=f"depth {d} node ids")

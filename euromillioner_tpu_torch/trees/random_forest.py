"""Random forest: the Spark-MLlib capability (BASELINE.json config 3; the JAX
package's ``trees/random_forest.py``), on one device or row-sharded over a
data-parallel group.

MLlib grows every tree level by level from per-node feature/bin label
histograms. Here one level of ALL trees is a fixed sequence of tensor ops:
the histograms of every tree in one launch of K3's set form
(``ops/fused_histogram.fused_histogram_sets``, one set per (tree, class
pair) or (tree, moment pair)), then gini or variance split finding, the
leaf votes and the routing of every row. The host loop never branches on
device data, and nothing syncs until the tree arrays come back.

Histogram methods (``hist_method``, as the JAX package names them):

* ``auto`` → direct: a full histogram at every level, the final level
  included — the JAX package's CPU path (its scatter), bit for bit on the
  CPU;
* ``pallas`` → sub: sibling subtraction (levels ≥ 1 build left children
  only, right = parent − left) and per-node sums for the final level —
  the JAX package's kernel path;
* ``scatter`` → direct, on the CPU only: K3's plain version there is
  already the JAX package's scatter order.

The JAX package gates its kernel on VMEM and 256 bins; K3 takes any bin
count, so nothing here has that gate.

Row-sharded (``mesh=``, the JAX package's mesh path and MLlib's
``treeAggregate``): every rank draws the whole forest's bootstrap weights
and feature masks from the same seed at the true row count, pads the
rows to a multiple of the ``data`` axis with zero weight and takes its
share. Each level runs K3 (``direct``) on the rank's rows, then one
``all_reduce`` of the level's histograms before the gains, so every rank
grows the same trees. ``hist_method=pallas`` is refused there, as the
JAX package refuses it.

Randomness. The Poisson(1) bootstrap weights and the per-(tree, node)
feature masks (exactly m features, from the rank of iid uniforms) are
drawn on the CPU from a ``torch.Generator`` seeded with ``seed`` and then
moved to the training device, so one seed grows the same forest on the
card and on the CPU. The draws cannot match ``jax.random``: a forest with
``bootstrap=False, feature_subset="all"`` draws nothing that matters, and
parity tests feed the JAX package's draws to :func:`level_step`.

Summation order. Split scans and reductions use ``growth.ordered_sum`` /
``ordered_cumsum`` (the JAX package's CPU orders); the mean over trees is
its reduce times the f32 reciprocal of the tree count, as XLA computes
it. Class counts from Poisson weights are integers below 2^24, so they
are exact in any order: a classifier's trees are the same on the card
and on the CPU, and in either histogram method.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.core.mesh import round_up_multiple
from euromillioner_tpu_torch.ops.fused_histogram import fused_histogram_sets
from euromillioner_tpu_torch.trees import binning
from euromillioner_tpu_torch.trees.growth import (add_leaf_values,
                                                  interleave_siblings,
                                                  node_sums, ordered_cumsum,
                                                  ordered_sum,
                                                  route_one_level,
                                                  tree_leaf_values)
from euromillioner_tpu_torch.utils.errors import (ConfigError, DataError,
                                                  TrainError)
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("trees.random_forest")

_TREE_KEYS = ("feature", "split_bin", "is_leaf", "leaf_value")
_TREE_DTYPES = {"feature": np.int32, "split_bin": np.int32, "is_leaf": bool,
                "leaf_value": np.float32}
# elements of one (sets, rows, nodes) mask in the final level's per-node
# sums: sets are taken in chunks below this
_NODE_SUM_ELEMENTS = 1 << 26


def resolve_feature_subset(strategy: str | float, n_features: int,
                           classification: bool) -> int:
    """MLlib featureSubsetStrategy semantics: auto → sqrt for
    classification, 1/3 for regression; all/sqrt/log2/onethird/fraction."""
    if isinstance(strategy, (int, float)) and not isinstance(strategy, bool):
        m = int(math.ceil(float(strategy) * n_features))
    elif strategy == "auto":
        m = (int(math.ceil(math.sqrt(n_features))) if classification
             else max(n_features // 3, 1))
    elif strategy == "all":
        m = n_features
    elif strategy == "sqrt":
        m = int(math.ceil(math.sqrt(n_features)))
    elif strategy == "log2":
        m = int(math.ceil(math.log2(max(n_features, 2))))
    elif strategy == "onethird":
        m = max(n_features // 3, 1)
    else:
        raise TrainError(f"unknown feature_subset {strategy!r}")
    return min(max(m, 1), n_features)


def feature_masks(gen: torch.Generator, n_trees: int, n_nodes: int,
                  n_features: int, m: int) -> torch.Tensor:
    """Exactly-m random features per (tree, node), (T, n_nodes, F) bool on
    the CPU: the rank of iid uniforms below m."""
    u = torch.rand((n_trees, n_nodes, n_features), generator=gen)
    rank = torch.argsort(torch.argsort(u, dim=-1, stable=True), dim=-1,
                         stable=True)
    return rank < m


def poisson_bootstrap(gen: torch.Generator, n_trees: int, n: int
                      ) -> torch.Tensor:
    """MLlib's Poisson(1) bagging weights, (T, N) f32 on the CPU."""
    return torch.poisson(torch.ones((n_trees, n)), generator=gen)


def draw_forest(seed: int, n_trees: int, n: int, n_features: int, m: int,
                max_depth: int, bootstrap: bool):
    """``(boot_w (T, N), [mask of level d (T, 2^d, F)])`` on the CPU from
    one generator seeded with ``seed``: the bootstrap first, then the masks
    level by level."""
    gen = torch.Generator().manual_seed(int(seed))
    boot_w = (poisson_bootstrap(gen, n_trees, n) if bootstrap
              else torch.ones((n_trees, n)))
    masks = [feature_masks(gen, n_trees, 1 << d, n_features, m)
             for d in range(max_depth + 1)]
    return boot_w, masks


# -- histograms --------------------------------------------------------------

def class_sets(y_cls, local, weight, n_classes: int):
    """K3's set-form inputs for per-class counts (JAX
    ``_class_histograms_pallas``'s calls, one set per (tree, class pair)):
    ``local``/``weight`` (T, N) → (local, gw, hw), each (T·⌈C/2⌉, N); set
    (t, p) carries w·[y = 2p] and w·[y = 2p+1] (zero past the last class)
    in its two stat slots."""
    t, n = local.shape
    pairs = -(-n_classes // 2)
    cls = torch.arange(2 * pairs, dtype=y_cls.dtype, device=y_cls.device)
    # weight * (y == c), JAX's f32 times bool; no label equals the padded
    # class c = C of an odd C, so its slot is zero
    onehot = (y_cls[None, :] == cls[:, None]).view(pairs, 2, n)
    gw = (weight[:, None, :] * onehot[None, :, 0]).reshape(t * pairs, n)
    hw = (weight[:, None, :] * onehot[None, :, 1]).reshape(t * pairs, n)
    return local.repeat_interleave(pairs, dim=0), gw, hw


def class_histograms_sets(binned, y_cls, local, weight, n_nodes: int,
                          n_bins: int, n_classes: int):
    """The kernel form (JAX ``_class_histograms_pallas``) for T trees at
    once: ``local``/``weight`` (T, N) → (T, n_nodes, F, bins, C), from one
    K3 launch of :func:`class_sets`."""
    t = local.shape[0]
    f = binned.shape[1]
    pairs = -(-n_classes // 2)
    hist = fused_histogram_sets(binned, *class_sets(y_cls, local, weight,
                                                    n_classes),
                                n_bins, n_nodes)
    hist = hist.view(t, pairs, f, n_nodes, 2, n_bins)
    hist = hist.permute(0, 3, 2, 5, 1, 4).reshape(t, n_nodes, f, n_bins,
                                                  2 * pairs)
    return hist[..., :n_classes]


def reg_sets(y, local, weight):
    """K3's set-form inputs for y-moments (JAX ``_reg_histograms_pallas``'s
    two calls per tree): ``local``/``weight`` (T, N) → (local, gw, hw),
    each (2T, N): (Σwy | Σwy²) and (Σw | 0) per tree."""
    t, n = local.shape
    wy = weight * y
    gw = torch.stack([wy, weight], dim=1).reshape(2 * t, n)
    hw = torch.stack([wy * y, torch.zeros_like(weight)], dim=1).reshape(
        2 * t, n)
    return local.repeat_interleave(2, dim=0), gw, hw


def reg_histograms_sets(binned, y, local, weight, n_nodes: int, n_bins: int):
    """The kernel form (JAX ``_reg_histograms_pallas``) for T trees at
    once: (Σwy, Σwy², Σw), each (T, n_nodes, F, bins), from one K3 launch
    of :func:`reg_sets`."""
    t = local.shape[0]
    f = binned.shape[1]
    hist = fused_histogram_sets(binned, *reg_sets(y, local, weight), n_bins,
                                n_nodes)
    hist = hist.view(t, 2, f, n_nodes, 2, n_bins).transpose(2, 3)
    return hist[:, 0, :, :, 0], hist[:, 0, :, :, 1], hist[:, 1, :, :, 0]


def _node_sums_sets(local, gw, hw, n_nodes: int):
    """``growth.node_sums`` over (S, N) inputs, sets taken in chunks that
    bound the (sets, rows, nodes) mask."""
    step = max(1, _NODE_SUM_ELEMENTS // max(1, local.shape[1] * n_nodes))
    parts = [node_sums(local[i:i + step], gw[i:i + step], hw[i:i + step],
                       n_nodes) for i in range(0, local.shape[0], step)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def final_level_sums(classification: bool, f: int, y, y_cls, local, weight,
                     n_nodes: int, n_bins: int, n_classes: int):
    """A final level never splits: its decision needs per-node class
    counts (or y moments) only. JAX ``_final_level_sums``: histogram-shaped
    arrays with everything in bin 0 of feature 0, for T trees at once."""
    t = local.shape[0]
    dev = local.device
    if classification:
        cols = []
        for c0 in range(0, n_classes, 2):
            a, b = _node_sums_sets(local, weight * (y_cls == c0),
                                   weight * (y_cls == c0 + 1), n_nodes)
            cols.extend([a, b])
        counts = torch.stack(cols[:n_classes], dim=-1)        # (T, K, C)
        hist = torch.zeros((t, n_nodes, f, n_bins, n_classes),
                           dtype=torch.float32, device=dev)
        hist[:, :, :, 0, :] = counts[:, :, None, :]
        return hist
    ones = torch.ones_like(weight)
    st, ct = _node_sums_sets(local, y * weight, ones * weight, n_nodes)
    s2t, _ = _node_sums_sets(local, y * y * weight, ones * weight, n_nodes)

    def shaped(v):
        out = torch.zeros((t, n_nodes, f, n_bins), dtype=torch.float32,
                          device=dev)
        out[:, :, :, 0] = v[:, :, None]
        return out

    return shaped(st), shaped(s2t), shaped(ct)


# -- split finding -----------------------------------------------------------

def _bin_cumsum(x, bin_dim: int):
    """``ordered_cumsum`` over the bin axis."""
    return ordered_cumsum(x.movedim(bin_dim, -1)).movedim(-1, bin_dim)


def gini_splits(hist, feat_mask):
    """Weighted-gini impurity decrease per (node, feature, bin) candidate
    (JAX ``_gini_splits``). hist: (..., nodes, F, B, C); feat_mask
    (..., nodes, F). Returns (gains, node class counts (..., nodes, C))."""
    left = _bin_cumsum(hist, -2)
    total = left[..., -1:, :]
    right = total - left
    n_l = ordered_sum(left)
    n_r = ordered_sum(right)
    n_p = n_l + n_r

    def gini_w(counts, n):  # n * gini = n - Σ c²/n
        return torch.where(n > 0, n - ordered_sum(counts * counts)
                           / torch.clamp_min(n, 1e-12), 0.0)

    parent_imp = gini_w(total[..., 0, :], n_p[..., 0])[..., None]
    gain = ((parent_imp - gini_w(left, n_l) - gini_w(right, n_r))
            / torch.clamp_min(n_p, 1e-12))
    ok = (n_l > 0) & (n_r > 0) & feat_mask[..., None]
    ok[..., -1] = False
    return (torch.where(ok, gain, float("-inf")), total[..., 0, 0, :])


def variance_splits(s, s2, c, feat_mask):
    """Variance-reduction gain per candidate (JAX ``_variance_splits``).
    s/s2/c: (..., nodes, F, B) weighted sums of y, y², counts."""
    sl, s2l, cl = (_bin_cumsum(v, -1) for v in (s, s2, c))
    st, s2t, ct = sl[..., -1:], s2l[..., -1:], cl[..., -1:]
    sr, s2r, cr = st - sl, s2t - s2l, ct - cl

    def var_w(sv, s2v, cv):  # c * var = Σy² − (Σy)²/c
        return torch.where(cv > 0, s2v - sv * sv / torch.clamp_min(cv, 1e-12),
                           0.0)

    gain = ((var_w(st, s2t, ct) - var_w(sl, s2l, cl) - var_w(sr, s2r, cr))
            / torch.clamp_min(ct, 1e-12))
    ok = (cl > 0) & (cr > 0) & feat_mask[..., None]
    ok[..., -1] = False
    return torch.where(ok, gain, float("-inf"))


# -- one level for all trees -------------------------------------------------

def level_step(binned, y, y_cls, node_id, boot_w, feat_mask, parent_hists, *,
               classification: bool, depth: int, n_bins: int,
               n_classes: int, final: bool, min_info_gain: float,
               method: str = "direct", want_hists: bool = True,
               reduce=None):
    """One level of every tree (JAX ``_make_level_step``'s level):
    ``node_id``/``boot_w`` (T, N), ``feat_mask`` (T, 2^depth, F). Returns
    ``(feature, split_bin, is_leaf, leaf_pred, node_id, hists)`` — the
    level's (T, 2^depth) tables, the rows' next node ids, and (``sub``
    method, non-final levels, ``want_hists``) the hists the next level's
    sibling subtraction reads as ``parent_hists``.

    ``method``: ``direct`` (K3's set form) or ``sub`` (the same with
    sibling subtraction and a final level from per-node sums). ``reduce``
    (the row-sharded path's all-reduce) maps the level's histograms
    before the gains; None keeps them as they are. On CPU
    tensors K3's plain version runs the JAX package's scatter order, so
    ``direct`` there is its CPU path bit for bit. Rows whose parent went
    leaf never re-enter a level, so under ``sub`` the right sibling of
    such a node inherits a phantom histogram — harmless: routing reaches
    a child only through a non-leaf parent."""
    n_nodes = 1 << depth
    offset = n_nodes - 1
    f = binned.shape[1]
    local = torch.clamp(node_id - offset, 0, n_nodes - 1).int()
    in_level = ((node_id >= offset) & (node_id < offset + n_nodes)).float()
    w = boot_w * in_level
    subtract = (method == "sub" and not final and depth >= 1
                and parent_hists is not None)
    if final and method == "sub":
        hists = final_level_sums(classification, f, y, y_cls, local, w,
                                 n_nodes, n_bins, n_classes)
    elif subtract:
        half = n_nodes // 2
        w_left = w * (local % 2 == 0)
        if classification:
            left = class_histograms_sets(binned, y_cls, local >> 1, w_left,
                                         half, n_bins, n_classes)
            hists = interleave_siblings(left, parent_hists - left, dim=1)
        else:
            left = reg_histograms_sets(binned, y, local >> 1, w_left, half,
                                       n_bins)
            hists = tuple(interleave_siblings(lv, pv - lv, dim=1)
                          for lv, pv in zip(left, parent_hists))
    elif classification:
        hists = class_histograms_sets(binned, y_cls, local, w, n_nodes,
                                      n_bins, n_classes)
    else:
        hists = reg_histograms_sets(binned, y, local, w, n_nodes, n_bins)
    if reduce is not None:
        hists = reduce(hists)

    if classification:
        gains, cls_counts = gini_splits(hists, feat_mask)
        leaf_pred = torch.argmax(cls_counts, dim=-1).float()
        n_node = ordered_sum(cls_counts)
    else:
        s, s2, c = hists
        gains = variance_splits(s, s2, c, feat_mask)
        st, ct = ordered_sum(s[:, :, 0, :]), ordered_sum(c[:, :, 0, :])
        leaf_pred = torch.where(ct > 0, st / torch.clamp_min(ct, 1e-12), 0.0)
        n_node = ct
    t, nn, _, b = gains.shape
    flat = gains.reshape(t, nn, -1)
    flat_best = torch.argmax(flat, dim=-1)
    best_gain = flat.gather(-1, flat_best[..., None])[..., 0]
    feature = torch.div(flat_best, b, rounding_mode="floor").int()
    split_bin = (flat_best % b).int()
    if final:
        is_leaf = torch.ones_like(best_gain, dtype=torch.bool)
    else:
        thr = float(np.float32(max(min_info_gain, 1e-12)))
        is_leaf = ~(best_gain >= thr)
    is_leaf = is_leaf | (n_node <= 0)
    new_node_id = (node_id if final else route_one_level(
        binned, node_id, feature, split_bin, is_leaf, offset, n_nodes))
    hists_out = hists if method == "sub" and not final and want_hists else None
    return feature, split_bin, is_leaf, leaf_pred, new_node_id, hists_out


# -- the model ---------------------------------------------------------------

class RandomForestModel:
    """Trained forest: complete-tree arrays (T, n_nodes) + cuts. Predict =
    route through all trees, majority vote (classification) or mean
    (regression) — MLlib ``predict`` semantics — on ``device`` (the card
    unless ``"cpu"``)."""

    def __init__(self, cuts, trees, max_depth: int, classification: bool,
                 num_classes: int = 0, device=None):
        self.cuts = cuts
        self.trees = trees
        self.max_depth = int(max_depth)
        self.classification = bool(classification)
        self.num_classes = int(num_classes)
        self.device = resolve_device(device)

    def predict_program(self, num_features: int):
        """The pure-function split of :meth:`predict` for the serving
        engine: ``(params, apply, prepare)`` — ``prepare(x)`` host-bins raw
        rows, ``params`` holds the tree tensors on the model's device and
        ``apply(params, binned)`` is the whole-forest program. Predict runs
        through this split, so engine outputs are bit-identical to direct
        prediction by construction."""
        params, leaves, tail, prepare = self.serving_split(num_features)

        def apply(p, binned):
            return tail(leaves(p, binned))

        return params, apply, prepare

    def serving_split(self, num_features: int):
        """:meth:`predict_program` cut where the AOT store compiles it:
        ``(params, leaves, tail, prepare)`` with ``leaves(params, binned)``
        each tree's leaf value per row (T, N) and ``tail(values)`` the
        votes' argmax (a classifier) or the mean (a regressor);
        ``apply`` is ``tail(leaves(...))``."""
        if num_features != len(self.cuts):
            raise DataError(f"the forest has {len(self.cuts)} features, "
                            f"got {num_features}")
        params = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                  for k, v in self.trees.items()}
        max_depth = self.max_depth
        classification, num_classes = self.classification, self.num_classes
        cuts = self.cuts

        def prepare(x: np.ndarray) -> np.ndarray:
            return binning.apply_bins(np.asarray(x, np.float32), cuts)

        def leaves(p, binned):
            return tree_leaf_values(binned, p["feature"], p["split_bin"],
                                    p["is_leaf"], p["leaf_value"],
                                    max_depth=max_depth)      # (T, N)

        def tail(preds):
            if classification:  # majority vote over trees, per row
                classes = torch.arange(num_classes, device=preds.device)
                votes = (preds.long()[..., None] == classes).sum(0)
                return torch.argmax(votes, dim=-1).int()
            # XLA's mean: the reduce times the f32 reciprocal of the count
            recip = float(np.float32(1) / np.float32(preds.shape[0]))
            return ordered_sum(preds.t()) * recip

        return params, leaves, tail, prepare

    def chunked_predict_program(self, num_features: int, chunk: int,
                                approx_mean: bool = False):
        """The chunk-sliced split of :meth:`predict_program` for the
        serving engine's chunked dispatch (``serve.trees.chunk``;
        trees/chunked.py). A classifier's carry is the ``(rows,
        num_classes)`` f32 vote count, exact in any order, so the replies
        are bit-equal to :meth:`predict`; pad trees vote class ``-1``,
        which matches no class. A regressor returns None: its mean sums
        the trees in the reduce order of ``ordered_sum``, which a
        sequential carry cannot replay. ``approx_mean=True``
        (``serve.trees.approx_mean``) serves a regressor anyway: a
        ``(rows,)`` f32 sum carry in tree order (pad trees add ``0.0``),
        divided once by the TRUE tree count — a reassociation of the
        whole-forest mean, held to the pinned ``(rf, chunked_mean)``
        envelope rather than bit-pinned. A chunk below 2 is refused, as in
        the JAX package."""
        if not self.classification and not approx_mean:
            return None
        from euromillioner_tpu_torch.trees.chunked import (ChunkedTreeProgram,
                                                           slice_blocks)

        chunk = int(chunk)
        if chunk < 2:
            raise TrainError(
                f"serve.trees.chunk must be >= 2, got {chunk}")
        if num_features != len(self.cuts):
            raise DataError(f"the forest has {len(self.cuts)} features, "
                            f"got {num_features}")
        n_trees = int(np.asarray(self.trees["feature"]).shape[0])
        regression = not self.classification
        blocks = slice_blocks(self.trees, 0, n_trees, chunk,
                              pad_leaf_value=0.0 if regression else -1.0)
        max_depth, num_classes = self.max_depth, self.num_classes
        cuts = self.cuts

        def prepare(x: np.ndarray) -> np.ndarray:
            return binning.apply_bins(np.asarray(x, np.float32), cuts)

        def preds(p, binned):
            return tree_leaf_values(binned, p["feature"], p["split_bin"],
                                    p["is_leaf"], p["leaf_value"],
                                    max_depth=max_depth)      # (chunk, N)

        signature = (f"rf|depth={max_depth}|classes={num_classes}"
                     f"|regression={int(regression)}")

        if regression:
            def init_carry(n_rows: int) -> np.ndarray:
                return np.zeros((int(n_rows),), np.float32)

            def chunk_apply(p, carry, binned):
                return add_leaf_values(carry, preds(p, binned))

            # one divide by the TRUE tree count (pad trees added 0.0), as
            # XLA computes it: times the f32 reciprocal of the count
            recip = float(np.float32(1) / np.float32(n_trees))

            def finish_apply(acc):
                return acc * recip

            return ChunkedTreeProgram(
                chunk=chunk, n_trees=n_trees, blocks=blocks,
                chunk_apply=chunk_apply, finish_apply=finish_apply,
                init_carry=init_carry, prepare=prepare, leaves_apply=preds,
                carry_apply=add_leaf_values, signature=signature)

        def init_carry(n_rows: int) -> np.ndarray:
            return np.zeros((int(n_rows), num_classes), np.float32)

        def add_votes(carry, values):
            classes = torch.arange(num_classes, device=values.device)
            votes = (values.long()[..., None] == classes).sum(0)
            return carry + votes.to(torch.float32)

        def chunk_apply(p, carry, binned):
            return add_votes(carry, preds(p, binned))

        def finish_apply(votes):
            # the whole-forest argmax over the same exact counts: ties
            # break the same way
            return torch.argmax(votes, dim=-1).int()

        return ChunkedTreeProgram(
            chunk=chunk, n_trees=n_trees, blocks=blocks,
            chunk_apply=chunk_apply, finish_apply=finish_apply,
            init_carry=init_carry, prepare=prepare, leaves_apply=preds,
            carry_apply=add_votes, signature=signature)

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        params, apply, prepare = self.predict_program(x.shape[1])
        with torch.inference_mode():
            out = apply(params, torch.from_numpy(prepare(x)).to(self.device))
        return out.cpu().numpy().astype(
            np.int32 if self.classification else np.float32)

    def save_model(self, path: str) -> None:
        """The JAX package's model JSON (each package loads the other's)."""
        payload = {
            "max_depth": self.max_depth,
            "classification": self.classification,
            "num_classes": self.num_classes,
            "cuts": [c.tolist() for c in self.cuts],
            "trees": {k: np.asarray(v).tolist()
                      for k, v in self.trees.items()},
        }
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)

    @classmethod
    def load_model(cls, path: str, device=None) -> "RandomForestModel":
        """A model JSON written by either package, predicting on
        ``device`` (the card unless ``"cpu"``)."""
        with open(path, encoding="utf-8") as fh:
            p = json.load(fh)
        trees = {k: np.asarray(p["trees"][k], dt)
                 for k, dt in _TREE_DTYPES.items()}
        return cls([np.asarray(c, np.float32) for c in p["cuts"]], trees,
                   p["max_depth"], p["classification"], p["num_classes"],
                   device=device)


def reachable_trees(trees: dict, max_depth: int) -> dict:
    """The tree arrays with every node that no row can reach (a node under
    a leaf) reset to a leaf of value 0, and every leaf's split fields set
    to 0: what decides predictions. Sibling subtraction leaves phantom
    statistics in unreachable nodes and the final level carries no split,
    so the two histogram methods agree on this form, not on the raw
    arrays."""
    out = {k: np.array(v, copy=True) for k, v in trees.items()}
    leaf = out["is_leaf"]
    reach = np.zeros_like(leaf)
    reach[:, 0] = True
    for node in range((1 << max_depth) - 1):
        down = reach[:, node] & ~leaf[:, node]
        reach[:, 2 * node + 1] = down
        reach[:, 2 * node + 2] = down
    out["is_leaf"] = np.where(reach, leaf, True)
    out["leaf_value"] = np.where(reach, out["leaf_value"], 0.0).astype(
        np.float32)
    for k in ("feature", "split_bin"):
        out[k] = np.where(reach & ~out["is_leaf"], out[k], 0).astype(np.int32)
    return out


def _resolve_rf_hist(method: str, device: torch.device, mesh=None) -> str:
    """auto → ``direct``, pallas → ``sub`` (one device only), scatter →
    ``direct`` (CPU only): see the module note."""
    if method not in ("auto", "scatter", "pallas"):
        raise TrainError(
            f"hist_method must be auto|scatter|pallas, got {method!r}")
    if method == "pallas" and mesh is not None:
        raise TrainError(
            "hist_method=pallas is single-device only; the mesh path shards "
            "rows and all-reduces each level's histograms — use "
            "hist_method=auto with mesh=")
    if method == "scatter" and device.type != "cpu":
        raise TrainError(
            "hist_method=scatter is the CPU formulation; on the card the "
            "histograms go through the kernel: use hist_method=auto or "
            "pallas")
    return "sub" if method == "pallas" else "direct"


def _train(x, y, *, classification: bool, num_classes: int = 0,
           num_trees: int = 100, max_depth: int = 8, max_bins: int = 32,
           feature_subset: str | float = "auto", bootstrap: bool = True,
           min_info_gain: float = 0.0, seed: int = 0, mesh=None,
           hist_method: str = "auto", device=None) -> RandomForestModel:
    if mesh is not None and device is None:
        device = mesh.device  # a mesh's forest grows on the mesh's device
    dev = resolve_device(device)
    if mesh is not None and dev.type != mesh.device.type:
        raise ConfigError(f"the forest's device {dev} is not the mesh's "
                          f"{mesh.device}")
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32).reshape(-1)
    if x.ndim != 2 or len(x) != len(y):
        raise DataError(f"bad forest inputs: x{x.shape} y{y.shape}")
    if classification:
        if num_classes < 2:
            raise DataError(f"num_classes must be >= 2, got {num_classes}")
        if ((y % 1) != 0).any() or y.min() < 0 or y.max() >= num_classes:
            raise DataError(
                f"classification labels must be integers in [0, "
                f"{num_classes}), got range [{y.min()}, {y.max()}]")
    n, n_features = x.shape
    m = resolve_feature_subset(feature_subset, n_features, classification)
    cuts = binning.quantile_cuts(x, max_bins)
    n_bins = binning.num_bins(cuts)
    method = _resolve_rf_hist(hist_method, dev, mesh)

    # drawn at the true row count, so padding never moves the draws
    boot_w, masks = draw_forest(seed, num_trees, n, n_features, m, max_depth,
                                bootstrap)
    binned_np = binning.apply_bins(x, cuts)
    reduce = None
    if mesh is not None:
        from euromillioner_tpu_torch.dist.collectives import all_reduce_tree

        padded = round_up_multiple(n, mesh.data)
        pad = padded - n
        if pad:  # zero bootstrap weight: invisible to the histograms
            binned_np = np.concatenate(
                [binned_np, np.zeros((pad, n_features), binned_np.dtype)])
            y = np.concatenate([y, np.zeros(pad, np.float32)])
            boot_w = torch.cat([boot_w, torch.zeros((num_trees, pad))], 1)
        share = padded // mesh.data
        rows = slice(mesh.rank * share, (mesh.rank + 1) * share)
        binned_np, y, boot_w = binned_np[rows], y[rows], boot_w[:, rows]

        def reduce(hists):
            return all_reduce_tree(hists, mesh)

    def put(a):
        return torch.as_tensor(a).to(dev)

    binned = put(binned_np)
    y_t = put(y)
    n_rows = len(y)
    n_cls = max(num_classes, 1)
    y_cls = (torch.clamp(y_t, 0, n_cls - 1).int() if classification
             else torch.zeros(n_rows, dtype=torch.int32, device=dev))
    boot_w = put(boot_w)
    node_id = torch.zeros((num_trees, n_rows), dtype=torch.int32, device=dev)
    levels = []
    parent = None
    for d in range(max_depth + 1):
        feature, split_bin, is_leaf, leaf_pred, node_id, parent = level_step(
            binned, y_t, y_cls, node_id, boot_w, put(masks[d]), parent,
            classification=classification, depth=d, n_bins=n_bins,
            n_classes=n_cls, final=d == max_depth,
            min_info_gain=min_info_gain, method=method,
            want_hists=d + 1 < max_depth, reduce=reduce)
        levels.append((feature, split_bin, is_leaf, leaf_pred))
    trees = {k: torch.cat([lv[i] for lv in levels], dim=1).cpu().numpy()
             .astype(_TREE_DTYPES[k]) for i, k in enumerate(_TREE_KEYS)}
    logger.info("trained forest: %d trees, depth %d, %d features (%d per "
                "node), %s histograms%s", num_trees, max_depth, n_features, m,
                hist_method, "" if mesh is None
                else f", rows sharded over {mesh.data} ranks")
    return RandomForestModel(cuts, trees, max_depth, classification,
                             num_classes, device=dev)


def train_classifier(x, y, num_classes: int, **kw) -> RandomForestModel:
    """MLlib ``RandomForest.trainClassifier`` analog (gini impurity), on
    ``device`` (the card when None; ``"cpu"`` for the CPU)."""
    return _train(x, y, classification=True, num_classes=num_classes, **kw)


def train_regressor(x, y, **kw) -> RandomForestModel:
    """MLlib ``RandomForest.trainRegressor`` analog (variance impurity), on
    ``device`` (the card when None; ``"cpu"`` for the CPU)."""
    return _train(x, y, classification=False, **kw)

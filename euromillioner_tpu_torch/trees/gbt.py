"""Gradient-boosted trees: the xgboost4j path the reference runs (the JAX
package's ``trees/gbt.py``).

``DMatrix`` from arrays or from CSV with ``?format=csv&label_column=k``
URI semantics, ``train(params, dtrain, num_boost_round, evals)`` printing
one xgboost-format eval line per round, ``Booster.predict``, and JSON
model save/load in the JAX package's format (each package loads the
other's files). Defaults mirror the reference's literal config (eta=1.0,
max_depth=3, gamma=1.0, subsample=1, reg:logistic).

Execution model: the rounds run as a Python loop of tensor ops on the
training device; each level of each tree launches the histogram kernel
(K3) once on the card. ``fuse_rounds`` keeps the JAX package's meaning as
the unit of work between host syncs: the round metrics of a chunk come to
the host in one copy, and nothing syncs inside a chunk. Results are
identical across ``fuse_rounds`` settings.

Devices: ``device=auto|cuda|gpu`` (the default ``auto``) trains on the
card and raises when there is none; ``cpu`` trains on the CPU through the
kernel's plain version.
"""

from __future__ import annotations

import json
from typing import Mapping, Sequence
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.train.metrics import eval_line
from euromillioner_tpu_torch.trees import binning
from euromillioner_tpu_torch.trees.growth import (add_leaf_values,
                                                  grow_level, grow_level_sub,
                                                  predict_margin, route,
                                                  tree_leaf_values)
from euromillioner_tpu_torch.trees.objectives import (Objective, get_metric,
                                                      get_objective)
from euromillioner_tpu_torch.utils.errors import (ConfigError, DataError,
                                                  TrainError)
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("trees.gbt")

# The reference GBT config as xgboost-style values (the JAX package's keys,
# so a saved model's params read the same in both packages).
DEFAULT_PARAMS: dict = {
    "booster": "gbtree",
    "eta": 1.0,
    "max_depth": 3,
    "objective": "reg:logistic",
    "subsample": 1.0,
    "colsample_bytree": 1.0,
    "gamma": 1.0,
    "lambda": 1.0,
    "eval_metric": None,  # resolved from the objective's default when unset
    "base_score": 0.5,
    "min_child_weight": 1.0,
    "max_bins": 256,
    "seed": 0,
    "device": "auto",
    # histogram formulation: auto | scatter | matmul | pallas (see
    # _resolve_hist_method)
    "hist_method": "auto",
}

# No-effect-here params accepted silently (threading and verbosity).
_IGNORED_PARAMS = {"silent", "nthread", "n_jobs", "predictor", "verbosity",
                   "tree_method", "validate_parameters",
                   "disable_default_eval_metric"}

# xgboost aliases → canonical names (xgboost accepts both spellings).
_PARAM_ALIASES = {"reg_lambda": "lambda", "learning_rate": "eta",
                  "min_split_loss": "gamma", "random_state": "seed",
                  "max_bin": "max_bins"}

# Valid xgboost4j params whose behaviour this engine does not implement:
# warned about and ignored, as in the JAX package.
_UNSUPPORTED_PARAMS = {"alpha", "reg_alpha", "colsample_bylevel",
                       "colsample_bynode", "max_delta_step",
                       "scale_pos_weight", "grow_policy", "max_leaves",
                       "sampling_method", "num_parallel_tree",
                       "monotone_constraints", "interaction_constraints"}

_TREE_KEYS = ("feature", "split_bin", "is_leaf", "leaf_value")


def _resolve_fuse_rounds(fuse_rounds, num_boost_round: int,
                         early_stopping_rounds: int | None,
                         streaming: bool = False,
                         eval_flush_every: int = 1) -> int:
    """``fuse_rounds=None`` (the default) = auto: the whole job is one
    chunk, unless early stopping (patience-sized chunks bound the
    overshoot to one patience) or live eval-line streaming (chunks of
    ``eval_flush_every``) needs the host between rounds."""
    if fuse_rounds is None:
        if early_stopping_rounds is not None:
            return max(1, int(early_stopping_rounds))
        if streaming:
            return max(1, int(eval_flush_every))
        return max(1, int(num_boost_round))
    if fuse_rounds < 1:
        raise TrainError(f"fuse_rounds must be >= 1, got {fuse_rounds}")
    return int(fuse_rounds)


def resolve_train_device(spec) -> torch.device:
    """The xgboost ``device`` param → a torch device. ``auto``, ``cuda``
    and ``gpu`` (an ordinal such as ``cuda:0`` is accepted and dropped)
    mean the card, and raise when there is none; ``cpu`` forces the
    CPU."""
    spec = str(spec).lower().split(":", 1)[0]
    if spec in ("auto", "cuda", "gpu"):
        return resolve_device(None)
    if spec == "cpu":
        return torch.device("cpu")
    if spec in ("tpu", "sycl"):
        raise ConfigError(
            f"device={spec} has no analog in this port: it trains on a CUDA "
            f"card (device=auto|cuda|gpu) or on the CPU (device=cpu)")
    raise TrainError(f"device must be auto|cpu|cuda|gpu, got {spec!r}")


def _resolve_hist_method(spec: str, device: torch.device) -> str:
    """``direct`` (one full histogram per level, the final level included)
    or ``sub`` (sibling subtraction; the final level takes per-node sums).
    ``auto`` is direct — through K3 on the card, the plain scatter on the
    CPU; ``pallas`` is the JAX spelling of the kernel with sibling
    subtraction; ``scatter`` is the CPU formulation."""
    spec = str(spec).lower()
    if spec not in ("auto", "scatter", "matmul", "pallas"):
        raise TrainError(
            f"hist_method must be auto|scatter|matmul|pallas, got {spec!r}")
    if spec == "matmul":
        raise TrainError(
            "hist_method=matmul is the TPU's one-hot matmul formulation and "
            "has no counterpart here; use auto (the histogram kernel on the "
            "card, the scatter on the CPU) or pallas (sibling subtraction)")
    if spec == "scatter" and device.type != "cpu":
        raise TrainError(
            "hist_method=scatter is the CPU formulation; on the card the "
            "histograms go through the kernel: use hist_method=auto or "
            "pallas")
    return "sub" if spec == "pallas" else "direct"


class _DeviceDMatrix:
    """What a custom obj/feval callback sees: a DMatrix-shaped view whose
    ``get_label()`` is the label tensor on the training device."""

    def __init__(self, labels, num_col: int):
        self._labels = labels
        self.num_col = num_col

    def get_label(self):
        return self._labels

    def __len__(self) -> int:
        return self._labels.shape[0]


class DMatrix:
    """Features (+ optional label): the reference's data handle. Accepts
    arrays or a CSV path with the xgboost URI form
    ``path?format=csv&label_column=0``."""

    def __init__(self, data, label=None):
        if isinstance(data, str):
            data, label = _load_csv_uri(data, label)
        # always copy: the quantization cache would go stale if a caller
        # mutated an aliased input array after construction
        self.x = np.array(data, np.float32, copy=True)
        if self.x.ndim != 2:
            raise DataError(f"DMatrix needs (N, F) features, got {self.x.shape}")
        self.y = None if label is None else np.asarray(label, np.float32).reshape(-1)
        if self.y is not None and len(self.y) != len(self.x):
            raise DataError(
                f"label length {len(self.y)} != rows {len(self.x)}")
        self._bin_cache: dict[int, tuple[list, np.ndarray]] = {}

    def quantized(self, max_bins: int) -> tuple[list, np.ndarray]:
        """(cuts, binned) at ``max_bins``, computed once and cached."""
        hit = self._bin_cache.get(max_bins)
        if hit is None:
            cuts = binning.quantile_cuts(self.x, max_bins)
            hit = (cuts, binning.apply_bins(self.x, cuts))
            self._bin_cache[max_bins] = hit
        return hit

    def __len__(self) -> int:
        return len(self.x)

    def get_label(self) -> np.ndarray:
        if self.y is None:
            raise DataError("DMatrix has no label")
        return self.y

    @property
    def num_col(self) -> int:
        return self.x.shape[1]


def _load_csv_uri(uri: str, label):
    from euromillioner_tpu_torch.data.csvio import read_csv

    parts = urlsplit(uri)
    params = parse_qs(parts.query)
    label_column = int(params.get("label_column", [-1])[0])
    if label_column >= 0:
        x, y, _ = read_csv(parts.path, label_column=label_column)
        return x, y
    x, _, _ = read_csv(parts.path, label_column=None)
    return x, label


class Booster:
    """Trained ensemble: stacked complete-binary-tree arrays (numpy,
    (T, n_nodes)) + binning cuts; ``predict`` routes rows through every
    tree on ``device``."""

    def __init__(self, params: dict, cuts: list[np.ndarray], trees: dict,
                 base_margin: float, objective=None, device=None):
        self.params = dict(params)
        self.cuts = cuts
        self.trees = trees
        self.base_margin = float(base_margin)
        # custom objectives carry their own transform; after save/load the
        # params record objective="custom" and predictions stay raw margins
        if objective is None:
            if self.params.get("objective") == "custom":
                objective = Objective("custom", None, lambda m: m, float,
                                      "rmse")
            else:
                objective = get_objective(self.params["objective"])
        self.objective = objective
        self.max_depth = int(self.params["max_depth"])
        self.device = resolve_device(device)
        # early-stopping bookkeeping (xgboost API parity); set by train
        self.best_iteration: int | None = None
        self.best_score: float | None = None
        self.best_ntree_limit: int | None = None

    @property
    def num_boosted_rounds(self) -> int:
        return len(self.trees["feature"])

    def _resolve_range(self, iteration_range: tuple[int, int] | None,
                       ntree_limit: int = 0) -> tuple[int, int]:
        """xgboost range semantics → a concrete [lo, hi) tree window."""
        if ntree_limit:
            if iteration_range is not None:
                raise TrainError(
                    "pass iteration_range or ntree_limit, not both")
            iteration_range = (0, min(int(ntree_limit),
                                      self.num_boosted_rounds))
        if iteration_range is not None and tuple(iteration_range) == (0, 0):
            # xgboost documents (0, 0) as "use ALL trees"
            iteration_range = (0, self.num_boosted_rounds)
        elif iteration_range is None:
            iteration_range = (0, self.best_ntree_limit
                               if self.best_ntree_limit is not None
                               else self.num_boosted_rounds)
        lo, hi = iteration_range
        if not 0 <= lo <= hi <= self.num_boosted_rounds:
            raise TrainError(
                f"iteration_range {iteration_range!r} out of bounds for "
                f"{self.num_boosted_rounds} boosted rounds")
        return int(lo), int(hi)

    def predict_program(self, num_col: int,
                        iteration_range: tuple[int, int] | None = None,
                        output_margin: bool = False):
        """The pure-function split of :meth:`predict` for the serving
        engine: ``(params, apply, prepare)`` — ``prepare(x)`` host-bins raw
        feature rows, ``params`` holds the tree tensors of the range on
        the booster's device and ``apply(params, binned)`` is the ensemble
        program. :meth:`predict` runs through this split, so engine
        outputs are bit-identical to direct prediction by construction."""
        return self._program(num_col, *self._resolve_range(iteration_range),
                             output_margin)

    def serving_split(self, num_col: int, output_margin: bool = False):
        """:meth:`predict_program` cut where the AOT store compiles it:
        ``(params, leaves, tail, prepare)`` with ``leaves(params, binned)``
        each tree's leaf value per row (T, N) and ``tail(values)`` the
        margin summed in tree order and transformed — ``tail(leaves(p,
        x))`` is ``apply(p, x)`` op for op, so it is bit-equal to
        :meth:`predict`."""
        params, _apply, prepare = self.predict_program(
            num_col, output_margin=output_margin)
        transform = self.objective.transform
        base_margin, max_depth = self.base_margin, self.max_depth

        def leaves(p, binned):
            return tree_leaf_values(binned, p["feature"], p["split_bin"],
                                    p["is_leaf"], p["leaf_value"],
                                    max_depth=max_depth)

        def tail(values):
            margin = torch.full((values.shape[1],), base_margin,
                                dtype=torch.float32, device=values.device)
            if values.shape[0]:
                margin = add_leaf_values(margin, values)
            return margin if output_margin else transform(margin)

        return params, leaves, tail, prepare

    def _program(self, num_col: int, lo: int, hi: int, output_margin: bool):
        if num_col != len(self.cuts):
            raise DataError(f"the booster has {len(self.cuts)} features, "
                            f"got {num_col}")
        params = {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi])).to(
            self.device) for k, v in self.trees.items()}
        transform = self.objective.transform
        base_margin, max_depth = self.base_margin, self.max_depth
        cuts = self.cuts

        def prepare(x: np.ndarray) -> np.ndarray:
            return binning.apply_bins(np.asarray(x, np.float32), cuts)

        def apply(p, binned):
            margin = predict_margin(binned, p["feature"], p["split_bin"],
                                    p["is_leaf"], p["leaf_value"],
                                    base_margin, max_depth=max_depth)
            return margin if output_margin else transform(margin)

        return params, apply, prepare

    def chunked_predict_program(self, num_col: int, chunk: int,
                                iteration_range: tuple[int, int] | None
                                = None, output_margin: bool = False):
        """The chunk-sliced split of :meth:`predict_program` for the
        serving engine's chunked dispatch (``serve.trees.chunk``;
        trees/chunked.py): the range's tree tables cut into ``chunk``-tree
        host blocks (the tail padded with trees whose ``-0.0`` leaves are
        bitwise no-ops), ``chunk_apply(block, margin, binned)`` adding each
        tree's leaf to the f32 margin carry in tree order with
        :func:`~euromillioner_tpu_torch.trees.growth.accumulate_leaves`
        (the whole-ensemble program's arithmetic), ``init_carry`` the
        ``base_margin`` every row starts from, and ``finish_apply`` the
        objective's transform (nothing under ``output_margin``). The
        replies are bit-equal to :meth:`predict`. A chunk below 2 is
        refused, as in the JAX package (there a 1-tree scan rounds
        otherwise)."""
        from euromillioner_tpu_torch.trees.chunked import (ChunkedTreeProgram,
                                                           slice_blocks)

        chunk = int(chunk)
        if chunk < 2:
            raise TrainError(
                f"serve.trees.chunk must be >= 2, got {chunk}")
        if num_col != len(self.cuts):
            raise DataError(f"the booster has {len(self.cuts)} features, "
                            f"got {num_col}")
        lo, hi = self._resolve_range(iteration_range)
        blocks = slice_blocks(self.trees, lo, hi, chunk,
                              pad_leaf_value=-0.0)
        transform = self.objective.transform
        base_margin, max_depth = self.base_margin, self.max_depth
        cuts = self.cuts

        def prepare(x: np.ndarray) -> np.ndarray:
            return binning.apply_bins(np.asarray(x, np.float32), cuts)

        def init_carry(n_rows: int) -> np.ndarray:
            # the same f32 value predict_margin's torch.full starts from
            return np.full(int(n_rows), base_margin, np.float32)

        def leaves_apply(p, binned):
            return tree_leaf_values(binned, p["feature"], p["split_bin"],
                                    p["is_leaf"], p["leaf_value"],
                                    max_depth=max_depth)

        def chunk_apply(p, carry, binned):
            return add_leaf_values(carry, leaves_apply(p, binned))

        def finish_apply(carry):
            return carry if output_margin else transform(carry)

        return ChunkedTreeProgram(
            chunk=chunk, n_trees=hi - lo, blocks=blocks,
            chunk_apply=chunk_apply, finish_apply=finish_apply,
            init_carry=init_carry, prepare=prepare,
            leaves_apply=leaves_apply, carry_apply=add_leaf_values,
            signature=f"gbt|depth={max_depth}|{self.objective.name}"
                      f"|margin={int(bool(output_margin))}")

    def predict(self, dmat: DMatrix, output_margin: bool = False,
                iteration_range: tuple[int, int] | None = None,
                ntree_limit: int = 0) -> np.ndarray:
        """Route rows through the ensemble. ``iteration_range=(a, b)``
        uses trees [a, b); ``ntree_limit=N`` is the legacy spelling for
        (0, N). After early stopping, no range means the best iteration."""
        lo, hi = self._resolve_range(iteration_range, ntree_limit)
        params, apply, prepare = self._program(dmat.num_col, lo, hi,
                                               output_margin)
        out = apply(params, torch.from_numpy(prepare(dmat.x)).to(self.device))
        return out.cpu().numpy().astype(np.float32, copy=False)

    def eval_set(self, evals: Sequence[tuple[DMatrix, str]],
                 iteration: int = 0) -> str:
        results = {}
        metric = self.params["eval_metric"]
        fn = get_metric(metric)
        for dmat, name in evals:
            pred = torch.from_numpy(self.predict(dmat))
            results[name] = {metric: float(fn(pred, torch.from_numpy(dmat.y)))}
        return eval_line(iteration, results)

    # -- persistence (the JAX package's JSON model format) -----------------
    def save_model(self, path: str) -> None:
        payload = {
            "params": self.params,
            "base_margin": self.base_margin,
            "cuts": [c.tolist() for c in self.cuts],
            "trees": {k: np.asarray(v).tolist() for k, v in self.trees.items()},
            "best": {"iteration": self.best_iteration,
                     "score": self.best_score,
                     "ntree_limit": self.best_ntree_limit},
        }
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)

    @classmethod
    def load_model(cls, path: str, device=None) -> "Booster":
        """A model JSON written by either package, predicting on
        ``device`` (the card unless ``"cpu"``)."""
        with open(path, encoding="utf-8") as fh:
            payload = json.load(fh)
        bst = booster_from_arrays(payload["params"], payload["cuts"],
                                  payload["trees"], payload["base_margin"],
                                  device=device)
        best = payload.get("best", {})
        bst.best_iteration = best.get("iteration")
        bst.best_score = best.get("score")
        bst.best_ntree_limit = best.get("ntree_limit")
        return bst


def booster_from_arrays(params: Mapping, cuts, trees: Mapping,
                        base_margin: float, device=None) -> Booster:
    """A port :class:`Booster` from the JAX package's numpy tree arrays
    (``feature``, ``split_bin``, ``is_leaf``, ``leaf_value``, each
    (T, 2^(max_depth+1) − 1)), its cuts and base margin."""
    n_nodes = 2 ** (int(params["max_depth"]) + 1) - 1
    dtypes = {"feature": np.int32, "split_bin": np.int32, "is_leaf": bool,
              "leaf_value": np.float32}
    arrays = {k: np.asarray(trees[k], dt).reshape(-1, n_nodes)
              for k, dt in dtypes.items()}
    return Booster(dict(params), [np.asarray(c, np.float32) for c in cuts],
                   arrays, base_margin, device=device)


def _resolve_params(params: Mapping) -> dict:
    merged = dict(DEFAULT_PARAMS)
    for k, v in params.items():
        if k in _IGNORED_PARAMS:
            continue
        k = _PARAM_ALIASES.get(k, k)
        if k in _UNSUPPORTED_PARAMS:
            logger.warning(
                "gbt param %r=%r is valid xgboost but unsupported by this "
                "engine; ignoring (results may differ from xgboost)", k, v)
            continue
        if k not in DEFAULT_PARAMS:
            raise TrainError(f"unknown gbt param {k!r}")
        merged[k] = v
    if merged["booster"] != "gbtree":
        raise TrainError(f"only booster=gbtree is supported, got {merged['booster']!r}")
    if merged["eval_metric"] is None:
        merged["eval_metric"] = get_objective(
            merged["objective"]).default_metric
    return merged


def _f32(v) -> float:
    """A hyperparameter as the f32 value the arithmetic uses."""
    return float(np.float32(v))


def draw_sample(gen: torch.Generator, n: int, n_features: int,
                subsample: float, k_feats: int, device: torch.device):
    """One tree's row sample (f32 0/1 per row, each row kept with
    probability ``subsample``) and column sample (an (F,) 0/1 mask with
    ``k_feats`` ones, or None when every feature is eligible), drawn on
    ``device`` from ``gen``."""
    sampled = (torch.rand(n, generator=gen, device=device) < subsample
               ).float() if subsample < 1.0 else torch.ones(n, device=device)
    fmask = None
    if k_feats:
        sel = torch.randperm(n_features, generator=gen,
                             device=device)[:k_feats]
        fmask = torch.zeros(n_features, device=device).index_fill_(0, sel,
                                                                   1.0)
    return sampled, fmask


def _grow_tree(binned, grad, hess, sampled, fmask, *, max_depth, n_bins,
               method, hypers):
    """One tree, level by level: ``(tree tensors, leaf of each row)``."""
    node_id = torch.zeros(binned.shape[0], dtype=torch.int32,
                          device=binned.device)
    levels = []
    hists = None
    for d in range(max_depth):
        if method == "sub":
            res, hists = grow_level_sub(binned, node_id, sampled, grad, hess,
                                        hists, depth=d, n_bins=n_bins,
                                        feature_mask=fmask, **hypers)
        else:
            res = grow_level(binned, node_id, sampled, grad, hess, depth=d,
                             n_bins=n_bins, final=False, feature_mask=fmask,
                             **hypers)
        node_id = res.node_id
        levels.append(res)
    levels.append(grow_level(binned, node_id, sampled, grad, hess,
                             depth=max_depth, n_bins=n_bins, final=True,
                             feature_mask=fmask, final_sums=method == "sub",
                             **hypers))
    tree = {k: torch.cat([getattr(lv, k) for lv in levels])
            for k in _TREE_KEYS}
    return tree, levels[-1].node_id


def train(
    params: Mapping,
    dtrain: DMatrix,
    num_boost_round: int = 10,
    evals: Sequence[tuple[DMatrix, str]] | Mapping[str, DMatrix] = (),
    obj=None,
    feval=None,
    verbose_eval: bool = True,
    eval_flush_every: int = 1,
    evals_result: dict | None = None,
    fuse_rounds: int | None = None,
    early_stopping_rounds: int | None = None,
    maximize: bool = False,
) -> Booster:
    """Boost ``num_boost_round`` trees; per round, evaluate every watch and
    log the xgboost-format line.

    ``evals`` accepts xgboost4j's ``{name: DMatrix}`` map or the
    ``[(DMatrix, name)]`` list; ``evals_result``, when given, is filled in
    place as ``{name: {metric: [v_round0, ...]}}``. ``fuse_rounds`` rounds
    run between host syncs (see ``_resolve_fuse_rounds``); the eval lines
    of a chunk are logged when it ends. ``obj(margins, dtrain) -> (grad,
    hess)`` replaces the objective (predictions then stay raw margins) and
    ``feval(margins, dmatrix) -> (name, value)`` the eval metric; both get
    tensors on the training device. ``early_stopping_rounds`` stops when
    the LAST watch's metric has not improved for that many rounds
    (decreased, or increased with ``maximize``); with ``fuse_rounds`` > 1
    the decision lands on chunk boundaries. ``subsample`` and
    ``colsample_bytree`` draw from a ``torch.Generator`` seeded with
    ``params["seed"]`` on the training device.
    """
    p = _resolve_params(params)
    device = resolve_train_device(p["device"])
    method = _resolve_hist_method(p["hist_method"], device)
    if dtrain.y is None:
        raise TrainError("dtrain has no label")
    if isinstance(evals, Mapping):
        evals = [(dm, name) for name, dm in evals.items()]
    fuse_rounds = _resolve_fuse_rounds(
        fuse_rounds, num_boost_round, early_stopping_rounds,
        streaming=bool(verbose_eval) and len(evals) > 0,
        eval_flush_every=eval_flush_every)

    if obj is not None:
        user_obj = obj
        ncol = dtrain.num_col
        objective = Objective(
            "custom",
            lambda margin, y: user_obj(margin, _DeviceDMatrix(y, ncol)),
            lambda m: m, float, p["eval_metric"])
        p = dict(p, objective="custom")  # predict after load stays raw
    else:
        objective = get_objective(p["objective"])
    if feval is None:
        get_metric(p["eval_metric"])  # fail fast on bad names
    max_depth = int(p["max_depth"])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cuts, binned_np = dtrain.quantized(int(p["max_bins"]))
    n_bins = binning.num_bins(cuts)
    binned = put(binned_np)
    y = put(dtrain.y)
    base_margin = objective.base_margin(float(p["base_score"]))

    watches = [(put(binning.apply_bins(dm.x, cuts)), put(dm.y), name)
               for dm, name in evals]
    names = [name for _, _, name in watches]
    if early_stopping_rounds is not None:
        if not watches:
            raise TrainError("early_stopping_rounds needs at least one "
                             "watch in evals")
        if early_stopping_rounds < 1:
            raise TrainError(
                f"early_stopping_rounds must be >= 1, "
                f"got {early_stopping_rounds}")
    want_evals = bool(watches) and (verbose_eval or evals_result is not None
                                    or early_stopping_rounds is not None)
    if feval is not None and not evals:
        feval = None  # xgboost semantics: feval is unused without watches
    if feval is not None:
        # probe once for the metric's NAME (it must be static for logging)
        probe = watches[0][1]
        metric_name, _ = feval(torch.zeros_like(probe),
                               _DeviceDMatrix(probe, dtrain.num_col))

        def eval_fn(em, yb):
            return torch.as_tensor(
                feval(em, _DeviceDMatrix(yb, dtrain.num_col))[1],
                dtype=torch.float32, device=device)
    else:
        metric_name = p["eval_metric"]
        metric_fn = get_metric(metric_name)

        def eval_fn(em, yb):
            return metric_fn(objective.transform(em), yb)
    if not want_evals:
        watches = []

    n, n_features = binned.shape
    subsample = float(p["subsample"])
    colsample = float(p["colsample_bytree"])
    if not 0.0 < colsample <= 1.0:
        raise TrainError(
            f"colsample_bytree must be in (0, 1], got {colsample}")
    if not 0.0 < subsample <= 1.0:
        raise TrainError(f"subsample must be in (0, 1], got {subsample}")
    k_feats = (0 if colsample >= 1.0
               else max(1, int(round(colsample * n_features))))
    hypers = {"eta": _f32(p["eta"]), "reg_lambda": _f32(p["lambda"]),
              "gamma": _f32(p["gamma"]),
              "min_child_weight": _f32(p["min_child_weight"])}
    gen = torch.Generator(device=device).manual_seed(int(p["seed"]))

    margin = torch.full((n,), base_margin, dtype=torch.float32, device=device)
    eval_margins = [torch.full((len(yb),), base_margin, dtype=torch.float32,
                               device=device) for _, yb, _ in watches]

    if evals_result is not None:
        evals_result.clear()
        for name in names:
            evals_result[name] = {metric_name: []}

    stop_history: list[float] = []  # last watch's metric, per round

    def flush(round0: int, metrics: list) -> None:
        """One device→host copy for the chunk's metrics."""
        vals = torch.stack(metrics).cpu().numpy()
        for i in range(vals.shape[0]):
            results = {name: {metric_name: float(v)}
                       for name, v in zip(names, vals[i])}
            if evals_result is not None:
                for name, ms in results.items():
                    evals_result[name][metric_name].append(ms[metric_name])
            if verbose_eval:
                logger.info(eval_line(round0 + i, results))
            stop_history.append(float(vals[i][-1]))

    def best_round_idx() -> int:
        """First-best round over the LAST watch (xgboost tie rule)."""
        vals = np.asarray(stop_history)
        return int(np.argmax(vals) if maximize else np.argmin(vals))

    trees: list[dict] = []
    r0 = 0
    while r0 < num_boost_round:
        k = min(fuse_rounds, num_boost_round - r0)
        metrics = []
        for _ in range(k):
            grad, hess = objective.grad_hess(margin, y)
            sampled, fmask = draw_sample(gen, n, n_features, subsample,
                                         k_feats, device)
            tree, leaf = _grow_tree(binned, grad, hess, sampled, fmask,
                                    max_depth=max_depth, n_bins=n_bins,
                                    method=method, hypers=hypers)
            trees.append(tree)
            # train rows already sit at their leaf
            margin = margin + tree["leaf_value"][leaf]
            if watches:
                vals = []
                for i, (xb, yb, _) in enumerate(watches):
                    leaf_e = route(xb, tree["feature"], tree["split_bin"],
                                   tree["is_leaf"], max_depth=max_depth)
                    eval_margins[i] = (eval_margins[i]
                                       + tree["leaf_value"][leaf_e])
                    vals.append(eval_fn(eval_margins[i], yb))
                metrics.append(torch.stack(vals))
        if metrics:
            flush(r0, metrics)
        r0 += k
        if early_stopping_rounds is not None and stop_history:
            best = best_round_idx()
            if len(stop_history) - 1 - best >= early_stopping_rounds:
                logger.info("early stopping at round %d (best %s=%g at "
                            "round %d)", r0 - 1, metric_name,
                            stop_history[best], best)
                break

    n_nodes = 2 ** (max_depth + 1) - 1
    dtypes = {"feature": np.int32, "split_bin": np.int32, "is_leaf": bool,
              "leaf_value": np.float32}
    trees_np = {
        k: (torch.stack([t[k] for t in trees]).cpu().numpy().astype(dt)
            if trees else np.zeros((0, n_nodes), dt))
        for k, dt in dtypes.items()}
    booster = Booster(p, cuts, trees_np, base_margin, objective=objective,
                      device=device)
    if early_stopping_rounds is not None and stop_history:
        bi = best_round_idx()
        booster.best_iteration = bi
        booster.best_score = float(stop_history[bi])
        booster.best_ntree_limit = bi + 1
    return booster

"""GBT objectives (gradient/hessian pairs) and eval metrics on tensors
(the JAX package's ``trees/objectives.py``).

The reference trains with ``objective=reg:logistic`` and
``eval_metric=logloss``; the other members are the xgboost defaults its
config space implies. Margins are raw scores; each objective defines the
transform from margin to prediction.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from euromillioner_tpu_torch.utils.errors import TrainError


class Objective(NamedTuple):
    name: str
    # (margin, label) -> (grad, hess), elementwise
    grad_hess: Callable
    # margin -> prediction (what Booster.predict returns)
    transform: Callable
    # base_score (prob space) -> initial margin
    base_margin: Callable
    default_metric: str


def _logistic_grad_hess(margin, y):
    p = torch.sigmoid(margin)
    return p - y, torch.clamp_min(p * (1.0 - p), 1e-16)


# exp(r) for |r| <= ln 2 / 2 by its Taylor polynomial of degree 11 (error
# below 1e-14 relative); ln 2 split in two so that k * _LN2_HI is exact
_EXP_TAYLOR = tuple(1.0 / math.factorial(i) for i in range(12))
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10


def _sigmoid(margin):
    """1 / (1 + exp(-m)) in float32, bit for bit the same for an element
    wherever it sits in the batch and whatever the batch length. On the
    CPU ``torch.sigmoid`` rounds its vectorised loop and its scalar tail
    differently, so a served row (padded to its bucket) could differ by an
    ulp from ``predict`` of the same row. There exp(-m) is taken in float64
    from operations that every code path rounds exactly (+, -, *, rint and
    a power of two built from bits): 2^k exp(r) with k = rint(-m / ln 2),
    rounded once to float32; then 1 / (1 + e) in float32, the formula of
    ``torch.sigmoid``'s scalar path. A CUDA kernel computes every element
    alike, so on the card ``torch.sigmoid`` stays."""
    if margin.device.type != "cpu":
        return torch.sigmoid(margin)
    x = (-margin.to(torch.float64)).clamp(-700.0, 700.0)
    k = torch.round(x * (1.0 / math.log(2.0)))
    r = (x - k * _LN2_HI) - k * _LN2_LO
    e = torch.full_like(r, _EXP_TAYLOR[-1])
    for c in reversed(_EXP_TAYLOR[:-1]):
        e = e * r + c
    e = (e * ((k.to(torch.int64) + 1023) << 52).view(torch.float64)).to(
        margin.dtype)
    return torch.where(torch.isnan(margin), margin, 1.0 / (1.0 + e))


def _squared_grad_hess(margin, y):
    return margin - y, torch.ones_like(margin)


def _logit(p):
    p = np.clip(p, 1e-7, 1 - 1e-7)
    return float(np.log(p / (1 - p)))


def _identity(m):
    return m


OBJECTIVES: dict[str, Objective] = {
    "reg:logistic": Objective("reg:logistic", _logistic_grad_hess,
                              _sigmoid, _logit, "rmse"),
    "binary:logistic": Objective("binary:logistic", _logistic_grad_hess,
                                 _sigmoid, _logit, "logloss"),
    "binary:logitraw": Objective("binary:logitraw", _logistic_grad_hess,
                                 _identity, _logit, "logloss"),
    "reg:squarederror": Objective("reg:squarederror", _squared_grad_hess,
                                  _identity, float, "rmse"),
}


def get_objective(name: str) -> Objective:
    if name not in OBJECTIVES:
        raise TrainError(f"unknown objective {name!r} ({sorted(OBJECTIVES)})")
    return OBJECTIVES[name]


# -- eval metrics on transformed predictions ------------------------------

def _logloss(pred, y):
    p = torch.clamp(pred, 1e-7, 1 - 1e-7)
    return -torch.mean(y * torch.log(p) + (1 - y) * torch.log1p(-p))


def _rmse(pred, y):
    return torch.sqrt(torch.mean((pred - y) ** 2))


def _error(pred, y):
    return torch.mean(((pred > 0.5).to(torch.float32) != y)
                      .to(torch.float32))


def _mae(pred, y):
    return torch.mean(torch.abs(pred - y))


EVAL_METRICS: dict[str, Callable] = {
    "logloss": _logloss,
    "rmse": _rmse,
    "error": _error,
    "mae": _mae,
}


def get_metric(name: str) -> Callable:
    if name not in EVAL_METRICS:
        raise TrainError(f"unknown eval_metric {name!r} ({sorted(EVAL_METRICS)})")
    return EVAL_METRICS[name]

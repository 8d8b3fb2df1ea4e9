"""Optimizers as pure (init, update) pairs over named tensors (the JAX
package's ``train/optim.py``).

Parameters, gradients and updates are ``{name: tensor}`` dicts (the
``state_dict`` names, ``"0_LSTM.wx"``); optimizer state is a dict of such
dicts plus scalars, in the JAX package's layout so a checkpoint carries it
across (adam: ``{"count", "mu", "nu"}``). ``update`` returns new tensors and
changes none of its arguments. The arithmetic is the JAX package's term
for term. Adam in particular is not ``torch.optim.Adam``: eps sits outside
the bias correction, ``-lr * sqrt(1 - b2^c) / (1 - b1^c) * m / (sqrt(v) +
eps)``, which is another number than torch's ``m_hat / (sqrt(v_hat) +
eps)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

Params = dict[str, torch.Tensor]


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], tuple[Params, Any]]
    name: str = "optimizer"


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def _zeros_like(params: Params) -> Params:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _decayed(grads: Params, params: Params, weight_decay: float) -> Params:
    if not weight_decay:
        return grads
    return {k: g + weight_decay * params[k] for k, g in grads.items()}


def sgd(learning_rate: float, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        grads = _decayed(grads, params, weight_decay)
        return {k: -learning_rate * g for k, g in grads.items()}, state

    return Optimizer(init, update, "sgd")


def momentum(learning_rate: float, beta: float = 0.9,
             nesterov: bool = False, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"velocity": _zeros_like(params)}

    def update(grads, state, params):
        grads = _decayed(grads, params, weight_decay)
        vel = {k: beta * state["velocity"][k] + g for k, g in grads.items()}
        if nesterov:
            upd = {k: -learning_rate * (beta * vel[k] + g)
                   for k, g in grads.items()}
        else:
            upd = {k: -learning_rate * v for k, v in vel.items()}
        return upd, {"velocity": vel}

    return Optimizer(init, update, "momentum")


def rmsprop(learning_rate: float, decay: float = 0.9, eps: float = 1e-8,
            weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"nu": _zeros_like(params)}

    def update(grads, state, params):
        grads = _decayed(grads, params, weight_decay)
        nu = {k: decay * state["nu"][k] + (1 - decay) * g * g
              for k, g in grads.items()}
        upd = {k: -learning_rate * g / (torch.sqrt(nu[k]) + eps)
               for k, g in grads.items()}
        return upd, {"nu": nu}

    return Optimizer(init, update, "rmsprop")


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam (AdamW-style decoupled weight decay when weight_decay > 0)."""

    def init(params):
        dev = next(iter(params.values())).device if params else None
        return {"mu": _zeros_like(params), "nu": _zeros_like(params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        count = state["count"] + 1
        mu = {k: b1 * state["mu"][k] + (1 - b1) * g for k, g in grads.items()}
        nu = {k: b2 * state["nu"][k] + (1 - b2) * g * g
              for k, g in grads.items()}
        c = count.to(torch.float32)
        scale = learning_rate * torch.sqrt(1 - b2 ** c) / (1 - b1 ** c)
        upd = {}
        for k, m in mu.items():
            step = -scale * m / (torch.sqrt(nu[k]) + eps)
            if weight_decay:
                step = step - learning_rate * weight_decay * params[k]
            upd[k] = step
        return upd, {"mu": mu, "nu": nu, "count": count}

    return Optimizer(init, update, "adam")


def from_config(name: str, learning_rate: float, **kw) -> Optimizer:
    makers = {"sgd": sgd, "momentum": momentum, "rmsprop": rmsprop,
              "adam": adam}
    if name not in makers:
        raise ValueError(f"unknown optimizer {name!r} ({sorted(makers)})")
    return makers[name](learning_rate, **kw)


def from_train_config(tc) -> Optimizer:
    """The optimizer a ``TrainConfig`` names, with its ``weight_decay``,
    adam's ``beta1``/``beta2`` and momentum's ``momentum`` passed on under
    each maker's own parameter names."""
    kw: dict[str, Any] = {"weight_decay": tc.weight_decay}
    if tc.optimizer == "adam":
        kw.update(b1=tc.beta1, b2=tc.beta2)
    elif tc.optimizer == "momentum":
        kw["beta"] = tc.momentum
    return from_config(tc.optimizer, tc.learning_rate, **kw)

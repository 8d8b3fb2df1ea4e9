"""Training steps of the reference: mean squared error over every output,
gradients by autograd, then Adam as Kingma and Ba state it with eps
outside the bias correction (``-lr sqrt(1 - b2^t) / (1 - b1^t) * m /
(sqrt(v) + eps)``), all in float32."""

from __future__ import annotations

import torch


def adam_step(params: dict, grads: dict, state: dict, lr: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
              ) -> tuple[dict, dict]:
    t = state["t"] + 1
    mu = {k: b1 * state["mu"][k] + (1 - b1) * g for k, g in grads.items()}
    nu = {k: b2 * state["nu"][k] + (1 - b2) * g * g for k, g in grads.items()}
    scale = lr * (1 - b2 ** t) ** 0.5 / (1 - b1 ** t)
    new = {k: p - scale * mu[k] / (torch.sqrt(nu[k]) + eps)
           for k, p in params.items()}
    return new, {"t": t, "mu": mu, "nu": nu}


def train_steps(forward, params: dict, batches, lr: float):
    """Run Adam over ``batches`` ((x, y) pairs) from ``params``; returns
    (each step's loss, the first step's gradients, the final params).
    ``forward(params, x)`` gives the predictions."""
    params = {k: v.detach().to(torch.float32).clone()
              for k, v in params.items()}
    state = {"t": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
             "nu": {k: torch.zeros_like(v) for k, v in params.items()}}
    losses, first = [], None
    for x, y in batches:
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        pred = forward(leaves, x)
        loss = ((pred.to(torch.float32) - y) ** 2).mean()
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        with torch.no_grad():
            params = {k: v.detach() for k, v in leaves.items()}
            params, state = adam_step(params, grads, state, lr)
        losses.append(float(loss.detach()))
        if first is None:
            first = grads
    return losses, first, params

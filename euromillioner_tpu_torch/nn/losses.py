"""Losses and eval metrics (the JAX package's ``nn/losses.py``).

``logloss`` and ``error_rate`` are xgboost's eval metrics on
probabilities (logloss with a float32 clip); the training losses
(``sigmoid_binary_cross_entropy``, ``softmax_cross_entropy``) take logits
and are numerically stable. Every reducer takes an
optional ``mask`` so padded fixed-shape batches score only real rows: the
masked mean divides by ``sum(mask) * (values.numel() // mask.numel())``,
floored at 1, exactly as the JAX package does. ``mask_total`` stands in
for ``sum(mask)`` where the mask is one rank's share of a larger batch:
the data-parallel trainer passes the whole batch's count, so each rank's
loss is its share of the global mean and their sum is that mean.
"""

from __future__ import annotations

import torch

# xgboost clips at 1e-16 in double; 1 - 1e-16 rounds to 1.0 in float32,
# so the clip is the nearest value that keeps both log terms finite
_EPS = 1e-7


def _mean(values, mask=None, mask_total=None):
    if mask is None:
        return values.mean()
    mask = mask.reshape(mask.shape + (1,) * (values.dim() - mask.dim()))
    total = mask.sum() if mask_total is None else mask_total
    denom = torch.clamp(total * (values.numel() // mask.numel()), min=1.0)
    return (values * mask).sum() / denom


def mse(pred, target, mask=None, mask_total=None):
    return _mean((pred - target) ** 2, mask, mask_total)


def rmse(pred, target, mask=None, mask_total=None):
    return torch.sqrt(mse(pred, target, mask, mask_total))


def logloss(prob, label, mask=None, mask_total=None):
    """Negative log-likelihood on probabilities (xgboost eval parity)."""
    p = torch.clamp(prob, _EPS, 1.0 - _EPS)
    nll = -(label * torch.log(p) + (1.0 - label) * torch.log1p(-p))
    return _mean(nll, mask, mask_total)


def sigmoid_binary_cross_entropy(logits, label, mask=None, mask_total=None):
    """Stable BCE from logits: max(x,0) - x*y + log(1+exp(-|x|))."""
    nll = (torch.clamp_min(logits, 0.0) - logits * label
           + torch.log1p(torch.exp(-logits.abs())))
    return _mean(nll, mask, mask_total)


def softmax_cross_entropy(logits, onehot, mask=None, mask_total=None):
    logp = torch.log_softmax(logits, dim=-1)
    return _mean(-(onehot * logp).sum(dim=-1), mask, mask_total)


def error_rate(prob, label, mask=None, threshold: float = 0.5,
               mask_total=None):
    """xgboost ``error``: the fraction misclassified at ``threshold``."""
    wrong = ((prob > threshold).to(torch.float32) != label).to(torch.float32)
    return _mean(wrong, mask, mask_total)


def accuracy(logits, label_ids, mask=None, mask_total=None):
    correct = (logits.argmax(dim=-1) == label_ids).to(torch.float32)
    return _mean(correct, mask, mask_total)

"""Gaussian naive Bayes (the JAX package's ``classic/naive_bayes.py``,
weka ``NaiveBayes`` role).

The fit is two one-hot products over the class axis (counts, per-class
feature moments) on the model's device, with no loop over classes;
predict is a batched log-likelihood argmax. The JSON model dump is the
JAX package's.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.utils.errors import DataError


def _fit(x, y, num_classes: int, var_smoothing: float):
    onehot = torch.nn.functional.one_hot(y, num_classes).to(x.dtype)  # (N, C)
    counts = onehot.sum(0)                                            # (C,)
    safe = torch.clamp_min(counts, 1.0)[:, None]
    mean = (onehot.T @ x) / safe                                      # (C, F)
    sq = (onehot.T @ (x * x)) / safe
    var = torch.clamp_min(sq - mean ** 2, 0.0)
    var = var + var_smoothing * torch.clamp_min(
        x.var(dim=0, correction=0).max(), 1e-12)
    prior = counts / counts.sum()
    return mean, var, torch.log(torch.clamp_min(prior, 1e-12))


def log_likelihood(x, mean, var, log_prior):
    """(N, F) rows → (N, C) joint log-likelihoods: the one program
    ``predict``, ``predict_log_proba`` and serving run."""
    d = x[:, None, :] - mean[None]
    ll = -0.5 * (torch.log(2 * math.pi * var)[None]
                 + d * d / var[None]).sum(-1)
    return ll + log_prior[None]


class GaussianNB:
    kind = "naive_bayes"  # JSON model-dump tag

    def __init__(self, var_smoothing: float = 1e-9, *, device=None):
        self.var_smoothing = var_smoothing
        self.device = resolve_device(device)
        self._params = None

    def fit(self, x, y, num_classes: int | None = None) -> "GaussianNB":
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        y_np = np.asarray(y)
        if num_classes is None:
            num_classes = int(y_np.max()) + 1
        if x.dim() != 2 or len(x) != len(y_np):
            raise DataError(f"bad NB inputs: x{tuple(x.shape)} y{y_np.shape}")
        self.num_classes = num_classes
        y_t = torch.as_tensor(y_np.astype(np.int64), device=self.device)
        self._params = _fit(x, y_t, num_classes, self.var_smoothing)
        return self

    def log_likelihood(self, x: torch.Tensor) -> torch.Tensor:
        if self._params is None:
            raise DataError("fit before predict")
        return log_likelihood(x, *self._params)

    def _ll(self, x) -> torch.Tensor:
        return self.log_likelihood(
            torch.as_tensor(np.asarray(x, np.float32), device=self.device))

    def predict_log_proba(self, x) -> np.ndarray:
        ll = self._ll(x)
        return (ll - torch.logsumexp(ll, -1, keepdim=True)).cpu().numpy()

    def predict(self, x) -> np.ndarray:
        return self._ll(x).argmax(dim=-1).to(torch.int32).cpu().numpy()

    def save_model(self, path: str) -> None:
        """The JAX package's JSON model dump."""
        if self._params is None:
            raise DataError("fit before save_model")
        mean, var, log_prior = (t.cpu().numpy().astype(np.float32)
                                for t in self._params)
        payload = {"kind": self.kind, "num_classes": self.num_classes,
                   "var_smoothing": self.var_smoothing,
                   "mean": mean.tolist(), "var": var.tolist(),
                   "log_prior": log_prior.tolist()}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)

    @classmethod
    def load_model(cls, path: str, device=None) -> "GaussianNB":
        with open(path, encoding="utf-8") as fh:
            return cls.from_payload(json.load(fh), where=path, device=device)

    @classmethod
    def from_payload(cls, payload: dict, where: str = "payload",
                     device=None) -> "GaussianNB":
        if payload.get("kind") != cls.kind:
            raise DataError(
                f"{where}: model kind {payload.get('kind')!r} is not a "
                f"{cls.kind!r} dump")
        m = cls(var_smoothing=float(payload["var_smoothing"]), device=device)
        m.num_classes = int(payload["num_classes"])
        m._params = tuple(
            torch.as_tensor(np.asarray(payload[k], np.float32),
                            device=m.device)
            for k in ("mean", "var", "log_prior"))
        return m

"""Linear classifiers: logistic regression and a linear SVM (the JAX
package's ``classic/linear.py``, weka ``Logistic``/``SMO`` roles).

Training is full-batch gradient descent: the JAX package's ``lax.scan``
of steps is a loop of tensor ops on the model's device (the card unless
``device="cpu"``), a couple of (N, F) products a step and no host sync
inside it. The JSON model dump is the JAX package's, so a model saved by
either package loads in the other.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.utils.errors import DataError


def _descend(x, target, steps: int, lr: float, l2: float, grad_fn):
    """``steps`` full-batch gradient steps of (w, b) from zeros; ``grad_fn(
    scores, target)`` is the loss's gradient with respect to the scores,
    already divided by N."""
    w = torch.zeros((x.shape[1], target.shape[1]), dtype=x.dtype,
                    device=x.device)
    b = torch.zeros((target.shape[1],), dtype=x.dtype, device=x.device)
    xt = x.T
    for _ in range(steps):
        g = grad_fn(x @ w + b, target)
        gw = xt @ g + l2 * w
        w, b = w - lr * gw, b - lr * g.sum(0)
    return w, b


def _fit_logistic(x, y_onehot, steps: int, lr: float, l2: float):
    """Multinomial (softmax) cross-entropy, full-batch gradient descent."""
    n = x.shape[0]
    return _descend(x, y_onehot, steps, lr, l2,
                    lambda s, y: (torch.softmax(s, dim=-1) - y) / n)


def _fit_svm(x, y_pm, steps: int, lr: float, l2: float):
    """One-vs-rest linear SVM by subgradient descent on the hinge loss;
    ``y_pm`` is (N, C) in {-1, +1}."""
    n = x.shape[0]

    def grad(s, y):
        active = (y * s < 1.0).to(x.dtype)       # hinge subgradient mask
        return -(active * y) / n

    return _descend(x, y_pm, steps, lr, l2, grad)


class _LinearBase:
    kind = ""  # JSON model-dump tag, set per subclass

    def __init__(self, steps: int = 500, lr: float = 0.5, l2: float = 1e-4,
                 *, device=None):
        self.steps = steps
        self.lr = lr
        self.l2 = l2
        self.device = resolve_device(device)
        self._wb = None
        self.num_classes = 0

    def _prep(self, x, y, num_classes):
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        y_np = np.asarray(y).astype(np.int32)
        if num_classes is None:
            num_classes = int(y_np.max()) + 1
        if x.dim() != 2 or len(x) != len(y_np):
            raise DataError(f"bad inputs: x{tuple(x.shape)} y{y_np.shape}")
        self.num_classes = num_classes
        onehot = torch.nn.functional.one_hot(
            torch.as_tensor(y_np, dtype=torch.int64, device=self.device),
            num_classes).to(torch.float32)
        return x, onehot

    def scores(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ w + b`` on the device: the one score program
        ``decision_function``, ``predict`` and serving run."""
        if self._wb is None:
            raise DataError("fit before predict")
        w, b = self._wb
        return x @ w + b

    def _device_rows(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def decision_function(self, x) -> np.ndarray:
        return self.scores(self._device_rows(x)).cpu().numpy()

    def predict(self, x) -> np.ndarray:
        ids = self.scores(self._device_rows(x)).argmax(dim=-1)
        return ids.to(torch.int32).cpu().numpy()

    def save_model(self, path: str) -> None:
        """The JAX package's JSON model dump (what ``serve --model-type
        classic`` restores); f32 weights round-trip exactly through their
        JSON repr."""
        if self._wb is None:
            raise DataError("fit before save_model")
        w, b = (t.cpu().numpy().astype(np.float32) for t in self._wb)
        payload = {"kind": self.kind, "num_classes": self.num_classes,
                   "steps": self.steps, "lr": self.lr, "l2": self.l2,
                   "w": w.tolist(), "b": b.tolist()}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)

    @classmethod
    def load_model(cls, path: str, device=None) -> "_LinearBase":
        with open(path, encoding="utf-8") as fh:
            return cls.from_payload(json.load(fh), where=path, device=device)

    @classmethod
    def from_payload(cls, payload: dict, where: str = "payload",
                     device=None) -> "_LinearBase":
        if payload.get("kind") != cls.kind:
            raise DataError(
                f"{where}: model kind {payload.get('kind')!r} is not a "
                f"{cls.kind!r} dump")
        m = cls(steps=int(payload["steps"]), lr=float(payload["lr"]),
                l2=float(payload["l2"]), device=device)
        m.num_classes = int(payload["num_classes"])
        m._wb = tuple(torch.as_tensor(np.asarray(payload[k], np.float32),
                                      device=m.device) for k in ("w", "b"))
        return m


class LogisticRegression(_LinearBase):
    """Multinomial (softmax) logistic regression."""

    kind = "logistic"

    def fit(self, x, y, num_classes: int | None = None
            ) -> "LogisticRegression":
        x, onehot = self._prep(x, y, num_classes)
        self._wb = _fit_logistic(x, onehot, self.steps, self.lr, self.l2)
        return self

    def predict_proba(self, x) -> np.ndarray:
        return torch.softmax(self.scores(self._device_rows(x)),
                             dim=-1).cpu().numpy()


class LinearSVM(_LinearBase):
    """One-vs-rest linear SVM (hinge loss, L2 regularization)."""

    kind = "svm"

    def fit(self, x, y, num_classes: int | None = None) -> "LinearSVM":
        x, onehot = self._prep(x, y, num_classes)
        self._wb = _fit_svm(x, 2.0 * onehot - 1.0, self.steps, self.lr,
                            self.l2)
        return self

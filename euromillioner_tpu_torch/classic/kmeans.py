"""K-means clustering (the JAX package's ``classic/kmeans.py``, weka
``SimpleKMeans`` role).

Lloyd iterations on the model's device: assignment is one (N, K)
distance product, the update two one-hot products; a fixed iteration
count, with no host sync inside the loop (iterations after convergence
change nothing). The initial centres are ``k`` distinct rows drawn from a
``torch.Generator(seed)``: torch cannot reproduce ``jax.random.choice``,
so :meth:`KMeans.fit_from_indices` takes the rows to start from, as a
test feeding the JAX draw does. The JSON model dump is the JAX package's.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.utils.errors import DataError


def _distances(x, x_sq, centers):
    """Squared distances in the expanded form ``x² - 2·x·cᵀ + c²``."""
    return x_sq - 2.0 * (x @ centers.T) + (centers * centers).sum(-1)[None]


def assign_program(x, centers):
    """Each row's nearest centre (int32), in the same expanded form the
    fit uses: the one assignment program ``predict`` and serving run."""
    d = _distances(x, (x * x).sum(-1, keepdim=True), centers)
    return d.argmin(dim=-1).to(torch.int32)


def _fit(x, init_idx, k: int, iters: int):
    centers = x[init_idx]
    x_sq = (x * x).sum(-1, keepdim=True)                 # (N, 1)
    for _ in range(iters):
        labels = _distances(x, x_sq, centers).argmin(dim=-1)
        onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)  # (N, K)
        counts = onehot.sum(0)
        sums = onehot.T @ x
        centers = torch.where(
            counts[:, None] > 0,
            sums / torch.clamp_min(counts, 1.0)[:, None], centers)
    d = _distances(x, x_sq, centers)
    labels = d.argmin(dim=-1)
    inertia = d.gather(1, labels[:, None]).sum()
    return centers, labels, inertia


class KMeans:
    kind = "kmeans"  # JSON model-dump tag (classic.CLASSIC_KINDS)

    def __init__(self, k: int, iters: int = 50, seed: int = 0, *,
                 device=None):
        if k < 1:
            raise DataError(f"k must be >= 1, got {k}")
        self.k = k
        self.iters = iters
        self.seed = seed
        self.device = resolve_device(device)
        self.centers = None          # (k, F) float32 on the device
        self.inertia = None

    def _rows(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def fit(self, x) -> "KMeans":
        """Lloyd's iterations from ``k`` distinct rows drawn with
        ``torch.Generator().manual_seed(seed)``."""
        n = len(x)
        if n < self.k:
            raise DataError(f"need >= k={self.k} rows of 2-D data, got "
                            f"{np.shape(x)}")
        gen = torch.Generator().manual_seed(self.seed)
        return self.fit_from_indices(
            x, torch.randperm(n, generator=gen)[:self.k].numpy())

    def fit_from_indices(self, x, init_idx) -> "KMeans":
        """Lloyd's iterations from the rows ``init_idx`` (k distinct row
        indices) — the draw-free part of :meth:`fit`."""
        x = self._rows(x)
        if x.dim() != 2 or len(x) < self.k:
            raise DataError(f"need >= k={self.k} rows of 2-D data, got "
                            f"{tuple(x.shape)}")
        idx = torch.as_tensor(np.asarray(init_idx, np.int64),
                              device=self.device)
        if tuple(idx.shape) != (self.k,):
            raise DataError(f"need k={self.k} initial indices, got "
                            f"{tuple(idx.shape)}")
        centers, labels, inertia = _fit(x, idx, self.k, self.iters)
        self.centers = centers
        self.labels_ = labels.to(torch.int32).cpu().numpy()
        self.inertia = float(inertia)
        return self

    def predict(self, x) -> np.ndarray:
        """Each row's nearest centre through :func:`assign_program`."""
        if self.centers is None:
            raise DataError("fit before predict")
        return assign_program(self._rows(x), self.centers).cpu().numpy()

    def save_model(self, path: str) -> None:
        """The JAX package's JSON model dump; f32 centres round-trip
        exactly through their JSON repr."""
        if self.centers is None:
            raise DataError("fit before save_model")
        payload = {"kind": self.kind, "k": self.k, "iters": self.iters,
                   "seed": self.seed, "inertia": self.inertia,
                   "centers": self.centers.cpu().numpy().astype(
                       np.float32).tolist()}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)

    @classmethod
    def load_model(cls, path: str, device=None) -> "KMeans":
        with open(path, encoding="utf-8") as fh:
            return cls.from_payload(json.load(fh), where=path, device=device)

    @classmethod
    def from_payload(cls, payload: dict, where: str = "payload",
                     device=None) -> "KMeans":
        if payload.get("kind") != cls.kind:
            raise DataError(
                f"{where}: model kind {payload.get('kind')!r} is not a "
                f"{cls.kind!r} dump")
        m = cls(k=int(payload["k"]), iters=int(payload["iters"]),
                seed=int(payload.get("seed", 0)), device=device)
        centers = np.asarray(payload["centers"], np.float32)
        if centers.ndim != 2 or len(centers) != m.k:
            raise DataError(f"{where}: centers must be (k={m.k}, F), "
                            f"got {centers.shape}")
        m.centers = torch.as_tensor(centers, device=m.device)
        m.inertia = payload.get("inertia")
        return m

"""Dataset and Batch: host-resident (features, labels) with chronological
splitting and fixed-shape batches (the JAX package's ``data/dataset.py``).

A ``Dataset`` plays xgboost's ``DMatrix`` (features + label column) and
DL4J's ``DataSetIterator`` (batched iteration). Batches keep one static
shape: the last partial batch is padded with copies of row 0 under mask 0,
exactly as the JAX package pads, so every training step sees the same
(B, ...) shapes and the padding contributes nothing to the masked loss.
Arrays stay numpy on the host; the trainer stages them onto the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from euromillioner_tpu_torch.utils.errors import DataError


@dataclass
class Batch:
    """One step's input; ``mask`` is 1.0 for real rows, 0.0 for padding."""

    x: np.ndarray
    y: np.ndarray
    mask: np.ndarray


@dataclass
class Dataset:
    x: np.ndarray
    y: np.ndarray
    feature_names: list[str] = field(default_factory=list)

    def __post_init__(self):
        self.x = np.asarray(self.x, dtype=np.float32)
        self.y = np.asarray(self.y, dtype=np.float32)
        if self.x.ndim < 2:
            raise DataError(f"features must be >=2-D, got {self.x.shape}")
        if len(self.x) != len(self.y):
            raise DataError(
                f"feature/label length mismatch: {len(self.x)} vs {len(self.y)}")

    def __len__(self) -> int:
        return len(self.x)

    @property
    def num_features(self) -> int:
        return self.x.shape[-1]

    def full_rows(self) -> np.ndarray:
        """The featurized table with the label re-prepended as column 0
        (day_of_week, month, day, year, 7 balls) — what sequence building
        consumes."""
        return np.concatenate([self.y[:, None], self.x], axis=1)

    @classmethod
    def from_rows(cls, rows, *, label_column: int = 0,
                  feature_names: list[str] | None = None) -> "Dataset":
        """Featurized rows with DMatrix label-column semantics (column
        ``label_column`` is the label, removed from the features)."""
        from euromillioner_tpu_torch.data.csvio import split_label

        try:
            data = np.asarray(rows, dtype=np.float32)
        except ValueError as e:
            raise DataError(f"ragged or non-numeric rows: {e}") from e
        if data.ndim != 2 or data.size == 0:
            raise DataError(f"need a non-empty 2-D row list, got shape {data.shape}")
        x, y, names = split_label(data, list(feature_names or []), label_column)
        return cls(x=x, y=y, feature_names=names)

    @classmethod
    def from_csv(cls, path: str, *, label_column: int = 0) -> "Dataset":
        from euromillioner_tpu_torch.data.csvio import read_csv

        x, y, names = read_csv(path, label_column=label_column)
        return cls(x=x, y=y, feature_names=names)

    def batches(self, batch_size: int, *, shuffle: bool = False,
                seed: int = 0, drop_remainder: bool = False
                ) -> Iterator[Batch]:
        """Fixed-shape batches; the last partial batch is padded with
        copies of row 0 under mask 0 unless ``drop_remainder``.
        ``shuffle`` permutes with ``np.random.default_rng(seed)``."""
        n = len(self)
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        for start in range(0, n, batch_size):
            take = idx[start:start + batch_size]
            if len(take) < batch_size:
                if drop_remainder:
                    return
                pad = np.zeros(batch_size - len(take), dtype=idx.dtype)
                mask = np.concatenate(
                    [np.ones(len(take), np.float32),
                     np.zeros(batch_size - len(take), np.float32)])
                take = np.concatenate([take, pad])
            else:
                mask = np.ones(batch_size, np.float32)
            yield Batch(x=self.x[take], y=self.y[take], mask=mask)

    def subset(self, indices: np.ndarray) -> "Dataset":
        return Dataset(self.x[indices], self.y[indices], list(self.feature_names))


def chronological_split(ds: Dataset, train_percent: int = 70
                        ) -> tuple[Dataset, Dataset]:
    """Unshuffled split: rows before ``int(N * p / 100)`` train, the rest
    validate (truncating, as Java's ``intValue()`` does)."""
    n = len(ds)
    cut = int((train_percent / 100.0) * n)
    if cut == 0 or cut == n:
        raise DataError(
            f"degenerate split: {cut}/{n - cut} rows with train_percent={train_percent}")
    return ds.subset(np.arange(cut)), ds.subset(np.arange(cut, n))

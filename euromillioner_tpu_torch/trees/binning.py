"""Quantile binning: continuous features → small integer bin ids (the JAX
package's ``trees/binning.py``, numpy only; cuts and bins are bit-equal).

Per-feature quantile cut points are computed once on the host, and
features are mapped to int32 bins; split finding then works on a dense
(N, F) integer matrix.
"""

from __future__ import annotations

import numpy as np

from euromillioner_tpu_torch.utils.errors import DataError


def quantile_cuts(x: np.ndarray, max_bins: int = 256) -> list[np.ndarray]:
    """Per-feature cut points from quantiles; at most ``max_bins - 1`` cuts
    (bin ids then fit in [0, max_bins)). Constant features get no cuts."""
    if x.ndim != 2:
        raise DataError(f"binning expects (N, F), got {x.shape}")
    cuts: list[np.ndarray] = []
    for f in range(x.shape[1]):
        col = x[:, f]
        col = col[np.isfinite(col)]
        uniq = np.unique(col)
        if len(uniq) <= 1:
            cuts.append(np.empty(0, np.float32))
            continue
        if len(uniq) <= max_bins:
            # exact: cut between consecutive distinct values
            c = (uniq[:-1] + uniq[1:]) / 2.0
        else:
            qs = np.quantile(col, np.linspace(0, 1, max_bins + 1)[1:-1])
            c = np.unique(qs)
        cuts.append(c.astype(np.float32))
    return cuts


def apply_bins(x: np.ndarray, cuts: list[np.ndarray]) -> np.ndarray:
    """Map features to bin ids via the cut points: bin = #cuts ≤ value.
    NaN/inf goes to bin 0 (xgboost's default-left for missing values)."""
    if x.shape[1] != len(cuts):
        raise DataError(
            f"feature count {x.shape[1]} != cut sets {len(cuts)}")
    out = np.zeros(x.shape, np.int32)
    for f, c in enumerate(cuts):
        if len(c) == 0:
            continue
        col = x[:, f]
        binned = np.searchsorted(c, col, side="right")
        binned[~np.isfinite(col)] = 0
        out[:, f] = binned
    return out


def num_bins(cuts: list[np.ndarray]) -> int:
    """Max bin id + 1 over all features (the histogram's bin axis)."""
    return max((len(c) + 1 for c in cuts), default=1)

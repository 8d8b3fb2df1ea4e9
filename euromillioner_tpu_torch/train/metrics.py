"""Eval metrics registry + xgboost-format watch lines (the JAX package's
``train/metrics.py``): ``[37]\ttrain-rmse:25.123456\ttest-rmse:...``."""

from __future__ import annotations

from typing import Callable, Mapping

from euromillioner_tpu_torch.nn import losses

# name → fn(pred, target, mask); pred is a probability for logloss/error
# and a raw prediction for rmse/mse
METRICS: dict[str, Callable] = {
    "logloss": losses.logloss,
    "rmse": losses.rmse,
    "error": losses.error_rate,
    "mse": losses.mse,
}


def eval_line(round_idx: int, results: Mapping[str, Mapping[str, float]]) -> str:
    """``[round]\t{watch}-{metric}:{value}`` per watch, xgboost layout."""
    parts = [f"[{round_idx}]"]
    for watch_name, metrics in results.items():
        for metric_name, value in metrics.items():
            parts.append(f"{watch_name}-{metric_name}:{value:.6f}")
    return "\t".join(parts)

"""Model registry: config → model (the lstm family is the one ported)."""

from __future__ import annotations

import torch

from euromillioner_tpu_torch.config import ModelConfig
from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.core.precision import dtype_from_name
from euromillioner_tpu_torch.nn.module import Sequential
from euromillioner_tpu_torch.utils.errors import CheckpointError


def build_model(cfg: ModelConfig, *, in_features: int = 11,
                fused: str = "auto", generator: torch.Generator | None = None,
                device=None) -> Sequential:
    if cfg.name != "lstm":
        raise ValueError(f"model {cfg.name!r} is not ported yet (lstm)")
    from euromillioner_tpu_torch.models.lstm import build_lstm

    return build_lstm(hidden=cfg.lstm_hidden, num_layers=cfg.lstm_layers,
                      peepholes=cfg.graves_peepholes, dropout=cfg.dropout,
                      fused=fused, in_features=in_features,
                      generator=generator, device=device)


def default_in_shape(cfg: ModelConfig,
                     num_features: int = 0) -> tuple[int, ...]:
    """Family-standard input shape for rebuilding a trained model: lstm
    consumes ``(seq_len, 11)`` full-row windows."""
    if cfg.name != "lstm":
        raise ValueError(f"model {cfg.name!r} is not ported yet (lstm)")
    return (cfg.seq_len, num_features or 11)


def restore_for_inference(cfg, checkpoint: str, num_features: int = 0,
                          device=None):
    """Rebuild a trained model from a checkpoint directory (either
    package's) for inference: ``(model, compute_dtype, in_shape,
    resolved_ckpt)``. The model is built from ``cfg.model`` on ``device``
    (the card when None), its parameters replaced by the checkpoint's
    ``.params`` leaves cast to ``cfg.model.param_dtype``; names and shapes
    must match exactly."""
    from euromillioner_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                          load_checkpoint)

    dev = resolve_device(device)
    in_shape = default_in_shape(cfg.model, num_features)
    model = build_model(cfg.model, in_features=in_shape[-1],
                        generator=torch.Generator().manual_seed(cfg.train.seed),
                        device=dev)
    ck = latest_checkpoint(checkpoint) or checkpoint
    saved = load_checkpoint(ck)
    want = model.state_dict()
    if set(saved) != set(want):
        raise CheckpointError(
            f"checkpoint params {sorted(set(saved) ^ set(want))} do not "
            f"match the configured model (check model.lstm_hidden / "
            f"lstm_layers / graves_peepholes)")
    for key, t in saved.items():
        if tuple(t.shape) != tuple(want[key].shape):
            raise CheckpointError(
                f"{key}: shape {tuple(t.shape)} != expected "
                f"{tuple(want[key].shape)}")
    model.to(dtype=dtype_from_name(cfg.model.param_dtype))
    model.load_state_dict(saved)  # copies into the params, casting
    return model, dtype_from_name(cfg.model.compute_dtype), in_shape, ck

"""Model registry: config → model (the mlp, lstm and wide_deep
families)."""

from __future__ import annotations

import torch

from euromillioner_tpu_torch.config import ModelConfig
from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.core.precision import dtype_from_name
from euromillioner_tpu_torch.nn.module import Module
from euromillioner_tpu_torch.utils.errors import CheckpointError

PORTED_MODELS = ("mlp", "lstm", "wide_deep")


def build_model(cfg: ModelConfig, *, in_features: int = 11,
                fused: str = "auto", generator: torch.Generator | None = None,
                device=None) -> Module:
    """The model ``cfg.name`` names, over ``in_features`` inputs (the mlp
    and lstm; Wide&Deep reads its 11-column row). Wide&Deep is built as
    the JAX package builds it: sized by ``wide_deep_target_params`` and
    ``embed_dim`` only, with its own default compute dtype (bfloat16)
    whatever ``cfg.compute_dtype`` says."""
    if cfg.name == "mlp":
        from euromillioner_tpu_torch.models.mlp import build_mlp

        return build_mlp(hidden_sizes=tuple(cfg.hidden_sizes), out_dim=1,
                         dropout=cfg.dropout, in_features=in_features,
                         generator=generator, device=device)
    if cfg.name == "lstm":
        from euromillioner_tpu_torch.models.lstm import build_lstm

        return build_lstm(hidden=cfg.lstm_hidden, num_layers=cfg.lstm_layers,
                          peepholes=cfg.graves_peepholes, dropout=cfg.dropout,
                          fused=fused, in_features=in_features,
                          generator=generator, device=device)
    if cfg.name == "wide_deep":
        from euromillioner_tpu_torch.models.wide_deep import build_wide_deep

        kw = {"embed_dim": cfg.embed_dim} if cfg.embed_dim else {}
        return build_wide_deep(target_params=cfg.wide_deep_target_params,
                               generator=generator, device=device, **kw)
    raise ValueError(f"model {cfg.name!r} is not ported yet "
                     f"({' | '.join(PORTED_MODELS)})")


def default_in_shape(cfg: ModelConfig,
                     num_features: int = 0) -> tuple[int, ...]:
    """Family-standard input shape for rebuilding a trained model: lstm
    consumes ``(seq_len, 11)`` full-row windows, wide_deep the full
    11-column featurized row, mlp the 10 label-dropped features.
    ``num_features`` overrides the trailing feature count."""
    if cfg.name == "lstm":
        return (cfg.seq_len, num_features or 11)
    if cfg.name == "wide_deep":
        return (num_features or 11,)
    return (num_features or 10,)


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
    flags = {"mlp": "model.hidden_sizes",
             "lstm": "model.lstm_hidden / lstm_layers / graves_peepholes",
             }.get(cfg.model.name, "model.wide_deep_target_params / embed_dim")
    if set(saved) != set(want):
        raise CheckpointError(
            f"checkpoint params {sorted(set(saved) ^ set(want))} do not "
            f"match the configured model (check {flags})")
    for key, t in saved.items():
        if tuple(t.shape) != tuple(want[key].shape):
            raise CheckpointError(
                f"{key}: shape {tuple(t.shape)} != expected "
                f"{tuple(want[key].shape)} (check {flags})")
    model.to(dtype=dtype_from_name(cfg.model.param_dtype))
    model.load_state_dict(saved)  # copies into the params, casting
    return model, dtype_from_name(cfg.model.compute_dtype), in_shape, ck

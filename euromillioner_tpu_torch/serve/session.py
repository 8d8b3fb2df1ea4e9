"""Row-family serving backends (the JAX package's ``serve/session.py``,
its neural half): :class:`NNBackend` and :func:`load_backend`.

Ported so far: the ``wide_deep`` family at the ``f32`` profile. The JAX
package's tree (``gbt``, ``rf``), ``classic`` and ``mlp`` backends, its
``bf16``/``int8w`` profiles, ``ModelSession`` (executable cache, AOT
store, mesh placement) and the ``serve.quant`` fault point are not ported
yet; asking for them is a :class:`ConfigError` that names them.
"""

from __future__ import annotations

import numpy as np
import torch

from euromillioner_tpu_torch.config import Config, check_ported
from euromillioner_tpu_torch.core.precision import (resolve_serve_precision,
                                                    serve_envelope)
from euromillioner_tpu_torch.utils.errors import ConfigError, ServeError

# row families this port serves, and the JAX package's others
PORTED_ROW_FAMILIES = ("wide_deep",)
_UNPORTED_FAMILIES = ("gbt", "rf", "classic", "mlp")


def _refuse_narrow_profile(profile: str) -> None:
    """The row families' bf16/int8w tiers wait for the port of
    ``WideDeep.quantized_apply``: a ConfigError naming the profile."""
    if profile in ("bf16", "int8w"):
        raise ConfigError(
            f"serve.precision={profile!r} is not ported yet for row "
            f"families; this port serves them at 'f32'")


class NNBackend:
    """Neural checkpoint serving: params on the serving device, forward in
    the model's own arithmetic, outputs in float32.

    * ``apply(x)`` — (rows, *feat) float32 on the device → (rows, out)
      float32 on the device: the engine's program.
    * ``predict(x)`` — host rows → host float32 predictions through the
      same forward: the direct oracle.

    The input is cast to ``compute_dtype`` unless the model reads ids from
    it (``cast_inputs = False``, as Wide&Deep); such a model casts after
    the lookup to its own compute dtype."""

    def __init__(self, model, feat_shape: tuple[int, ...],
                 compute_dtype=None, precision: str = "f32"):
        self.name = f"nn:{type(model).__name__}"
        self.model = model.requires_grad_(False)
        self.family = ("wide_deep" if type(model).__name__ == "WideDeep"
                       else "nn")
        self.device = next(model.parameters()).device
        self.feat_shape = tuple(feat_shape)
        self.out_dtype = np.float32
        self.compute_dtype = compute_dtype or torch.bfloat16
        self.cast_inputs = getattr(model, "cast_inputs", True)
        self.precision = resolve_serve_precision(precision)
        _refuse_narrow_profile(self.precision)
        # no pinned (family, fused) pair: a ConfigError naming the pairs
        self.envelope = serve_envelope(self.family, self.precision)
        if self.family == "wide_deep" and self.device.type == "cuda":
            # build here, on the constructing thread — never lazily on the
            # engine's dispatcher thread
            from euromillioner_tpu_torch.ops.wide_onehot import \
                WIDE_ONEHOT_FWD

            WIDE_ONEHOT_FWD.build()

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if self.cast_inputs:
                x = x.to(self.compute_dtype)
            return self.model.apply(x).to(torch.float32)

    def prepare(self, x) -> np.ndarray:
        return np.asarray(x, np.float32)

    def predict(self, x) -> np.ndarray:
        """Direct single-shot path: (rows, *feat) → (rows, out)."""
        xt = torch.as_tensor(self.prepare(x), device=self.device)
        return self.apply(xt).cpu().numpy().astype(self.out_dtype)


def load_backend(model_type: str, checkpoint: str | None = None,
                 cfg: Config | None = None, num_features: int = 0,
                 device=None) -> NNBackend:
    """A serving backend from a checkpoint directory of either package, on
    ``device`` (the card when None). The family, the profile and the
    scheduler are validated before any restore (ConfigError)."""
    from euromillioner_tpu_torch.models.registry import restore_for_inference

    cfg = cfg or Config()
    profile = resolve_serve_precision(cfg.serve.precision)
    check_ported(cfg)
    if model_type in _UNPORTED_FAMILIES:
        raise ConfigError(
            f"serve --model-type {model_type} is not ported yet; this port "
            f"serves lstm and {' | '.join(PORTED_ROW_FAMILIES)}")
    if model_type == "lstm":
        raise ServeError("lstm is a sequence family: load it with "
                         "serve.continuous.load_recurrent_backend")
    if model_type not in PORTED_ROW_FAMILIES:
        raise ServeError(f"unknown model type {model_type!r}")
    _refuse_narrow_profile(profile)
    if not checkpoint:
        raise ServeError(f"serve --model-type {model_type} needs "
                         "--checkpoint")
    cfg.model.name = model_type
    model, compute_dtype, in_shape, _ck = restore_for_inference(
        cfg, checkpoint, num_features, device)
    return NNBackend(model, in_shape, compute_dtype=compute_dtype,
                     precision=profile)

"""Row-family serving backends (the JAX package's ``serve/session.py``):
:class:`NNBackend`, :class:`GBTBackend`, :class:`RFBackend` and
:func:`load_backend`.

Ported so far: the ``wide_deep`` family at the ``f32`` profile, and the
tree families (``gbt``, ``rf``; f32 only, as in the JAX package) through
whole-ensemble programs. The JAX package's chunked tree dispatch
(``serve.trees.chunk``), its ``classic`` and ``mlp`` backends, the row
families' ``bf16``/``int8w`` profiles, ``ModelSession`` (executable cache,
AOT store, mesh placement) and the ``serve.quant`` fault point are not
ported yet; asking for them is a :class:`ConfigError` that names them.
"""

from __future__ import annotations

import numpy as np
import torch

from euromillioner_tpu_torch.config import Config
from euromillioner_tpu_torch.core.precision import (resolve_serve_precision,
                                                    serve_envelope)
from euromillioner_tpu_torch.utils.errors import ConfigError, ServeError

# row families this port serves, and the JAX package's others
PORTED_ROW_FAMILIES = ("gbt", "rf", "wide_deep")
_UNPORTED_FAMILIES = ("classic", "mlp")
_TREE_FAMILIES = ("gbt", "rf")


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

    def serving_params(self) -> dict:
        """The tensors the engine's program reads (their size is
        /healthz's ``serve_param_mb``)."""
        return self.model.state_dict()

    def predict(self, x) -> np.ndarray:
        """Direct single-shot path: (rows, *feat) → (rows, out)."""
        xt = torch.as_tensor(self.prepare(x), device=self.device)
        return self.apply(xt).cpu().numpy().astype(self.out_dtype)


class _TreeBackend:
    """What the row engine reads of a tree backend: the model's
    ``predict_program`` split — ``prepare`` bins the rows on the host,
    ``apply`` runs the ensemble program on the device — so replies are
    bit-identical to the model's direct ``predict`` by construction. f32
    only: routing and leaf sums have no narrow-dtype profile."""

    precision = "f32"
    envelope = None

    def __init__(self, model, program, out_dtype):
        self.device = model.device
        self.feat_shape = (len(model.cuts),)
        self.out_dtype = out_dtype
        self._params, self._apply, self.prepare = program

    def apply(self, binned: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self._apply(self._params, binned)

    def serving_params(self):
        """The ensemble tensors the program reads."""
        return self._params


class GBTBackend(_TreeBackend):
    """Booster serving via ``Booster.predict_program`` (whole ensemble):
    transformed predictions, or raw margins with ``output_margin``."""

    name = family = "gbt"

    def __init__(self, booster, output_margin: bool = False):
        super().__init__(booster, booster.predict_program(
            len(booster.cuts), output_margin=output_margin), np.float32)
        self.booster = booster
        self._output_margin = output_margin

    def predict(self, x) -> np.ndarray:
        from euromillioner_tpu_torch.trees import DMatrix

        return self.booster.predict(DMatrix(x),
                                    output_margin=self._output_margin)


class RFBackend(_TreeBackend):
    """Random-forest serving via ``RandomForestModel.predict_program``
    (whole forest): int32 majority votes, or f32 means for a regressor."""

    name = family = "rf"

    def __init__(self, model):
        super().__init__(model, model.predict_program(len(model.cuts)),
                         np.int32 if model.classification else np.float32)
        self.model = model

    def predict(self, x) -> np.ndarray:
        return self.model.predict(np.asarray(x, np.float32))


def _load_tree_backend(model_type: str, model_file: str | None, cfg: Config,
                       device) -> _TreeBackend:
    if not model_file:
        raise ServeError(f"serve --model-type {model_type} needs "
                         "--model-file")
    if cfg.serve.trees.chunk > 0:
        raise ConfigError(
            f"serve.trees.chunk={cfg.serve.trees.chunk} (chunked tree "
            f"dispatch) is not ported yet; this port serves whole-ensemble "
            f"programs (serve.trees.chunk=0)")
    if model_type == "gbt":
        from euromillioner_tpu_torch.trees import Booster

        return GBTBackend(Booster.load_model(model_file, device=device))
    from euromillioner_tpu_torch.trees import RandomForestModel

    return RFBackend(RandomForestModel.load_model(model_file, device=device))


def load_backend(model_type: str, checkpoint: str | None = None,
                 cfg: Config | None = None, num_features: int = 0,
                 device=None, *, model_file: str | None = None):
    """A serving backend on ``device`` (the card when None): a tree model
    JSON of either package (``gbt``, ``rf``; ``model_file``) or a
    checkpoint directory of either package (``wide_deep``). The profile
    and the family are validated before any load
    (ConfigError), in the JAX package's order: a tree family at another
    profile than f32 is refused before a missing ``model_file`` is."""
    from euromillioner_tpu_torch.models.registry import restore_for_inference

    cfg = cfg or Config()
    profile = resolve_serve_precision(cfg.serve.precision)
    if profile != "f32" and model_type in (*_TREE_FAMILIES, "classic"):
        raise ConfigError(
            f"serve.precision={profile} needs a neural model family; "
            f"{model_type} serves f32 only")
    if model_type in _TREE_FAMILIES:
        return _load_tree_backend(model_type, model_file, cfg, device)
    if model_type in _UNPORTED_FAMILIES:
        raise ConfigError(
            f"serve --model-type {model_type} is not ported yet; this port "
            f"serves lstm | {' | '.join(PORTED_ROW_FAMILIES)}")
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

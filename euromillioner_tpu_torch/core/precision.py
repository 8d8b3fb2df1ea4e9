"""Mixed precision: the compute policy and the serving profiles.

A :class:`Precision` bundles the param and compute dtypes, as the JAX
package's does: the default keeps f32 params with bf16 compute, and
``PARITY`` is full f32. ``from_names`` maps the config's dtype names to
torch dtypes.

Serving precision profiles (``serve.precision``): the names and pinned envelopes are the JAX package's
(``euromillioner_tpu/core/precision.py``): a profile is servable only when
its (family, profile) max-rel-error envelope against the f32 oracle is
pinned. This port serves ``f32`` and ``fused`` (``config.PORTED_
PRECISIONS``); ``fused`` runs the padded zero-carry programs through the
CUDA sequence kernel (ops/fused_lstm.py) — f32 arithmetic in another
summation order, so it rides the (lstm, fused) envelope, not a bit pin.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from euromillioner_tpu_torch.utils.errors import ConfigError

SERVE_PRECISIONS = ("f32", "bf16", "int8w", "fused")

# Copied from the JAX package as pinned there (measured on CPU XLA; see
# its comments for each measurement). max|got - ref| / max|ref|.
SERVE_ENVELOPES: dict[tuple[str, str], float] = {
    ("nn", "bf16"): 2e-2,
    ("lstm", "bf16"): 8e-2,
    ("wide_deep", "bf16"): 2e-2,
    ("nn", "int8w"): 3e-2,
    ("wide_deep", "int8w"): 3e-2,
    ("lstm", "fused"): 1e-1,
    ("lstm", "int8w"): 2e-1,
    ("rf", "chunked_mean"): 1e-5,
}


def resolve_serve_precision(name) -> str:
    """``serve.precision`` name → validated profile string; unknown names
    are a :class:`ConfigError` (exit 17) listing the valid profiles."""
    prof = str(name).strip().lower()
    if prof not in SERVE_PRECISIONS:
        raise ConfigError(
            f"unknown serve.precision {name!r}; valid profiles are "
            f"{list(SERVE_PRECISIONS)}")
    return prof


def serve_envelope(family: str, profile: str) -> float:
    """The pinned max-rel-error envelope for one (family, profile) pair;
    0.0 for ``f32``. An unpinned pair is a :class:`ConfigError`."""
    if profile == "f32":
        return 0.0
    env = SERVE_ENVELOPES.get((family, profile))
    if env is None:
        raise ConfigError(
            f"no pinned error envelope for the {family!r} family at "
            f"serve.precision={profile!r}; pinned pairs: "
            f"{sorted(SERVE_ENVELOPES)} (f32 serves every family)")
    return env


def dtype_from_name(name: str) -> torch.dtype:
    """``"float32"``/``"bfloat16"``/... → the torch dtype."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ConfigError(f"unknown dtype name {name!r}")
    return dt


@dataclass(frozen=True)
class Precision:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16


DEFAULT_PRECISION = Precision()
PARITY = Precision(compute_dtype=torch.float32)


def from_names(param: str = "float32", compute: str = "bfloat16") -> Precision:
    return Precision(param_dtype=dtype_from_name(param),
                     compute_dtype=dtype_from_name(compute))


def rel_error(got, ref) -> float:
    """max |got - ref| / max |ref| — the envelope measure the JAX package's
    serving surfaces share."""
    got = torch.as_tensor(got, dtype=torch.float64)
    ref = torch.as_tensor(ref, dtype=torch.float64)
    if got.numel() == 0:
        return 0.0
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-9))

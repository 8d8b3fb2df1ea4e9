"""Mixed precision: the compute policy and the serving profiles.

A :class:`Precision` bundles the param and compute dtypes, as the JAX
package's does: the default keeps f32 params with bf16 compute, and
``PARITY`` is full f32. ``from_names`` maps the config's dtype names to
torch dtypes.

Serving precision profiles (``serve.precision``): the names and pinned
envelopes are the JAX package's (``euromillioner_tpu/core/precision.py``):
a profile is servable only when its (family, profile) max-rel-error
envelope against the f32 oracle is pinned. The sequence family serves all
four (serve/continuous.py); the row families serve ``f32``. The profiles'
param transforms are the JAX package's too, on state dicts of tensors:
:func:`cast_floats` (bf16), :func:`quantize_int8w` and
:func:`dequantize_int8w` (int8w), and :func:`fake_quant_int8` (the int8w
tier's ``serve.act_quant``).
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


def cast_floats(params: dict, dtype) -> dict:
    """One-time float-leaf cast of a state dict (the bf16 profile's
    cast at restore); other leaves pass through untouched."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}


# int8w quantized-leaf marker keys: a quantized tensor becomes a dict
# {INT8_Q: int8 values, INT8_SCALE: f32 per-output-channel scales}; the
# ":" cannot collide with a real module or param name
INT8_Q = "int8w:q"
INT8_SCALE = "int8w:scale"


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {INT8_Q, INT8_SCALE}


def quantize_int8w(params: dict, names=None, min_size: int = 512) -> dict:
    """Symmetric per-output-channel weight-only int8 quantization of a
    state dict: ``scale = max|w| over all axes but the last / 127`` and
    ``q = round(w / scale)`` clipped to ±127, bit-equal to the JAX
    package's. ``names`` selects leaves by key component (a leaf
    quantizes when any dot-separated part of its key is named); without
    names, every float leaf with ≥2 dims and ≥ ``min_size`` elements
    quantizes — biases, peepholes and scalars stay exact."""
    wanted = set(names) if names is not None else None

    def leaf(key, a):
        if (is_quantized(a) or not a.is_floating_point() or a.dim() < 2
                or (wanted is not None
                    and not wanted.intersection(key.split(".")))
                or (wanted is None and a.numel() < min_size)):
            return a
        scale = torch.clamp_min(a.abs().amax(dim=tuple(range(a.dim() - 1))),
                                1e-12) / 127.0
        q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
        return {INT8_Q: q, INT8_SCALE: scale.to(torch.float32)}

    return {k: leaf(k, v) for k, v in params.items()}


def dequantize_leaf(leaf, dtype=torch.float32):
    """One leaf back to a dense tensor: a quantized marker dict
    dequantizes (f32 multiply, then cast), a float tensor casts, any
    other passes through."""
    if is_quantized(leaf):
        return (leaf[INT8_Q].to(torch.float32)
                * leaf[INT8_SCALE]).to(dtype)
    if leaf.is_floating_point():
        return leaf.to(dtype)
    return leaf


def dequantize_int8w(params: dict, dtype=torch.float32) -> dict:
    """The whole state dict dense again, at each serving call: what stays
    resident is int8 and the scales."""
    return {k: dequantize_leaf(v, dtype) for k, v in params.items()}


def fake_quant_int8(x: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 fake-quantization of an activation: round
    to the 255-level grid spanned by ``max|x|`` and come back to the
    input dtype (the int8w tier's ``serve.act_quant``); bit-equal to the
    JAX package's."""
    scale = torch.clamp_min(x.abs().amax(), 1e-12) / 127.0
    return (torch.clamp(torch.round(x / scale), -127, 127)
            * scale).to(x.dtype)


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

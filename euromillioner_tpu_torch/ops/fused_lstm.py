"""Fused LSTM sequence kernel: the whole forward time loop in one launch.

The CUDA kernel (``csrc/fused_lstm.cu``, its note gives the design and the
bound) replaces the JAX package's Pallas TPU kernel
``euromillioner_tpu/ops/fused_lstm.py:88 _fwd_kernel``: a peephole LSTM
over ``x_proj`` (T, B, 4H) from a zero carry, with the recurrent product
inside the kernel. Serving runs it forward-only; the backward kernel comes
with training.

The device rule: for a CPU tensor the wrappers take the plain version,
:func:`lstm_sequence_reference`; for a CUDA tensor they launch the kernel
or raise — no fallback. Only float32 is served (the ``fused`` profile
serves f32); any other dtype on CUDA raises.
"""

from __future__ import annotations

import ctypes

import torch

from euromillioner_tpu_torch.nn.recurrent import lstm_cell
from euromillioner_tpu_torch.ops.common import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int

# the kernel's C entry point and launch counter (``FUSED_LSTM_FWD.launches``)
FUSED_LSTM_FWD = CudaKernel(
    "fused_lstm.cu", "emt_lstm_fwd_f32",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])

# shared memory per CTA is 3 * 8 rows * H floats; the kernel's cap
MAX_HIDDEN = 232448 // (3 * 8 * 4)


def lstm_sequence_reference(x_proj, wh, peep, peepholes: bool = True):
    """The plain version: a Python loop of the cell step over ``x_proj``
    (T, B, 4H) from a zero carry. Returns ``(hs, cs, gates)`` — (T, B, H),
    (T, B, H) and the activated gates [i, f, g, o] (T, B, 4H) — in
    ``x_proj``'s dtype, as the JAX package's ``_fwd`` does."""
    t, b, four_h = x_proj.shape
    h = four_h // 4
    dt = x_proj.dtype
    p = (peep[0].to(dt), peep[1].to(dt), peep[2].to(dt)) if peepholes else None
    h_prev = torch.zeros((b, h), dtype=dt, device=x_proj.device)
    c_prev = torch.zeros_like(h_prev)
    hs, cs, gates = [], [], []
    for k in range(t):
        h_prev, c_prev, act = lstm_cell(x_proj[k], h_prev, c_prev,
                                        wh.to(dt), p)
        hs.append(h_prev)
        cs.append(c_prev)
        gates.append(torch.cat(act, dim=-1))
    return torch.stack(hs), torch.stack(cs), torch.stack(gates)


def _check(x_proj, wh, peep) -> tuple[int, int, int]:
    if x_proj.dim() != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"x_proj must be (T, B, 4H), got {tuple(x_proj.shape)}")
    t, b, four_h = x_proj.shape
    h = four_h // 4
    if tuple(wh.shape) != (h, four_h):
        raise ValueError(f"wh must be ({h}, {four_h}), got {tuple(wh.shape)}")
    if tuple(peep.shape) != (4, h):
        raise ValueError(f"peep must be (4, {h}), got {tuple(peep.shape)}")
    return t, b, h


def _fwd(x_proj, wh, peep, peepholes: bool, residuals: bool):
    """Run the forward kernel; ``residuals`` also writes cs and gates.
    Returns ``(hs, cs, gates)`` with None for residuals not asked for."""
    t, b, h = _check(x_proj, wh, peep)
    if x_proj.device.type == "cpu":
        hs, cs, gates = lstm_sequence_reference(x_proj, wh, peep, peepholes)
        return (hs, cs, gates) if residuals else (hs, None, None)
    if x_proj.device.type != "cuda":
        raise ValueError(f"unsupported device {x_proj.device}")
    for name, a in (("x_proj", x_proj), ("wh", wh), ("peep", peep)):
        if a.dtype != torch.float32:
            raise TypeError(f"the fused LSTM kernel is f32 only; {name} is "
                            f"{a.dtype}")
        if a.device != x_proj.device:
            raise ValueError(f"{name} is on {a.device}, x_proj on "
                             f"{x_proj.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h > MAX_HIDDEN:
        raise ValueError(f"hidden {h} exceeds the kernel's shared-memory "
                         f"cap {MAX_HIDDEN}")
    hs = torch.empty((t, b, h), dtype=torch.float32, device=x_proj.device)
    cs = gates = None
    if residuals:
        cs = torch.empty_like(hs)
        gates = torch.empty_like(x_proj)
    if t and b:
        FUSED_LSTM_FWD.launch(
            x_proj.data_ptr(), wh.data_ptr(), peep.data_ptr(), hs.data_ptr(),
            cs.data_ptr() if residuals else None,
            gates.data_ptr() if residuals else None,
            t, b, h, int(bool(peepholes)), x_proj.device.index)
    return hs, cs, gates


def lstm_sequence(x_proj, wh, peep, peepholes: bool = True):
    """Run the LSTM recurrence over ``x_proj`` (T, B, 4H), with
    ``x_proj = x @ wx + bias`` precomputed. ``wh``: (H, 4H); ``peep``:
    (4, H) f32, rows i, f, o and one zero row (zeros when ``peepholes`` is
    False). Returns hs (T, B, H); the residual writes are skipped."""
    return _fwd(x_proj, wh, peep, peepholes, residuals=False)[0]


def lstm_forward(x_proj, wh, peep, peepholes: bool = True):
    """As :func:`lstm_sequence`, returning ``(hs, cs, gates)`` — the
    residuals the backward pass keeps (the JAX package's ``_fwd``)."""
    return _fwd(x_proj, wh, peep, peepholes, residuals=True)

"""Fused LSTM sequence kernels: the whole time loop in one launch each way.

Two CUDA kernels replace the JAX package's Pallas TPU pair in
``euromillioner_tpu/ops/fused_lstm.py`` (each source's note gives its
design and bound):

* K1, ``csrc/fused_lstm.cu`` (``_fwd_kernel``, :88): a peephole LSTM over
  ``x_proj`` (T, B, 4H) from a zero carry, with the recurrent product
  inside the kernel; serving runs it forward-only, training also writes
  the residuals (cs and the activated gates).
* K2, ``csrc/fused_lstm_bwd.cu`` (``_bwd_kernel``, :175): the reverse-time
  backward from those residuals — dxp, dwh and dpeep, all computed by
  hand-written code.

:class:`LSTMSequence` joins them as one ``torch.autograd.Function``, as
``jax.custom_vjp`` joins the Pallas pair.

The device rule: for a CPU tensor the wrappers take the plain versions,
:func:`lstm_sequence_reference` and :func:`lstm_backward_reference`; for a
CUDA tensor they launch the kernel or raise — no fallback.

The dtype contract is the Pallas pair's: x_proj, wh and the residuals
share one dtype, float32 or bfloat16; peep is always float32; the (h, c)
carry, the accumulation, dwh's sum and dpeep are float32; dxp comes back
in the residuals' dtype and dwh in wh's. Each dtype has its own C entry
point and launch counter (``FUSED_LSTM_FWD`` / ``FUSED_LSTM_FWD_BF16``,
``FUSED_LSTM_BWD`` / ``FUSED_LSTM_BWD_BF16``), so a run can show which
instantiation its path launched. Any other dtype on CUDA raises.
"""

from __future__ import annotations

import ctypes

import torch

from euromillioner_tpu_torch.nn.recurrent import lstm_cell
from euromillioner_tpu_torch.ops.common import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int

# K1's entry points and launch counters (``FUSED_LSTM_FWD.launches``): 6
# pointers, T, B, H, peepholes, device, stream
_FWD_ARGS = [_P] * 6 + [_I] * 5 + [_P]
FUSED_LSTM_FWD = CudaKernel("fused_lstm.cu", "emt_lstm_fwd_f32", _FWD_ARGS)
FUSED_LSTM_FWD_BF16 = CudaKernel("fused_lstm.cu", "emt_lstm_fwd_bf16",
                                 _FWD_ARGS)

# K2's: 11 pointers (inputs, outputs, two scratch buffers), T, B, H,
# peepholes, device, stream
_BWD_ARGS = [_P] * 11 + [_I] * 5 + [_P]
FUSED_LSTM_BWD = CudaKernel("fused_lstm_bwd.cu", "emt_lstm_bwd_f32",
                            _BWD_ARGS)
FUSED_LSTM_BWD_BF16 = CudaKernel("fused_lstm_bwd.cu", "emt_lstm_bwd_bf16",
                                 _BWD_ARGS)

# the instantiation each compute dtype launches
_FWD_KERNELS = {torch.float32: FUSED_LSTM_FWD,
                torch.bfloat16: FUSED_LSTM_FWD_BF16}
_BWD_KERNELS = {torch.float32: FUSED_LSTM_BWD,
                torch.bfloat16: FUSED_LSTM_BWD_BF16}

# shared memory per CTA, in floats whatever the dtype: K1 keeps 3 * 8
# rows * H; K2 keeps (6 * 8 rows + 3) * H (dgates, the two carries, the
# dpeep sums)
MAX_HIDDEN = 232448 // (3 * 8 * 4)
MAX_HIDDEN_BWD = 232448 // ((6 * 8 + 3) * 4)
_ROWS = 8  # batch rows per CTA, both kernels


def kernel_refusal(dtype, hidden: int) -> str | None:
    """Why K1 and K2 together cannot run an LSTM layer of this compute
    dtype and hidden width on the card, with what to change; None when
    they can."""
    if dtype not in _FWD_KERNELS:
        return (f"the CUDA LSTM kernels take float32 or bfloat16, not "
                f"{dtype}: set model.compute_dtype to one of them, or build "
                f"the layer with fused='off' to scan")
    cap = min(MAX_HIDDEN, MAX_HIDDEN_BWD)
    if hidden > cap:
        return (f"hidden {hidden} exceeds the CUDA LSTM kernels' "
                f"shared-memory cap of {cap}: use a narrower layer, or "
                f"build it with fused='off' to scan")
    return None


def lstm_sequence_reference(x_proj, wh, peep, peepholes: bool = True):
    """The plain version: a Python loop of the cell step over ``x_proj``
    (T, B, 4H) from a zero carry, with the kernels' arithmetic in either
    dtype (the JAX package's ``_fwd_kernel``): the (h, c) carry in f32,
    ``x_proj[t]`` read up to f32, h rounded to wh's dtype as the operand
    of the recurrent product, which sums in f32, and f32 peepholes.
    Returns ``(hs, cs, gates)`` — (T, B, H), (T, B, H) and the activated
    gates [i, f, g, o] (T, B, 4H) — rounded to ``x_proj``'s dtype. In f32
    every cast is a no-op and this is the scan's step."""
    t, b, four_h = x_proj.shape
    h = four_h // 4
    dt, f32 = x_proj.dtype, torch.float32
    p = peep.to(f32)
    p = (p[0], p[1], p[2]) if peepholes else None
    wh_f = wh.to(f32)
    h_prev = torch.zeros((b, h), dtype=f32, device=x_proj.device)
    c_prev = torch.zeros_like(h_prev)
    hs, cs, gates = [], [], []
    for k in range(t):
        # bf16 operands are exact in f32, so the f32 product of the
        # rounded h and wh is the kernels' bf16 product with f32 sums
        h_prev, c_prev, act = lstm_cell(x_proj[k].to(f32),
                                        h_prev.to(wh.dtype).to(f32), c_prev,
                                        wh_f, p)
        hs.append(h_prev.to(dt))
        cs.append(c_prev.to(dt))
        gates.append(torch.cat(act, dim=-1).to(dt))
    return torch.stack(hs), torch.stack(cs), torch.stack(gates)


def lstm_backward_reference(wh, peep, residuals, g_hs,
                            peepholes: bool = True):
    """The plain version of the backward, written out step by step as the
    JAX package's ``_bwd`` is: walk time in reverse from zero dh/dc
    carries, form the gate gradients from the residuals ``(hs, cs,
    gates)``, carry ``dh = dgates . wh^T``, sum the peephole gradients,
    then ``dwh = sum_t h_prev^T . dgates`` as one product. Returns
    ``(dxp, dwh, dpeep)``: dxp (T, B, 4H) in hs's dtype, dwh and dpeep
    accumulated in f32 and cast to wh's and peep's dtypes."""
    hs, cs, gates = residuals
    t, b, h = hs.shape
    f32 = torch.float32
    dev = hs.device
    p = peep.to(f32)
    wh_f = wh.to(f32)
    dh_carry = torch.zeros((b, h), dtype=f32, device=dev)
    dc_carry = torch.zeros_like(dh_carry)
    dpeep = torch.zeros((4, h), dtype=f32, device=dev)
    dxp = torch.empty((t, b, 4 * h), dtype=hs.dtype, device=dev)
    for k in reversed(range(t)):
        i, f, g, o = gates[k].to(f32).split(h, dim=-1)
        c = cs[k].to(f32)
        c_prev = cs[k - 1].to(f32) if k else torch.zeros_like(c)
        tanh_c = torch.tanh(c)
        dh = g_hs[k].to(f32) + dh_carry
        do_pre = dh * tanh_c * o * (1.0 - o)
        dc = dh * o * (1.0 - tanh_c * tanh_c) + dc_carry
        if peepholes:
            dc = dc + do_pre * p[2]
        di_pre = dc * g * i * (1.0 - i)
        df_pre = dc * c_prev * f * (1.0 - f)
        dg_pre = dc * i * (1.0 - g * g)
        dc_prev = dc * f
        if peepholes:
            dc_prev = dc_prev + di_pre * p[0] + df_pre * p[1]
            dpeep[0] += (di_pre * c_prev).sum(dim=0)
            dpeep[1] += (df_pre * c_prev).sum(dim=0)
            dpeep[2] += (do_pre * c).sum(dim=0)
        dgates = torch.cat([di_pre, df_pre, dg_pre, do_pre], dim=-1)
        dxp[k] = dgates.to(dxp.dtype)
        # operands rounded to wh's dtype, f32 accumulation
        dh_carry = dgates.to(wh.dtype).to(f32) @ wh_f.T
        dc_carry = dc_prev
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
    dwh = h_prev.reshape(t * b, h).to(f32).T @ dxp.reshape(t * b, 4 * h).to(f32)
    return dxp, dwh.to(wh.dtype), dpeep.to(peep.dtype)


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


def _check_cuda(device, named) -> torch.dtype:
    """The kernels' contract for CUDA tensors: ``named`` is ``(name,
    tensor)`` pairs, the first setting the compute dtype (float32 or
    bfloat16) that every other tensor shares except ``peep``, which is
    float32; all on one device, dense. Raises; never casts. Returns the
    compute dtype."""
    dtype = named[0][1].dtype
    if dtype not in _FWD_KERNELS:
        raise TypeError(f"the fused LSTM kernels take float32 or bfloat16; "
                        f"{named[0][0]} is {dtype}")
    for name, a in named:
        want = torch.float32 if name == "peep" else dtype
        if a.dtype != want:
            raise TypeError(f"{name} is {a.dtype}; the fused LSTM kernels "
                            f"take it as {want} with {named[0][0]} in "
                            f"{dtype}")
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, expected {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dtype


def _fwd(x_proj, wh, peep, peepholes: bool, residuals: bool):
    """Run the forward kernel; ``residuals`` also writes cs and gates.
    Returns ``(hs, cs, gates)`` with None for residuals not asked for."""
    t, b, h = _check(x_proj, wh, peep)
    if x_proj.device.type == "cpu":
        hs, cs, gates = lstm_sequence_reference(x_proj, wh, peep, peepholes)
        return (hs, cs, gates) if residuals else (hs, None, None)
    if x_proj.device.type != "cuda":
        raise ValueError(f"unsupported device {x_proj.device}")
    dtype = _check_cuda(x_proj.device,
                        (("x_proj", x_proj), ("wh", wh), ("peep", peep)))
    if h > MAX_HIDDEN:
        raise ValueError(f"hidden {h} exceeds the kernel's shared-memory "
                         f"cap {MAX_HIDDEN}")
    hs = torch.empty((t, b, h), dtype=dtype, device=x_proj.device)
    cs = gates = None
    if residuals:
        cs = torch.empty_like(hs)
        gates = torch.empty_like(x_proj)
    if t and b:
        _FWD_KERNELS[dtype].launch(
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


def lstm_backward(wh, peep, residuals, g_hs, peepholes: bool = True):
    """The backward of :func:`lstm_forward`: ``(dxp, dwh, dpeep)`` from its
    residuals ``(hs, cs, gates)`` and the gradient ``g_hs`` (T, B, H) of
    its hs (the JAX package's ``_bwd``). dxp (T, B, 4H), dwh (H, 4H) and
    dpeep (4, H, row 3 zero) come back in the dtypes of hs, wh and peep."""
    hs, cs, gates = residuals
    t, b, h = _check(gates, wh, peep)
    for name, a in (("hs", hs), ("cs", cs), ("g_hs", g_hs)):
        if tuple(a.shape) != (t, b, h):
            raise ValueError(f"{name} must be ({t}, {b}, {h}), got "
                             f"{tuple(a.shape)}")
    if gates.device.type == "cpu":
        return lstm_backward_reference(wh, peep, residuals, g_hs, peepholes)
    if gates.device.type != "cuda":
        raise ValueError(f"unsupported device {gates.device}")
    dtype = _check_cuda(gates.device, (("gates", gates), ("g_hs", g_hs),
                                       ("hs", hs), ("cs", cs), ("wh", wh),
                                       ("peep", peep)))
    if h > MAX_HIDDEN_BWD:
        raise ValueError(f"hidden {h} exceeds the backward kernel's "
                         f"shared-memory cap {MAX_HIDDEN_BWD}")
    dxp = torch.empty_like(gates)
    dwh = torch.empty_like(wh)
    dpeep = torch.empty_like(peep)
    if not (t and b):
        return dxp, dwh.zero_(), dpeep.zero_()
    wh_t = torch.empty((4 * h, h), dtype=dtype, device=gates.device)
    partials = torch.empty((-(-b // _ROWS), 3, h), dtype=torch.float32,
                           device=gates.device)
    _BWD_KERNELS[dtype].launch(
        g_hs.data_ptr(), hs.data_ptr(), cs.data_ptr(), gates.data_ptr(),
        wh.data_ptr(), peep.data_ptr(), dxp.data_ptr(), dwh.data_ptr(),
        dpeep.data_ptr(), wh_t.data_ptr(), partials.data_ptr(),
        t, b, h, int(bool(peepholes)), gates.device.index)
    return dxp, dwh, dpeep


class LSTMSequence(torch.autograd.Function):
    """K1 and K2 as one differentiable op (the JAX package's
    ``jax.custom_vjp`` of ``lstm_sequence``): ``apply(x_proj, wh, peep,
    peepholes) -> hs``. Forward runs K1 with residuals and saves them;
    backward runs K2. On CPU tensors both are the plain versions."""

    @staticmethod
    def forward(ctx, x_proj, wh, peep, peepholes):
        hs, cs, gates = lstm_forward(x_proj, wh, peep, peepholes)
        ctx.save_for_backward(hs, cs, gates, wh, peep)
        ctx.peepholes = peepholes
        return hs

    @staticmethod
    def backward(ctx, g_hs):
        hs, cs, gates, wh, peep = ctx.saved_tensors
        dxp, dwh, dpeep = lstm_backward(wh, peep, (hs, cs, gates),
                                        g_hs.contiguous(), ctx.peepholes)
        return dxp, dwh.to(wh.dtype), dpeep.to(peep.dtype), None

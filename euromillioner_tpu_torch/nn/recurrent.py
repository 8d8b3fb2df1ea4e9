"""Peephole (GravesLSTM-style) LSTM.

The JAX package's ``nn/recurrent.py`` in PyTorch: the same leaf names,
shapes and gate order — ``wx (F, 4H)``, ``wh (H, 4H)``, ``bias (4H)`` with
the forget bias in ``[H:2H]``, peepholes ``p_i``/``p_f``/``p_o`` (i and f
see c_prev, o sees the new c), gates ordered i, f, g, o. The input
projection for all timesteps is hoisted into one ``(T·B, F) @ (F, 4H)``
product; the recurrence is either a Python loop of :meth:`LSTMCell.step`
(the scan, the f32 oracle) or the sequence kernels of ops/fused_lstm.py
(zero initial carry only): ``LSTM.apply`` under ``fused`` (the K1+K2
autograd Function, for training and evaluation) and
:meth:`LSTM.fused_sequence` (K1 alone, for the serving ``fused`` tier).
"""

from __future__ import annotations

import torch

from euromillioner_tpu_torch.nn import initializers as init
from euromillioner_tpu_torch.nn.module import Module
from euromillioner_tpu_torch.utils.errors import ConfigError

FUSED_MODES = ("auto", "on", "off")


def lstm_cell(x_proj: torch.Tensor, h_prev: torch.Tensor,
              c_prev: torch.Tensor, wh: torch.Tensor, peep=None):
    """One peephole-LSTM step: ``(h, c, (i, f, g, o))`` from the
    precomputed ``x_proj = x @ wx + bias`` (B, 4H). ``peep`` is
    ``(p_i, p_f, p_o)`` or None for a vanilla LSTM. THE step math: the
    layer's scan and the fused kernel's plain version both run it."""
    hdim = wh.shape[0]
    gates = x_proj + h_prev @ wh
    i, f, g, o = gates.split(hdim, dim=-1)
    if peep is not None:
        i = i + c_prev * peep[0]
        f = f + c_prev * peep[1]
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    g = torch.tanh(g)
    c = f * c_prev + i * g
    if peep is not None:
        o = o + c * peep[2]
    o = torch.sigmoid(o)
    h = o * torch.tanh(c)
    return h, c, (i, f, g, o)


class LSTMCell(Module):
    """Single-step LSTM cell holding the layer's parameters."""

    def __init__(self, in_features: int, hidden: int, peepholes: bool = True,
                 forget_bias: float = 1.0, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        h = hidden
        self.hidden = hidden
        self.peepholes = peepholes
        self.forget_bias = forget_bias  # DL4J forgetGateBiasInit default 1.0
        bias = torch.zeros(4 * h, device=device)
        bias[h:2 * h] = forget_bias
        P = torch.nn.Parameter
        self.wx = P(init.glorot_uniform((in_features, 4 * h), generator,
                                        device))
        self.wh = P(init.orthogonal((h, 4 * h), generator, device))
        self.bias = P(bias)
        if peepholes:
            gauss = init.normal(0.01)
            self.p_i = P(gauss((h,), generator, device))
            self.p_f = P(gauss((h,), generator, device))
            self.p_o = P(gauss((h,), generator, device))

    def peep_vectors(self, dtype):
        """``(p_i, p_f, p_o)`` in ``dtype``, or None without peepholes."""
        if not self.peepholes:
            return None
        return (self.p_i.to(dtype), self.p_f.to(dtype), self.p_o.to(dtype))

    def step(self, carry, x_proj):
        """One timestep: ``((h, c), x_proj (B, 4H)) → ((h, c), h)``."""
        h_prev, c_prev = carry
        h, c, _ = lstm_cell(x_proj, h_prev, c_prev,
                            self.wh.to(x_proj.dtype),
                            self.peep_vectors(x_proj.dtype))
        return (h, c), h

    def apply(self, x, *, train=False, generator=None):
        """Single-step apply: x is (carry, x_t) → (carry, h)."""
        carry, x_t = x
        x_proj = x_t @ self.wx.to(x_t.dtype) + self.bias.to(x_t.dtype)
        return self.step(carry, x_proj)


class LSTM(LSTMCell):
    """LSTM over a sequence: ``[B, T, F] → [B, T, H]`` (return_sequences)
    or ``[B, H]`` (last step). The parameters are the cell's, so the
    ``state_dict`` keys sit directly under the layer (``0_LSTM.wx``) as in
    the JAX package's params tree.

    ``fused`` picks how :meth:`apply` runs the recurrence, as in the JAX
    package: ``"auto"`` runs the K1+K2 Function on a CUDA tensor and the
    scan on a CPU tensor; ``"on"`` always runs the Function — its plain
    versions on a CPU tensor, as the JAX package runs interpret mode;
    ``"off"`` always scans. On the card, ``auto`` and ``on`` both raise a
    :class:`ConfigError` where the kernels cannot run the layer (a compute
    dtype other than float32 or bfloat16, a hidden width above their
    shared-memory cap) rather than fall back to the scan."""

    def __init__(self, in_features: int, hidden: int,
                 return_sequences: bool = True, peepholes: bool = True,
                 forget_bias: float = 1.0, fused: str = "auto", *,
                 generator: torch.Generator, device=None):
        super().__init__(in_features, hidden, peepholes=peepholes,
                         forget_bias=forget_bias, generator=generator,
                         device=device)
        if fused not in FUSED_MODES:
            raise ValueError(f"fused must be auto|on|off, got {fused!r}")
        self.return_sequences = return_sequences
        self.fused = fused

    def _use_fused(self, x) -> bool:
        """Whether :meth:`apply` runs the K1+K2 Function. On a CUDA tensor
        the kernels run, or this raises a :class:`ConfigError` naming why
        they cannot — under ``auto`` as under ``on``: only ``off`` scans
        on the card."""
        if self.fused == "off":
            return False
        if x.device.type != "cuda":
            return self.fused == "on"
        from euromillioner_tpu_torch.ops.fused_lstm import kernel_refusal

        why = kernel_refusal(x.dtype, self.hidden)
        if why:
            raise ConfigError(f"LSTM(hidden={self.hidden}, fused="
                              f"{self.fused!r}) on {x.device}: {why}")
        return True

    def initial_state(self, batch: int, dtype=torch.float32):
        """Zero (h, c) carry for a batch, on the layer's device."""
        z = torch.zeros((batch, self.hidden), dtype=dtype,
                        device=self.wh.device)
        return z, z.clone()

    def step_apply(self, carry, x_t):
        """One timestep: ``((h, c), [B, F]) → ((h, c), [B, H])`` — this
        step's input projection, then the cell math the scan body runs
        (:meth:`LSTMCell.apply`)."""
        return LSTMCell.apply(self, (carry, x_t))

    def scan_with_state(self, x, carry, unroll=None):
        """Run the sequence from an explicit (h, c) carry:
        ``([B, T, F], (h0, c0)) → ((hT, cT), [B, T, H])`` — the stateful
        half of truncated BPTT (train/tbptt.py), always on the scan: the
        fused kernels start from a zero carry. ``unroll`` is the JAX
        package's scan-unroll knob, accepted and ignored (a Python loop
        has no loop lowering to tune)."""
        del unroll
        x_proj = self._input_proj(x)
        carry_out, hs = self._scan(x_proj, carry)
        return carry_out, hs.transpose(0, 1)

    def fused_sequence(self, x):
        """Zero-carry whole-sequence apply through the fused sequence
        kernel (ops/fused_lstm.py): ``[B, T, F] → [B, T, H]`` in ``x``'s
        dtype. On a CUDA tensor the CUDA kernel runs (float32 or bfloat16;
        anything else raises); on a CPU tensor its plain version does."""
        return self._fused_hs(self._input_proj(x)).transpose(0, 1)

    def _fused_hs(self, x_proj):
        """The sequence kernels over ``x_proj`` [T, B, 4H] → hs [T, B, H]:
        the K1+K2 Function when there is something to differentiate, else
        K1 alone without its residual writes. wh runs in x_proj's dtype,
        the peepholes in f32 (the JAX package's ``LSTM.apply``)."""
        from euromillioner_tpu_torch.ops.fused_lstm import (LSTMSequence,
                                                            lstm_sequence_op)

        wh = self.wh.to(x_proj.dtype).contiguous()
        peep = self._peep_rows()
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x_proj, wh, peep)):
            return LSTMSequence.apply(x_proj, wh, peep, self.peepholes)
        return lstm_sequence_op(x_proj, wh, peep, self.peepholes)

    def _peep_rows(self):
        """The kernels' (4, H) f32 peephole operand: rows i, f, o and a
        zero row (all zeros without peepholes)."""
        f32 = torch.float32
        if self.peepholes:
            return torch.stack([self.p_i, self.p_f, self.p_o,
                                torch.zeros_like(self.p_i)]).to(f32)
        return torch.zeros((4, self.hidden), dtype=f32,
                           device=self.wh.device)

    def _input_proj(self, x):
        """Hoisted input projection, time-major: ``[B, T, F] → [T, B, 4H]``
        (transposing the narrow input first leaves the product
        contiguous)."""
        b, t, f = x.shape
        xt = x.transpose(0, 1).reshape(t * b, f)
        x_proj = xt @ self.wx.to(x.dtype) + self.bias.to(x.dtype)
        return x_proj.reshape(t, b, 4 * self.hidden)

    def _scan(self, x_proj, carry):
        hs = []
        for t in range(x_proj.shape[0]):
            carry, h = self.step(carry, x_proj[t])
            hs.append(h)
        return carry, torch.stack(hs)

    def apply(self, x, *, train=False, generator=None):
        b = x.shape[0]
        x_proj = self._input_proj(x)
        if self._use_fused(x):
            hs = self._fused_hs(x_proj)
            if self.return_sequences:
                return hs.transpose(0, 1)
            return hs[-1]
        (h_last, _), hs = self._scan(x_proj, self.initial_state(b, x.dtype))
        if self.return_sequences:
            return hs.transpose(0, 1)  # back to [B, T, H]
        return h_last

    @property
    def name(self) -> str:
        return "LSTM"

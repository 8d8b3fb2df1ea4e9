"""GravesLSTM-equivalent sequence model over draw-date time series (the
JAX package's ``models/lstm.py``): stacked peephole LSTMs, last-step
readout, dense head. Sliding windows of past draws' 11-feature rows
predict the next draw's 7 ball numbers. ``build_tbptt_lstm`` is the
variant truncated BPTT trains over the whole history (a prediction at
every step), and ``step_apply`` runs one timestep through the stack.
"""

from __future__ import annotations

import numpy as np
import torch

from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.nn import LSTM, Dense, Dropout, Sequential


def build_lstm(
    hidden: int = 512,
    num_layers: int = 2,
    out_dim: int = 7,
    peepholes: bool = True,
    dropout: float = 0.0,
    head_activation: str = "identity",
    fused: str = "auto",
    *,
    in_features: int = 11,
    generator: torch.Generator | None = None,
    device=None,
) -> Sequential:
    """The stacked model with weights drawn from ``generator`` (seed 0
    when None) on ``device`` (the card when None). ``fused`` is each LSTM
    layer's auto | on | off (nn/recurrent.LSTM)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    layers = []
    width = in_features
    for i in range(num_layers):
        last = i == num_layers - 1
        layers.append(LSTM(width, hidden, return_sequences=not last,
                           peepholes=peepholes, fused=fused, generator=gen,
                           device=dev))
        width = hidden
        if dropout > 0 and not last:
            layers.append(Dropout(dropout))
    layers.append(Dense(width, out_dim, activation=head_activation,
                        generator=gen, device=dev))
    return Sequential(layers)


def build_tbptt_lstm(
    hidden: int = 512,
    num_layers: int = 2,
    out_dim: int = 7,
    peepholes: bool = True,
    dropout: float = 0.0,
    head_activation: str = "identity",
    *,
    in_features: int = 11,
    generator: torch.Generator | None = None,
    device=None,
) -> Sequential:
    """The variant for truncated-BPTT training over one long history
    (train/tbptt.py): every LSTM keeps ``return_sequences=True`` and the
    head applies per step, so the model emits a prediction at every draw
    and state can be threaded across chunks. ``fused`` is ``"off"``: the
    fused kernels start from a zero carry, and a chunk starts from the
    previous chunk's."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    layers = []
    width = in_features
    for i in range(num_layers):
        layers.append(LSTM(width, hidden, return_sequences=True,
                           peepholes=peepholes, fused="off", generator=gen,
                           device=dev))
        width = hidden
        if dropout > 0 and i < num_layers - 1:
            layers.append(Dropout(dropout))
    layers.append(Dense(width, out_dim, activation=head_activation,
                        generator=gen, device=dev))
    return Sequential(layers)


def init_step_states(model: Sequential, batch: int, dtype=None):
    """Zero (h, c) carries for every LSTM layer in ``model``."""
    dtype = dtype or torch.float32
    return [layer.initial_state(batch, dtype)
            for _, layer in model.named_layers()
            if isinstance(layer, LSTM)]


def step_apply(model: Sequential, states, x_t):
    """One timestep through the whole stack: ``[B, F] → [B, out]``.
    ``states`` holds one (h, c) per LSTM layer in layer order (the list
    from :func:`init_step_states`); every other layer applies per step
    (Dropout is the identity here). Returns ``(new_states, y_t)``."""
    new_states = []
    si = 0
    h = x_t
    for _, layer in model.named_layers():
        if isinstance(layer, LSTM):
            carry, h = layer.step_apply(states[si], h)
            new_states.append(carry)
            si += 1
        else:
            h = layer.apply(h)
    return new_states, h


def padded_apply(model: Sequential, x, last_idx, unroll=None, fused=False):
    """Whole-sequence apply over a TIME-PADDED batch: ``[B, Tpad, F]``
    plus per-row true-last-step indices ``last_idx [B] → [B, out]``.

    Every LSTM layer runs the full padded length from a zero carry and
    returns its hidden sequence; the head applies per step and each row's
    output is gathered at its true last step (outputs at step t depend
    only on steps <= t, so padding never reaches them). ``fused=True``
    runs every LSTM layer through the fused sequence kernel at ``x``'s
    dtype — legal here because each starts from the zero carry the kernel
    assumes. On CUDA it runs at every row bucket: the JAX package's
    ``_pallas_eligible`` gate is the TPU's (8|16, 128) tiling, which the
    card does not have. ``unroll`` is accepted and ignored."""
    del unroll
    b = x.shape[0]
    h = x
    for _, layer in model.named_layers():
        if isinstance(layer, LSTM):
            if fused:
                h = layer.fused_sequence(h)
            else:
                _, h = layer.scan_with_state(
                    h, layer.initial_state(b, h.dtype))
        else:
            h = layer.apply(h)
    last_idx = torch.as_tensor(last_idx, dtype=torch.long, device=h.device)
    return h[torch.arange(b, device=h.device), last_idx]


def make_sequences(
    features: np.ndarray,
    seq_len: int,
    *,
    target_columns: slice = slice(4, 11),
) -> tuple[np.ndarray, np.ndarray]:
    """Sliding windows over chronological draw rows: window t..t+seq_len-1
    predicts the ball columns of row t+seq_len. Returns
    (x [N, T, 11], y [N, 7]) float32."""
    n = len(features) - seq_len
    if n <= 0:
        raise ValueError(
            f"need more than seq_len={seq_len} rows, got {len(features)}")
    idx = np.arange(seq_len)[None, :] + np.arange(n)[:, None]
    x = features[idx]
    y = features[seq_len:, target_columns]
    return x.astype(np.float32), y.astype(np.float32)

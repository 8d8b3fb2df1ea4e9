"""Truncated backpropagation through time over long draw histories (the
JAX package's ``train/tbptt.py``).

DL4J trains recurrent nets on long sequences with
``tBPTTForwardLength``/``tBPTTBackwardLength``: the sequence is processed
in chunks, hidden state carries across chunks, and gradients stop at
chunk boundaries. Here the step is a Python loop over chunks (the JAX
package scans them in one jitted program). Each chunk detaches the
carried ``(h, c)`` on entry, so the backward pass is TBPTT(K, K): full
state memory, a K-step gradient horizon; each chunk takes one optimizer
update and returns its loss. The recurrence runs on each LSTM layer's
scan (``LSTM.scan_with_state``): the fused kernels start from a zero
carry, and a chunk starts from the previous one's.

The chronological draw history is folded into parallel batch lanes
(:func:`fold_history`), so the recurrent products are ``(lanes, H)``
rather than one row at a time.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
from torch.func import functional_call

from euromillioner_tpu_torch.nn.module import Sequential
from euromillioner_tpu_torch.nn.recurrent import LSTM
from euromillioner_tpu_torch.train.optim import Optimizer, apply_updates
from euromillioner_tpu_torch.utils.errors import TrainError

Params = Mapping[str, torch.Tensor]


def lstm_layers(model: Sequential) -> list[tuple[str, LSTM]]:
    """(param-key, layer) for every LSTM in the model, in order."""
    return [(name, layer) for name, layer in model.named_layers()
            if isinstance(layer, LSTM)]


def init_states(model: Sequential, batch: int, dtype=torch.float32):
    """Zero (h, c) carries for every LSTM layer in ``model``."""
    return [layer.initial_state(batch, dtype)
            for _, layer in lstm_layers(model)]


class _StatesProgram(torch.nn.Module):
    """The forward that threads explicit LSTM states, as a module, so
    ``functional_call`` can run it on params held outside the model."""

    def __init__(self, model: Sequential):
        super().__init__()
        self.model = model

    def forward(self, x, states, train, generator):
        new_states = []
        si = 0
        h = x
        for _, layer in self.model.named_layers():
            if isinstance(layer, LSTM):
                if not layer.return_sequences:
                    raise TrainError(
                        "TBPTT needs return_sequences=True on every LSTM "
                        "layer (build the model with build_tbptt_lstm)")
                carry, h = layer.scan_with_state(h, states[si])
                new_states.append(carry)
                si += 1
            else:
                h = layer.apply(h, train=train, generator=generator)
        return h, new_states


def apply_with_states(model: Sequential, params: Params | None, x, states,
                      *, train: bool = False,
                      generator: torch.Generator | None = None):
    """Forward through ``model`` threading explicit LSTM states.

    ``x`` is one chunk ``[B, K, F]``; ``states`` is the list from
    :func:`init_states` (or a previous chunk's return); ``params`` is a
    ``state_dict`` to run on (None: the model's own). Returns
    ``(out [B, K, D], new_states)``. Every LSTM layer must have
    ``return_sequences=True`` so the layers after it (and the per-step
    loss) see the whole chunk."""
    n_lstm = len(lstm_layers(model))
    if len(states) != n_lstm:
        raise TrainError(
            f"state count mismatch: model has {n_lstm} LSTM layers, "
            f"got {len(states)} states")
    program = _StatesProgram(model)
    args = (x, list(states), train, generator)
    if params is None:
        return program(*args)
    return functional_call(program,
                           {f"model.{k}": v for k, v in params.items()},
                           args)


def _assign(dst, src) -> None:
    """Copy every tensor of ``src`` into the same place in ``dst`` (dicts
    and tuples of tensors, as params and optimizer states are)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, Mapping):
        for k, v in dst.items():
            _assign(v, src[k])
    else:
        for d, s in zip(dst, src):
            _assign(d, s)


def make_tbptt_train_step(model: Sequential, optimizer: Optimizer,
                          loss_fn: Callable, chunk_len: int):
    """Build the TBPTT pass over a whole history.

    Returns ``step(params, opt_state, x, y, generator=None)`` with
    ``x [B, T, F]`` and per-step targets ``y [B, T, D]``; ``T`` must be a
    multiple of ``chunk_len``. Each chunk computes the loss over its K
    steps, backpropagates K steps (the state entering the chunk is
    detached) and applies one optimizer update, as DL4J's fit under
    tBPTT lengths does. ``params`` (a ``state_dict``) and ``opt_state``
    are updated in place and returned with the per-chunk losses, so the
    JAX package's ``p, s, _ = step(p, s, ...)`` loop reads the same.
    ``generator`` draws the chunks' dropout masks in turn."""
    if not lstm_layers(model):
        raise TrainError("TBPTT needs at least one LSTM layer")
    if chunk_len < 1:
        raise TrainError(f"chunk_len must be >= 1, got {chunk_len}")

    def step(params, opt_state, x, y, generator=None):
        b, t, _ = x.shape
        if t % chunk_len != 0:
            raise TrainError(
                f"sequence length {t} not a multiple of chunk_len "
                f"{chunk_len} — pad or trim")
        states = init_states(model, b, x.dtype)
        losses = []
        for c0 in range(0, t, chunk_len):
            states = [(h.detach(), c.detach()) for h, c in states]
            live = {k: v.detach().requires_grad_() for k, v in params.items()}
            out, states = apply_with_states(
                model, live, x[:, c0:c0 + chunk_len], states, train=True,
                generator=generator)
            loss = loss_fn(out.to(torch.float32), y[:, c0:c0 + chunk_len])
            grads = dict(zip(live, torch.autograd.grad(
                loss, list(live.values()))))
            with torch.no_grad():
                frozen = {k: v.detach() for k, v in params.items()}
                updates, new_state = optimizer.update(grads, opt_state,
                                                      frozen)
                _assign(params, apply_updates(frozen, updates))
                _assign(opt_state, new_state)
            losses.append(loss.detach())
        return params, opt_state, torch.stack(losses)

    return step


def fold_history(features: np.ndarray, lanes: int,
                 *, target_columns: slice = slice(4, 11),
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Fold one chronological history into parallel batch lanes with
    per-step next-draw targets.

    ``features`` is the whole featurized draw table ``[N, 11]``. Row t's
    target is row t+1's ball columns. The N-1 usable steps are split into
    ``lanes`` contiguous segments — ``x [lanes, (N-1)//lanes, 11]``,
    ``y [lanes, (N-1)//lanes, 7]``; the oldest rows are dropped to reach a
    multiple of ``lanes`` (the newest draws matter for next-draw
    prediction). Lane boundaries break the recurrence in ``lanes - 1``
    places, the usual long-sequence batching trade."""
    if lanes < 1:
        raise TrainError(f"lanes must be >= 1, got {lanes}")
    x_all = features[:-1]
    y_all = features[1:, target_columns]
    steps = (len(x_all) // lanes) * lanes
    if steps == 0:
        raise TrainError(
            f"history of {len(features)} rows too short for {lanes} lanes")
    x = x_all[-steps:].reshape(lanes, -1, features.shape[-1])
    y = y_all[-steps:].reshape(lanes, -1, y_all.shape[-1])
    return x.astype(np.float32), y.astype(np.float32)

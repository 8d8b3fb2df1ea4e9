"""Faults planted under the timed path, to show that ``correct`` catches
them (``tests/test_faults.py`` on the CPU, ``calibrate.py --fault`` on
the card at a cell's own size). Each is a context manager that patches
the program for its duration.

- ``unchanged``: a training step that returns the state it was given.
- ``half_batch``: half of each batch left out, the mean taken over the
  rest (training: the second half's mask is 0; serving: the second half
  of a micro-batch's real rows answers zeros).
- ``altered``: an answer altered where it is produced (training: the
  first leaf's gradient scaled by 1.5 before the update; serving: the
  first row of each micro-batch moved by 1% of the batch's largest
  output).
"""

from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _trainer():
    from euromillioner_tpu_torch.train.trainer import Trainer
    return Trainer


def _backend():
    from euromillioner_tpu_torch.serve.continuous import RecurrentBackend
    return RecurrentBackend


def unchanged():
    def make(orig):
        def train_step(self, state, batch, generator=None):
            _, loss = orig(self, state, batch, generator)
            return state, loss
        return train_step
    return _patched(_trainer(), "train_step", make)


def _wrap_padded(change):
    """Patch every new backend's batch program so that ``change(x, y)``
    rewrites its output."""
    def make(orig):
        def __init__(self, *a, **kw):
            orig(self, *a, **kw)
            run = self.padded_fn

            def padded(x, last_idx):
                return change(x, run(x, last_idx))
            self.padded_fn = padded
        return __init__
    return _patched(_backend(), "__init__", make)


def half_batch(kind: str = "train"):
    if kind == "serve":
        def change(x, y):
            import numpy as np
            real = np.nonzero(np.abs(np.asarray(x)).sum(axis=(1, 2)) > 0)[0]
            y = y.clone()
            y[real[len(real) // 2:]] = 0
            return y
        return _wrap_padded(change)

    def make(orig):
        def _place(self, batch):
            placed = orig(self, batch)
            half = placed.mask.shape[0] // 2
            placed.mask[half:] = 0
            return placed
        return _place
    return _patched(_trainer(), "_place", make)


def altered(kind: str = "train"):
    if kind == "serve":
        def change(x, y):
            y = y.clone()
            y[0] += 0.01 * y.abs().max()
            return y
        return _wrap_padded(change)

    def make(orig):
        def _reduce(self, grads, loss):
            grads, loss = orig(self, grads, loss)
            first = next(iter(grads))
            return {**grads, first: grads[first] * 1.5}, loss
        return _reduce
    return _patched(_trainer(), "_reduce", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}

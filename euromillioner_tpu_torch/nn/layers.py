"""Dense and Dropout (the layers the LSTM model stacks)."""

from __future__ import annotations

from typing import Callable

import torch

from euromillioner_tpu_torch.nn import initializers as init
from euromillioner_tpu_torch.nn.module import Module

_ACTIVATIONS: dict[str, Callable] = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "identity": lambda x: x,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


class Dense(Module):
    """y = act(x @ kernel + bias); kernel is (in, units) as in the JAX
    package."""

    def __init__(self, in_features: int, units: int,
                 activation: str = "identity", use_bias: bool = True, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.units = units
        self.activation = activation
        self.use_bias = use_bias
        self.kernel = torch.nn.Parameter(
            init.glorot_uniform((in_features, units), generator, device))
        if use_bias:
            self.bias = torch.nn.Parameter(
                torch.zeros(units, device=device))

    def apply(self, x, *, train=False, generator=None):
        y = x @ self.kernel.to(x.dtype)
        if self.use_bias:
            y = y + self.bias.to(x.dtype)
        return _ACTIVATIONS[self.activation](y)


class Dropout(Module):
    """Inverted dropout: the identity unless ``train``; then each element
    is kept with probability ``1 - rate`` (a uniform draw below it, as
    ``jax.random.bernoulli`` decides) and scaled by ``1 / (1 - rate)``.
    The mask is drawn on x's device from ``generator``, which must live on
    that device (the trainer makes one per epoch there), so no mask
    crosses from the host."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def apply(self, x, *, train=False, generator=None):
        if not train or self.rate <= 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout needs a generator when train=True")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)

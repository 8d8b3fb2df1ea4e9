"""Module base + Sequential container.

In the JAX package a ``Module`` is a hyperparameter record whose pure
``init``/``apply`` take a params pytree. Here a layer is a
``torch.nn.Module`` that owns its parameters under the same leaf names
(``wx``, ``wh``, ``kernel``, ...), built with its input width known, and
``apply(x, *, train=False, generator=None)`` is its forward pass (the JAX
package's name; it shadows ``torch.nn.Module.apply(fn)``, which this
package never calls). ``train`` and ``generator`` take the place of the
JAX package's ``train``/``rng``: stochastic layers (Dropout) draw from the
explicit ``torch.Generator`` when ``train`` is set. Parameters are created
on the caller's ``device`` from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Sequence

import torch


class Module(torch.nn.Module):
    """Base class: ``forward`` is ``apply``."""

    def apply(self, x, *, train: bool = False,
              generator: torch.Generator | None = None):
        raise NotImplementedError

    def forward(self, x, *, train: bool = False,
                generator: torch.Generator | None = None):
        return self.apply(x, train=train, generator=generator)

    @property
    def name(self) -> str:
        return type(self).__name__


class Sequential(Module):
    """Chain of layers. Children are registered as ``"{index}_{name}"``
    (``0_LSTM``, ``1_LSTM``, ``2_Dense``), so ``state_dict`` keys are the
    JAX package's param paths joined by dots (``0_LSTM.wx``)."""

    def __init__(self, layers: Sequence[Module]):
        super().__init__()
        for i, layer in enumerate(layers):
            self.add_module(f"{i}_{layer.name}", layer)

    def named_layers(self) -> list[tuple[str, Module]]:
        """(param-key, layer) pairs in order — THE definition of the key
        scheme."""
        return list(self.named_children())

    def apply(self, x, *, train=False, generator=None):
        for _, layer in self.named_layers():
            x = layer.apply(x, train=train, generator=generator)
        return x

    @property
    def name(self) -> str:
        return "Sequential"


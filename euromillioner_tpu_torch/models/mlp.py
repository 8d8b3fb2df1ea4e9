"""Euromillions MLP (the JAX package's ``models/mlp.py``, BASELINE.json
config 1).

Dense→ReLU blocks with optional dropout and a linear head. The layers
are registered under the JAX ``Sequential``'s names (``0_Dense``,
``1_Dropout``, ...), so a checkpoint of either package loads in the
other unchanged.
"""

from __future__ import annotations

import torch

from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.nn import Dense, Dropout, Sequential


def build_mlp(hidden_sizes: tuple[int, ...] = (256, 256), out_dim: int = 1,
              activation: str = "relu", dropout: float = 0.0,
              head_activation: str = "identity", *,
              in_features: int = 10,
              generator: torch.Generator | None = None,
              device=None) -> Sequential:
    """The MLP over ``in_features`` inputs (the 10 label-dropped features
    by default), weights drawn from ``generator`` (seed 0 when None) on
    ``device`` (the card when None)."""
    dev = resolve_device(device)
    gen = (generator if generator is not None
           else torch.Generator().manual_seed(0))
    layers = []
    width = in_features
    for h in hidden_sizes:
        layers.append(Dense(width, h, activation=activation, generator=gen,
                            device=dev))
        if dropout > 0:
            layers.append(Dropout(dropout))
        width = h
    layers.append(Dense(width, out_dim, activation=head_activation,
                        generator=gen, device=dev))
    return Sequential(layers)

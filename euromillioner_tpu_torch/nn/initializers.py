"""Weight initializers drawn from a ``torch.Generator``.

They match the JAX package's initializers in shape and distribution, not
in values (jax.random and torch's generators differ). Draws happen on the
CPU from a CPU generator and then move to ``device``, so a seed gives the
same weights on every device.
"""

from __future__ import annotations

import math

import torch


def _fans(shape) -> tuple[int, int]:
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def glorot_uniform(shape, generator: torch.Generator, device=None,
                   dtype=torch.float32) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * (2 * limit) - limit).to(device=device, dtype=dtype)


def normal(stddev: float = 0.01):
    def init(shape, generator: torch.Generator, device=None,
             dtype=torch.float32) -> torch.Tensor:
        z = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (stddev * z).to(device=device, dtype=dtype)
    return init


def orthogonal(shape, generator: torch.Generator, device=None,
               dtype=torch.float32) -> torch.Tensor:
    """Orthogonal init (used for recurrent kernels)."""
    if len(shape) < 2:
        raise ValueError("orthogonal init needs >=2-D shape")
    rows, cols = math.prod(shape[:-1]), shape[-1]
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator,
                    dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return q[:rows, :cols].reshape(shape).to(device=device, dtype=dtype)

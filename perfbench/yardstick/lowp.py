"""Roundings that the controls put in the reference's place: the step
below the precision a configuration states.

- ``fp8``: each tensor scaled by its largest magnitude to float8 e4m3's
  range (448), rounded to e4m3 and scaled back, as per-tensor-scaled fp8
  products do, and the gradient that flows back through it rounded the
  same way to e5m2 (range 57344), as fp8 training keeps its gradients;
  the step below bfloat16, whose program runs its backward in bfloat16
  too.
- ``tf32``: the float32 mantissa rounded to TF32's 10 bits (round to
  nearest, ties to even), as the tensor cores take float32 operands with
  TF32 on; the step below float32 with TF32 off.

``tf32`` passes the gradient through unrounded.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _straight(t, rounded):
    return t + (rounded - t).detach() if t.requires_grad else rounded


def _scaled(t, dtype, top: float):
    with torch.no_grad():
        amax = t.detach().abs().amax().to(torch.float32)
        scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
        return (t.detach() / scale).to(dtype).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _scaled(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g, torch.float8_e5m2, E5M2_MAX)


def fp8(t):
    if t.requires_grad:
        return _Fp8.apply(t)
    return _scaled(t, torch.float8_e4m3fn, E4M3_MAX)


def tf32(t):
    with torch.no_grad():
        bits = t.detach().to(torch.float32).contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        r = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32).to(t.dtype)
    return _straight(t, r)


ROUNDINGS = {"fp8": fp8, "tf32": tf32}

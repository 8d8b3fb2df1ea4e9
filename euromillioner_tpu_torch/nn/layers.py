"""Core layers: Dense, Embedding, Dropout, LayerNorm, Activation,
Flatten (the JAX package's ``nn/layers.py``), with its leaf names and
shapes (``kernel``/``bias``, ``table``, ``scale``/``bias``)."""

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
        return dense(x, self.kernel, self.bias if self.use_bias else None,
                     self.activation)


def dense(x, kernel, bias, activation: str = "identity"):
    """``Dense``'s arithmetic on given tensors: ``act(x @ kernel + bias)``
    in x's dtype (``bias`` may be None) — what a serving program runs on
    a params tree that is not the layer's own."""
    y = x @ kernel.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return _ACTIVATIONS[activation](y)


def tp_dense_stack(layers, params: list, dims: dict, xs: list, comm,
                   prefix: str = "") -> list:
    """A chain of :class:`Dense` layers (``(name, layer)`` pairs) under
    tensor parallelism, over per-shard lists (``dist/collectives.py``
    ``RankComm`` / ``DeviceComm``): ``params[j]`` holds shard
    ``comm.shards[j]``'s leaves under ``prefix + name + ".kernel"`` and
    ``".bias"``, ``dims`` the dim each leaf is split on over ``model``
    (None: whole on every shard), ``xs`` the replicated input on each
    shard. A kernel split on its output dim runs column-parallel (each
    shard its own columns, joined only where a later layer needs them
    whole); one split on its input dim runs row-parallel (partial
    products, then one all-reduce); a whole kernel runs replicated.
    Returns the replicated output on each shard."""
    local = False  # xs hold each shard's own columns

    def whole(xs):
        return comm.gather(xs, -1) if local else xs

    for name, layer in layers:
        kname, bname = f"{prefix}{name}.kernel", f"{prefix}{name}.bias"
        dim = dims.get(kname)
        act = _ACTIVATIONS[layer.activation]
        if dim == 1:
            xs = comm.copy(whole(xs))
            bs = [p[bname] for p in params] if layer.use_bias else None
            if bs is not None and dims.get(bname) is None:
                bs = [shard_block(b, 0, j, comm.size)
                      for b, j in zip(comm.copy(bs), comm.shards)]
            ys = []
            for i, (p, x) in enumerate(zip(params, xs)):
                y = x @ p[kname].to(x.dtype)
                if bs is not None:
                    y = y + bs[i].to(x.dtype)
                ys.append(y)
            if layer.activation == "softmax":
                xs, local = [act(y) for y in comm.gather(ys, -1)], False
            else:
                xs, local = [act(y) for y in ys], True
        elif dim == 0:
            if not local:
                xs = [shard_block(x, -1, j, comm.size)
                      for x, j in zip(comm.copy(xs), comm.shards)]
            ys = comm.all_reduce([x @ p[kname].to(x.dtype)
                                  for p, x in zip(params, xs)])
            if layer.use_bias:
                ys = [y + p[bname].to(y.dtype) for p, y in zip(params, ys)]
            xs, local = [act(y) for y in ys], False
        else:
            xs = whole(xs)
            xs = [dense(x, p[kname], p[bname] if layer.use_bias else None,
                        layer.activation) for p, x in zip(params, xs)]
            local = False
    return whole(xs)


def shard_block(x, dim: int, index: int, size: int):
    """Block ``index`` of ``size`` equal blocks of ``x`` along ``dim``."""
    width = x.shape[dim] // size
    return x.narrow(dim, index * width, width)


class Embedding(Module):
    """Integer ids → vectors; ``table`` is (vocab, dim), drawn from
    N(0, 0.01²) as in the JAX package."""

    def __init__(self, vocab_size: int, dim: int, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.vocab_size = vocab_size
        self.dim = dim
        self.table = torch.nn.Parameter(
            init.normal(0.01)((vocab_size, dim), generator, device))

    def apply(self, x, *, train=False, generator=None):
        return torch.nn.functional.embedding(x.to(torch.int64), self.table)


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


class LayerNorm(Module):
    """Normalise the last axis (population variance), then ``scale`` and
    ``bias`` in x's dtype."""

    def __init__(self, dim: int, epsilon: float = 1e-5, *, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = torch.nn.Parameter(torch.ones(dim, device=device))
        self.bias = torch.nn.Parameter(torch.zeros(dim, device=device))

    def apply(self, x, *, train=False, generator=None):
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale.to(x.dtype) + self.bias.to(x.dtype)


class Activation(Module):
    """One named activation (``_ACTIVATIONS``) as a layer."""

    def __init__(self, fn: str):
        super().__init__()
        if fn not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {fn!r}")
        self.fn = fn

    def apply(self, x, *, train=False, generator=None):
        return _ACTIVATIONS[self.fn](x)

    @property
    def name(self) -> str:
        return f"Activation_{self.fn}"


class Flatten(Module):
    """Collapse every axis but the leading (batch) one."""

    def apply(self, x, *, train=False, generator=None):
        return x.reshape(x.shape[0], -1)

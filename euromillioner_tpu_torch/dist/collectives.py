"""Collectives over the mesh's groups (the JAX package's
``dist/collectives.py``), written for one process per worker.

There a "stacked" tree carries a leading worker axis sharded over the
mesh, and one ``psum`` inside a compiled program combines the slices.
Here each rank holds its own slice in its own process: every rank passes
its tree and gets the replicated result back. A tree is a tensor, or a
dict, list or tuple of trees. Each dtype's leaves go through one flat
bucket and one ``all_reduce``.

Only ``all_reduce`` and ``broadcast`` are used, the collectives gloo runs
on CUDA tensors too (it has no ``all_gather`` for them): a gather is an
``all_reduce`` of a zero buffer holding each rank's rows in its own
place, exact in any summation order.

Tensor and sequence parallelism (``dist/sharded.py``,
``dist/seq_parallel.py``) run their collectives inside autograd, each a
``torch.autograd.Function`` whose backward is the collective's transpose
(:func:`model_all_reduce`, :func:`model_copy`, :func:`model_gather`,
:func:`carry_handoff`, :func:`broadcast_from`). A model group computes
what follows a gather or an all-reduce alike on every rank, so those two
pass the replicated gradient straight back (a gather keeps its own
block). :class:`RankComm` and :class:`DeviceComm` give a tensor-parallel
forward one vocabulary over per-shard lists: one rank's shard over its
process group (training), or every shard of a serving mesh's row in one
process (serving, no gradients).

``psum_stacked``, ``pmean_stacked`` and ``tree_aggregate`` first check
that every rank's slice has the same leaves, shapes and dtypes (one small
collective): a mismatch raises DistributedError on every rank, where the
JAX helpers raise for a slice per worker that is missing.
"""

from __future__ import annotations

import zlib
from typing import Any, Callable

import torch
import torch.distributed as dist

from euromillioner_tpu_torch.core.mesh import Mesh
from euromillioner_tpu_torch.utils.errors import DistributedError


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in a fixed order (dict keys as given)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rebuild(tree: Any, values) -> Any:
    """``tree``'s structure with its leaves taken in order from the
    iterator ``values``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, values) for v in tree)
    return next(values)


def _bucketed(tensors: list[torch.Tensor], mesh: Mesh,
              collective: Callable[[torch.Tensor], Any]
              ) -> list[torch.Tensor]:
    """``collective`` run in place on one flat bucket per dtype of
    ``tensors`` (on ``mesh.device``); each tensor's part of its bucket,
    in its shape."""
    out: list[Any] = [None] * len(tensors)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1).to(mesh.device)
                          for i in idx])
        collective(flat)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def all_reduce_tensors(tensors: list[torch.Tensor], mesh: Mesh,
                       op=dist.ReduceOp.SUM) -> list[torch.Tensor]:
    """Each tensor reduced across the group, as new tensors on
    ``mesh.device``: one flat bucket and one ``all_reduce`` per dtype."""
    return _bucketed(tensors, mesh, lambda flat: dist.all_reduce(
        flat, op=op, group=mesh.group))


def all_reduce_tree(tree: Any, mesh: Mesh, op=dist.ReduceOp.SUM) -> Any:
    """``tree`` reduced across the group (no slice check)."""
    return rebuild(tree, iter(all_reduce_tensors(leaves(tree), mesh, op)))


def broadcast_tree(tree: Any, mesh: Mesh, src: int = 0) -> Any:
    """``tree`` as rank ``src`` of the mesh's group holds it, on every
    rank: one flat bucket and one ``broadcast`` per dtype."""
    return rebuild(tree, iter(_bucketed(
        leaves(tree), mesh, lambda flat: dist.broadcast(
            flat, group=mesh.group, group_src=src))))


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) stacked in rank order
    along a new leading axis, on every rank."""
    buf = torch.zeros((mesh.data, *t.shape), dtype=t.dtype,
                      device=mesh.device)
    buf[mesh.rank] = t
    dist.all_reduce(buf, group=mesh.group)
    return buf


def _check_slices(tree: Any, mesh: Mesh) -> list[torch.Tensor]:
    """The leaves of ``tree``; DistributedError on every rank unless every
    rank's leaves are tensors of the same shapes and dtypes."""
    ts = leaves(tree)
    desc = ";".join(f"{tuple(t.shape)}:{t.dtype}"
                    if isinstance(t, torch.Tensor) else type(t).__name__
                    for t in ts)
    sig = torch.tensor([len(ts), zlib.crc32(desc.encode())],
                       dtype=torch.int64)
    rows = gather_rows(sig.to(mesh.device), mesh).cpu()
    if not bool((rows == rows[mesh.rank]).all()):
        raise DistributedError(
            f"the ranks' slices differ in leaves, shapes or dtypes (rank "
            f"{mesh.rank}: {desc or 'no leaves'}) — one slice per worker, "
            f"alike on every rank, required")
    for i, t in enumerate(ts):
        if not isinstance(t, torch.Tensor):
            raise DistributedError(
                f"leaf {i} is a {type(t).__name__}, not a tensor — each "
                f"rank passes its slice as tensors")
    return ts


def psum_stacked(tree: Any, mesh: Mesh) -> Any:
    """Sum the ranks' slices → the replicated result on every rank (Spark's
    ``treeAggregate``, collapsed into one all-reduce)."""
    ts = _check_slices(tree, mesh)
    return rebuild(tree, iter(all_reduce_tensors(ts, mesh)))


def pmean_stacked(tree: Any, mesh: Mesh) -> Any:
    """Mean of the ranks' slices → the replicated result (the
    parameter-averaging primitive): their sum over the group's size."""
    ts = _check_slices(tree, mesh)
    return rebuild(tree, iter(t / mesh.data
                              for t in all_reduce_tensors(ts, mesh)))


def tree_aggregate(per_worker_fn: Callable[[Any], Any], data: Any,
                   mesh: Mesh, combine: str = "sum") -> Any:
    """Spark ``RDD.treeAggregate``: map this rank's data slice through
    ``per_worker_fn`` on its device, then combine the partials of every
    rank (``sum`` or ``mean``); the result is replicated."""
    if combine not in ("sum", "mean"):
        raise ValueError(f"combine must be sum|mean, got {combine!r}")
    _check_slices(data, mesh)
    partial = per_worker_fn(data)
    return (psum_stacked if combine == "sum" else pmean_stacked)(partial,
                                                                  mesh)


def all_reduce_grads(grads: dict[str, torch.Tensor], mesh: Mesh,
                     *extra: torch.Tensor):
    """Sum every rank's gradients (and the scalars ``extra``, e.g. the
    step's loss) in one flat float32 bucket and one ``all_reduce``, then
    unpack the sums into the gradient tensors in place. Returns ``(grads,
    [reduced extra])``."""
    parts = [g.reshape(-1).to(torch.float32) for g in grads.values()]
    parts += [e.reshape(-1).to(torch.float32) for e in extra]
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=mesh.group)
    views = flat.split([p.numel() for p in parts])
    for g, v in zip(grads.values(), views):
        g.copy_(v.view(g.shape))
    return grads, [v.view(e.shape).to(e.dtype)
                   for v, e in zip(views[len(grads):], extra)]


# -- tensor parallelism over the model group ---------------------------------

def _reduced(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``t`` summed over ``group``, in float32 where ``t`` is
    narrower (then cast back)."""
    buf = t.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


def _zero_gather(t: torch.Tensor, dim: int, index: int, size: int, group
                 ) -> torch.Tensor:
    """Every rank's ``t`` laid side by side along ``dim`` in group order:
    an all-reduce of a zero buffer holding this rank's block in its place
    (exact in any summation order; gloo has no all-gather on CUDA)."""
    shape = list(t.shape)
    width = shape[dim]
    shape[dim] = width * size
    buf = t.new_zeros(shape, dtype=torch.float32)
    buf.narrow(dim, index * width, width).copy_(t)
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


class _AllReduce(torch.autograd.Function):
    """Forward: the sum of the group's partials. Backward: the replicated
    gradient of the sum is each partial's."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Forward: the identity on a replicated input about to be used
    shard-locally. Backward: the sum of the shards' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """Forward: the shards joined along ``dim``. Backward: this rank's
    block of the replicated gradient."""

    @staticmethod
    def forward(ctx, x, dim, index, size, group):
        ctx.dim, ctx.index, ctx.width = dim, index, x.shape[dim]
        return _zero_gather(x.contiguous(), dim, index, size, group)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.width,
                         ctx.width).contiguous(), None, None, None, None)


def model_all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the model group's partials ``x`` (a row-parallel
    product's), on every rank."""
    return _AllReduce.apply(x, mesh.model_group)


def model_copy(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` (replicated over the model group) as the input of a
    shard-local product: its gradient is summed over the group."""
    return _Copy.apply(x, mesh.model_group)


def model_gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The model group's shards of a leaf or activation joined along
    ``dim`` (this rank's block keeps its gradient)."""
    return _Gather.apply(x, dim, mesh.model_rank, mesh.model,
                         mesh.model_group)


class RankComm:
    """One rank's view of a tensor-parallel forward: each per-shard list
    holds this rank's shard alone, and the collectives run over its model
    group inside autograd."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.shards = (mesh.model_rank,)
        self.size = mesh.model

    def all_reduce(self, xs: list) -> list:
        return [model_all_reduce(xs[0], self.mesh)]

    def copy(self, xs: list) -> list:
        return [model_copy(xs[0], self.mesh)]

    def gather(self, xs: list, dim: int) -> list:
        return [model_gather(xs[0], self.mesh, dim)]


class DeviceComm:
    """Every model shard of one serving-mesh row in this process:
    ``devices[j]`` holds shard ``j``. An all-reduce adds the partials in
    shard order on shard 0's device and hands the sum to every device; a
    gather joins the shards there the same way. No gradients."""

    def __init__(self, devices):
        self.devices = tuple(devices)
        self.shards = tuple(range(len(self.devices)))
        self.size = len(self.devices)

    def _spread(self, t: torch.Tensor) -> list:
        return [t if t.device == d else t.to(d, non_blocking=True)
                for d in self.devices]

    def all_reduce(self, xs: list) -> list:
        head = self.devices[0]
        total = xs[0]
        for x in xs[1:]:
            total = total + x.to(head, non_blocking=True)
        return self._spread(total)

    def copy(self, xs: list) -> list:
        return list(xs)

    def gather(self, xs: list, dim: int) -> list:
        head = self.devices[0]
        return self._spread(torch.cat([x.to(head, non_blocking=True)
                                       for x in xs], dim=dim))


# -- sequence parallelism over the seq group ---------------------------------

class _Handoff(torch.autograd.Function):
    """Forward: (h, c) sent from seq rank k arrives at k + 1 (zeros at
    rank 0: the leftmost chunk's initial carry). Backward: the gradient of
    what rank k + 1 received goes back to rank k (the transpose of the
    JAX package's ``ppermute`` chain)."""

    @staticmethod
    def forward(ctx, h, c, index, size, group):
        ctx.index, ctx.size, ctx.group = index, size, group
        buf = h.new_zeros((size, 2, *h.shape), dtype=torch.float32)
        buf[index, 0] = h
        buf[index, 1] = c
        dist.all_reduce(buf, group=group)
        if index == 0:
            return torch.zeros_like(h), torch.zeros_like(c)
        return buf[index - 1, 0].to(h.dtype), buf[index - 1, 1].to(c.dtype)

    @staticmethod
    def backward(ctx, gh, gc):
        i, n = ctx.index, ctx.size
        buf = gh.new_zeros((n, 2, *gh.shape), dtype=torch.float32)
        if i > 0:  # what rank 0 received came from no one
            buf[i, 0] = gh
            buf[i, 1] = gc
        dist.all_reduce(buf, group=ctx.group)
        if i == n - 1:
            return (torch.zeros_like(gh), torch.zeros_like(gc),
                    None, None, None)
        return (buf[i + 1, 0].to(gh.dtype), buf[i + 1, 1].to(gc.dtype),
                None, None, None)


def carry_handoff(h: torch.Tensor, c: torch.Tensor, mesh: Mesh):
    """The LSTM carry ``(h, c)`` this seq rank sends to the next, and the
    one it receives from the previous (zeros on the first): one
    all-reduce over the seq group each way."""
    return _Handoff.apply(h, c, mesh.seq_rank, mesh.seq, mesh.seq_group)


class _BroadcastFrom(torch.autograd.Function):
    """Forward: ``src``'s tensor on every rank of ``group``. Backward: the
    ranks' gradients summed, delivered to ``src`` (zeros elsewhere)."""

    @staticmethod
    def forward(ctx, x, index, src, group):
        ctx.mine, ctx.group = index == src, group
        out = x.to(torch.float32, copy=True).contiguous()
        dist.broadcast(out, group=group, group_src=src)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        g = _reduced(g, ctx.group)
        return (g if ctx.mine else torch.zeros_like(g)), None, None, None


def broadcast_from(x: torch.Tensor, mesh: Mesh, src: int) -> torch.Tensor:
    """Seq rank ``src``'s ``x`` on every rank of the seq group."""
    return _BroadcastFrom.apply(x, mesh.seq_rank, src, mesh.seq_group)

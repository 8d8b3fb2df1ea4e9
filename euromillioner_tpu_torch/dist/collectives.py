"""Collectives over the data-parallel group (the JAX package's
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

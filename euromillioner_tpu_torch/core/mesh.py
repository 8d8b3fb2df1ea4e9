"""The device mesh of a process group (the JAX package's
``core/mesh.py``).

There the mesh is a ``jax.sharding.Mesh`` over every device and XLA puts
the collectives in from sharding annotations. Here one process drives one
device, the processes form a ``torch.distributed`` group (NCCL on the
card, gloo on the CPU or with several ranks on one card;
``dist/bootstrap.py``), and the mesh is a record of what one rank sees:
the ``data``, ``model`` and ``seq`` axis sizes, this rank's coordinate on
each, its device and one process group per axis. Ranks are laid out as
the JAX package lays out devices (``build_mesh``): ``model`` varies
fastest, then ``seq``, then ``data``.

Devices are counted as the JAX package counts them: on the card, one per
rank of the group; on the CPU, ``EUROMILLIONER_CPU_DEVICES`` (the JAX
CLI's knob) where it is set, else one per rank. A mesh that does not
cover them raises DistributedError, as ``MeshSpec.resolve`` does there.

Tensor parallelism places parameters by rules (:func:`shard_params`, the
JAX semantics): each rank holds its own contiguous shard of a sharded
leaf and the whole of a replicated one. :class:`PartitionSpec` (``P``)
names, per dimension, the mesh axis it is split over.

The serving mesh (:func:`serving_mesh`) is another object: a grid of
``torch.device``s that one process drives, ``data`` rows by ``model``
columns, which is what the JAX serving mesh is.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.utils.errors import ConfigError, DistributedError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("core.mesh")

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
ALL_AXES = (AXIS_DATA, AXIS_MODEL, AXIS_SEQ)
CPU_DEVICES_ENV = "EUROMILLIONER_CPU_DEVICES"


class PartitionSpec(tuple):
    """Per dimension, the mesh axis (or tuple of axes) it is split over,
    or None (``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True)
class MeshSpec:
    """Sizes per logical axis; -1 means "all remaining devices"."""

    data: int = -1
    model: int = 1
    seq: int = 1

    @classmethod
    def from_config(cls, mesh_cfg) -> "MeshSpec":
        """Adapt any object with data/model/seq fields (e.g.
        ``config.MeshConfig``) into a MeshSpec."""
        return cls(data=mesh_cfg.data, model=mesh_cfg.model, seq=mesh_cfg.seq)

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        sizes = [self.data, self.model, self.seq]
        unknown = [i for i, s in enumerate(sizes) if s == -1]
        if len(unknown) > 1:
            raise DistributedError("at most one mesh axis may be -1")
        known = int(np.prod([s for s in sizes if s != -1]))
        if unknown:
            if n_devices % known:
                raise DistributedError(
                    f"{n_devices} devices not divisible by fixed axes {known}")
            sizes[unknown[0]] = n_devices // known
        if int(np.prod(sizes)) != n_devices:
            raise DistributedError(
                f"mesh {tuple(sizes)} does not cover {n_devices} devices")
        return tuple(sizes)  # type: ignore[return-value]


def cpu_device_count() -> int | None:
    """``EUROMILLIONER_CPU_DEVICES`` as an integer >= 1, None when unset
    (ConfigError when malformed)."""
    raw = os.environ.get(CPU_DEVICES_ENV)
    if not raw:
        return None
    try:
        count = int(raw)
    except ValueError:
        raise ConfigError(f"{CPU_DEVICES_ENV} must be an integer, got "
                          f"{raw!r}") from None
    if count < 1:
        raise ConfigError(f"{CPU_DEVICES_ENV} must be >= 1, got {count}")
    return count


def local_device_count(device: torch.device) -> int:
    """Devices this host offers ranks: the visible cards on ``cuda``,
    ``EUROMILLIONER_CPU_DEVICES`` (default 1) on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return cpu_device_count() or 1


@dataclass(frozen=True)
class Mesh:
    """What one rank of a process group sees. ``data``, ``model`` and
    ``seq`` are the axis sizes; ``rank``, ``model_rank`` and ``seq_rank``
    this rank's coordinates; ``group``, ``model_group`` and ``seq_group``
    the process groups along each axis through this rank (None: the
    default group, which a one-axis mesh's own axis is). ``replica_group``
    joins the ranks that hold the same model shard (every ``data`` and
    ``seq`` coordinate): gradients are summed over it."""

    data: int
    rank: int
    device: torch.device
    group: Any = None
    model: int = 1
    seq: int = 1
    model_rank: int = 0
    seq_rank: int = 0
    model_group: Any = None
    seq_group: Any = None
    replica_group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes in the JAX mesh's order, for the ``device mesh:``
        log line."""
        return {AXIS_DATA: self.data, AXIS_SEQ: self.seq,
                AXIS_MODEL: self.model}

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return {AXIS_DATA: self.rank, AXIS_MODEL: self.model_rank,
                AXIS_SEQ: self.seq_rank}[axis]


def mesh_ranks(data: int, model: int, seq: int) -> np.ndarray:
    """Global ranks as a (data, seq, model) grid: ``model`` varies
    fastest, then ``seq``, then ``data`` (``build_mesh``'s layout)."""
    return np.arange(data * seq * model).reshape(data, seq, model)


def _axis_groups(grid: np.ndarray, rank: int):
    """The (data, model, seq, replica) groups through ``rank``: every
    group of each axis is created, on every rank in the same order, as
    ``torch.distributed.new_group`` requires."""
    d, s, m = grid.shape
    mine = {}
    lines = {
        AXIS_DATA: [grid[:, j, k] for j in range(s) for k in range(m)],
        AXIS_MODEL: [grid[i, j, :] for i in range(d) for j in range(s)],
        AXIS_SEQ: [grid[i, :, k] for i in range(d) for k in range(m)],
        "replica": [grid[:, :, k].reshape(-1) for k in range(m)],
    }
    for axis, members in lines.items():
        for ranks in members:
            g = torch.distributed.new_group([int(r) for r in ranks])
            if rank in ranks:
                mine[axis] = g
    return mine[AXIS_DATA], mine[AXIS_MODEL], mine[AXIS_SEQ], mine["replica"]


def build_mesh(spec: MeshSpec | None = None, device=None, group=None) -> Mesh:
    """The mesh of this rank over an initialised process group
    (``dist.bootstrap.initialize``), on ``device`` (the card unless
    ``"cpu"``; on the card the current device, which ``initialize`` set
    to this rank's). A mesh of the ``data`` axis alone runs on ``group``
    (None: the default group); one with a ``model`` or ``seq`` axis above
    1 creates a group per axis line over the default group."""
    spec = spec or MeshSpec()
    dev = resolve_device(device)
    if not torch.distributed.is_initialized():
        raise DistributedError(
            "no process group: call dist.bootstrap.initialize (or run "
            "train --distributed) before building a mesh")
    world = torch.distributed.get_world_size(group)
    n_devices = world
    if dev.type == "cpu":
        n_devices = cpu_device_count() or world
    data, model, seq = spec.resolve(n_devices)
    if data * model * seq != world:
        raise DistributedError(
            f"mesh {data}x{seq}x{model} (data x seq x model) does not "
            f"match the {world} ranks of the process group (one rank per "
            f"device)")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    rank = torch.distributed.get_rank(group)
    if model == 1 and seq == 1:
        return Mesh(data=data, rank=rank, device=dev, group=group,
                    replica_group=group)
    if group is not None:
        raise DistributedError(
            "a mesh with a model or seq axis spans the default process "
            "group")
    grid = mesh_ranks(data, model, seq)
    (i,), (j,), (k,) = np.nonzero(grid == rank)
    g_data, g_model, g_seq, g_rep = _axis_groups(grid, rank)
    return Mesh(data=data, rank=int(i), device=dev, group=g_data,
                model=model, seq=seq, model_rank=int(k), seq_rank=int(j),
                model_group=g_model, seq_group=g_seq, replica_group=g_rep)


@dataclass(frozen=True)
class ServingMesh:
    """A (data, model) grid of devices one process serves on:
    ``devices[i][j]`` holds data shard ``i``'s rows and model shard
    ``j``'s parameters."""

    devices: tuple

    @property
    def shape(self) -> dict[str, int]:
        return {AXIS_DATA: len(self.devices),
                AXIS_MODEL: len(self.devices[0])}

    @property
    def primary(self) -> torch.device:
        """Shard 0's device: where replies are joined."""
        return self.devices[0][0]

    def at(self, i: int, j: int) -> "ShardCoord":
        """Data shard ``i``, model shard ``j``: what :func:`shard_leaf`
        reads of a mesh."""
        return ShardCoord(self.shape, {AXIS_DATA: i, AXIS_MODEL: j,
                                       AXIS_SEQ: 0})


@dataclass(frozen=True)
class ShardCoord:
    """One device's place in a serving mesh."""

    shape: dict
    coords: dict

    def coordinate(self, axis: str) -> int:
        return self.coords[axis]


def serving_mesh(data: int, model: int, devices=None) -> ServingMesh:
    """(data, model) mesh for the serving stack (serve/session.py):
    ``data`` shards micro-batch rows and slot pools, ``model`` carries
    tensor-parallel parameter shards. Uses the first ``data·model`` of
    ``devices`` (default: the visible cards), ``model`` varying fastest.
    Axis-size validation against the device count lives with the config
    surface (``serve.session.build_serving_mesh`` raises ConfigError);
    this only guards the raw arithmetic."""
    devs = list(devices if devices is not None
                else [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())])
    need = data * model
    if data < 1 or model < 1 or need > len(devs):
        raise DistributedError(
            f"serving mesh {data}x{model} does not fit {len(devs)} devices")
    devs = [torch.device(d) for d in devs[:need]]
    return ServingMesh(tuple(tuple(devs[i * model:(i + 1) * model])
                             for i in range(data)))


def round_up_multiple(n: int, k: int) -> int:
    """Smallest multiple of ``k`` that is >= ``n``: the one rounding rule
    for the forest's rows, sharded serving's bucket tables and slot
    pools."""
    return -(-int(n) // int(k)) * int(k)


def mesh_desc(mesh) -> str:
    """``"<data>x<model>"``, the JAX package's observability tag (of a
    training or a serving mesh)."""
    return f"{int(mesh.shape[AXIS_DATA])}x{int(mesh.shape[AXIS_MODEL])}"


def replicated(mesh) -> PartitionSpec:
    """The spec of a leaf every rank holds whole."""
    return PartitionSpec()


def batch_sharding(mesh, ndim: int = 2, seq_axis: int | None = None
                   ) -> PartitionSpec:
    """Shard the leading (batch) dim over ``data``; optionally a sequence
    dim over ``seq``; replicate the rest."""
    spec: list[Any] = [None] * ndim
    spec[0] = AXIS_DATA
    if seq_axis is not None:
        spec[seq_axis] = AXIS_SEQ
    return PartitionSpec(*spec)


# -- tensor-parallel placement -------------------------------------------

def _axes(entry) -> tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _flat(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` of a tree of dicts, lists and tuples (paths join
    keys with dots, as ``state_dict`` names do)."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _flat(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                         PartitionSpec):
        return [kv for i, v in enumerate(tree)
                for kv in _flat(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def _rebuild(tree: Any, values) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                         PartitionSpec):
        return type(tree)(_rebuild(v, values) for v in tree)
    return next(values)


def _fits(shape, spec: PartitionSpec, mesh) -> bool:
    """A spec applies only if every sharded dim divides evenly."""
    if len(shape) < len(spec):
        return False
    for dim, entry in zip(shape, spec):
        axes = _axes(entry)
        if not axes:
            continue
        if dim % int(np.prod([mesh.shape[a] for a in axes])):
            return False
    return True


def shard_specs(tree: Any, mesh, rules=()) -> Any:
    """The :class:`PartitionSpec` each leaf of ``tree`` is placed by (the
    tree's structure; ``P()`` for a replicated leaf): the first rule whose
    pattern is a substring of the leaf's path decides; within it, the
    first candidate spec whose sharded dims all divide applies; a leaf no
    candidate fits is replicated with a warning."""
    specs = []
    for name, leaf in _flat(tree):
        shape = tuple(getattr(leaf, "shape", ()))
        chosen = PartitionSpec()
        for pat, cands in rules:
            if pat in name:
                cands = ((cands,) if isinstance(cands, PartitionSpec)
                         else tuple(cands))
                for spec in cands:
                    if _fits(shape, spec, mesh):
                        chosen = spec
                        break
                else:
                    logger.warning(
                        "param %s %s does not divide by any of %s on mesh "
                        "%s; replicating (tensor parallelism disabled for "
                        "this leaf)", name, shape, cands, dict(mesh.shape))
                break
        specs.append(chosen)
    return _rebuild(tree, iter(specs))


def _coord(mesh, axes: tuple[str, ...]) -> tuple[int, int]:
    """(this rank's index, the count) over ``axes`` taken together, the
    first axis major."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coordinate(a)
        n *= mesh.shape[a]
    return idx, n


def shard_leaf(leaf: torch.Tensor, spec: PartitionSpec, mesh
               ) -> torch.Tensor:
    """This rank's contiguous shard of ``leaf`` under ``spec``."""
    out = leaf
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        idx, n = _coord(mesh, axes)
        size = out.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out.contiguous() if out is not leaf else leaf


def shard_params(params: Any, mesh, rules=()) -> Any:
    """Place a parameter tree on the mesh: each rank keeps its own
    contiguous shard of every leaf :func:`shard_specs` shards, and the
    whole of every other. This is the hook tensor parallelism uses to
    shard big weight matrices over ``model``."""
    specs = shard_specs(params, mesh, rules)
    return _rebuild(params, iter(
        shard_leaf(leaf, spec, mesh) if isinstance(leaf, torch.Tensor)
        else leaf
        for (_, leaf), (_, spec) in zip(_flat(params), _flat(specs))))


def model_dims(specs: dict) -> dict:
    """``{name: dim}`` of a flat spec dict: the dim each leaf is split on
    over ``model`` (None: whole). Tensor parallelism splits over
    ``model`` only; a spec naming another axis raises DistributedError."""
    out = {}
    for name, spec in specs.items():
        out[name] = None
        for dim, entry in enumerate(spec):
            axes = _axes(entry)
            if axes and axes != (AXIS_MODEL,):
                raise DistributedError(
                    f"param {name}: spec {spec} splits over {axes}; tensor "
                    f"parallelism splits over {AXIS_MODEL!r} only")
            if axes:
                out[name] = dim
    return out

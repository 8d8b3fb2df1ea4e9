"""The device mesh of a data-parallel process group (the JAX package's
``core/mesh.py``).

There the mesh is a ``jax.sharding.Mesh`` over every device and XLA puts
the collectives in from sharding annotations. Here one process drives one
device, the processes form a ``torch.distributed`` group (NCCL on the
card, gloo on the CPU; ``dist/bootstrap.py``), and the mesh is a small
record of what one rank sees: the ``data`` axis size, its rank, its
device and its group. Only the ``data`` axis is ported: a ``model`` or
``seq`` axis other than 1 is refused with a ConfigError before any device
work.

Devices are counted as the JAX package counts them: on the card, one per
rank of the group; on the CPU, ``EUROMILLIONER_CPU_DEVICES`` (the JAX
CLI's knob) where it is set, else one per rank. A mesh that does not
cover them raises DistributedError, as ``MeshSpec.resolve`` does there.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.utils.errors import ConfigError, DistributedError

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
CPU_DEVICES_ENV = "EUROMILLIONER_CPU_DEVICES"


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


def require_data_only(spec: MeshSpec) -> None:
    """ConfigError (exit 17) for a ``model`` or ``seq`` axis other than 1:
    only data parallelism is ported."""
    for axis, size, what in (
            (AXIS_MODEL, spec.model, "tensor parallelism"),
            (AXIS_SEQ, spec.seq, "sequence parallelism")):
        if size != 1:
            raise ConfigError(
                f"mesh.{axis}={size}: {what} over {axis!r} is not ported "
                f"yet; it comes in the later slice with tensor and sequence "
                f"parallelism, sharded serving and TBPTT under a mesh. This "
                f"port trains data-parallel only (mesh.{AXIS_DATA}=N, "
                f"mesh.{AXIS_MODEL}=1, mesh.{AXIS_SEQ}=1)")


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
    """What one rank of a data-parallel group sees: ``data`` ranks in all,
    this one's ``rank``, its ``device`` and the ``group`` its collectives
    run on (None: the default group)."""

    data: int
    rank: int
    device: torch.device
    group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes in the JAX mesh's order, for the ``device mesh:``
        log line."""
        return {AXIS_DATA: self.data, AXIS_SEQ: 1, AXIS_MODEL: 1}


def build_mesh(spec: MeshSpec | None = None, device=None, group=None) -> Mesh:
    """The mesh of this rank over an initialised process group
    (``dist.bootstrap.initialize``), on ``device`` (the card unless
    ``"cpu"``; on the card the current device, which ``initialize`` set
    to this rank's)."""
    spec = spec or MeshSpec()
    require_data_only(spec)
    dev = resolve_device(device)
    if not torch.distributed.is_initialized():
        raise DistributedError(
            "no process group: call dist.bootstrap.initialize (or run "
            "train --distributed) before building a mesh")
    world = torch.distributed.get_world_size(group)
    n_devices = world
    if dev.type == "cpu":
        n_devices = cpu_device_count() or world
    data, _, _ = spec.resolve(n_devices)
    if data != world:
        raise DistributedError(
            f"mesh data axis {data} does not match the {world} ranks of the "
            f"process group (one rank per device)")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(data=data, rank=torch.distributed.get_rank(group),
                device=dev, group=group)


def round_up_multiple(n: int, k: int) -> int:
    """Smallest multiple of ``k`` that is >= ``n`` (the forest pads its
    rows to a multiple of the data axis by this rule)."""
    return -(-int(n) // int(k)) * int(k)


def mesh_desc(mesh: Mesh) -> str:
    """``"<data>x<model>"``, the JAX package's observability tag."""
    return f"{int(mesh.data)}x1"

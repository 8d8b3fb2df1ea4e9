"""Process-group bootstrap (the JAX package's ``dist/bootstrap.py``).

There ``jax.distributed.initialize`` forms the group and XLA collectives
carry the tensors. Here ``torch.distributed.init_process_group`` does:
one process per device, NCCL on the card and gloo on the CPU, joined at
``tcp://COORDINATOR_ADDRESS``. The same variables name the topology
(``COORDINATOR_ADDRESS`` as ``host:port``, ``NUM_PROCESSES``,
``PROCESS_ID``; ``LOCAL_RANK`` picks the card on a host that runs
several ranks, default ``PROCESS_ID`` modulo the visible cards).

With no coordinator configured it is a no-op, as there. ``auto=True``
(the JAX CLI's ``--auto-coordinator``) reads a TPU pod's metadata, which
a GPU host does not have: it is refused.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.utils.errors import ConfigError, DistributedError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("dist.bootstrap")

# how long a collective may wait for a peer before the group fails it
DEFAULT_TIMEOUT_S = 600.0


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, auto: bool = False,
               device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group (idempotent).

    Explicit arguments win; otherwise ``COORDINATOR_ADDRESS`` /
    ``NUM_PROCESSES`` / ``PROCESS_ID`` from the environment. With neither,
    a no-op (single-process run). ``device`` (the card unless ``"cpu"``)
    picks the backend: NCCL on ``cuda``, after ``torch.cuda.set_device``
    of this rank's card and before anything is allocated there; gloo on
    the CPU."""
    if auto:
        raise ConfigError(
            "--auto-coordinator reads TPU pod metadata, which a GPU host "
            "does not have; set COORDINATOR_ADDRESS, NUM_PROCESSES and "
            "PROCESS_ID (train --distributed starts one rank per local "
            "device when none is set)")
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise DistributedError(
                "num_processes/process_id given without a coordinator "
                "address — explicit topology needs coordinator_address (or "
                "COORDINATOR_ADDRESS in the env)")
        logger.debug("no coordinator configured; single-process run")
        return
    num = num_processes if num_processes is not None else _env_int(
        "NUM_PROCESSES")
    pid = process_id if process_id is not None else _env_int("PROCESS_ID")
    if num is None or pid is None:
        raise DistributedError(
            f"coordinator {coordinator_address} given without "
            f"NUM_PROCESSES/PROCESS_ID: the group needs its size and this "
            f"process's rank")
    if not 0 <= pid < num:
        raise DistributedError(f"PROCESS_ID {pid} outside [0, {num})")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(pid % torch.cuda.device_count()
                              if local is None else local)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num, rank=pid, timeout=timedelta(seconds=timeout_s))
    except (RuntimeError, ValueError) as e:
        raise DistributedError(
            f"torch.distributed.init_process_group failed: {e}") from e
    (logger.info if pid == 0 else logger.debug)(
        "joined process group: process %d/%d over %s (%s)", pid, num,
        backend, _device_name(dev))


def shutdown() -> None:
    """Leave the process group (no-op when none is initialised)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.current_device()}"
    return "cpu"


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (rank 0, or
    a process outside any group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclass(frozen=True)
class RuntimeInfo:
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int
    platform: str


def runtime_info() -> RuntimeInfo:
    """This process's place in the group: one device per process, so the
    global device count is the group's size."""
    if dist.is_initialized():
        index, count = dist.get_rank(), dist.get_world_size()
        platform = "gpu" if dist.get_backend() == "nccl" else "cpu"
    else:
        index, count = 0, 1
        platform = "gpu" if torch.cuda.is_available() else "cpu"
    return RuntimeInfo(process_index=index, process_count=count,
                       local_device_count=1, global_device_count=count,
                       platform=platform)

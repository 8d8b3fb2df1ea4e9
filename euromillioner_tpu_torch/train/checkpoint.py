"""Checkpoints in the JAX package's on-disk format.

A checkpoint is a directory ``step_{step:08d}/`` holding
``arrays-00000.emt`` (EMT1, one entry ``leaf_{i:06d}`` per leaf) and
``manifest.json`` with ``step``, ``num_leaves``, ``num_processes``,
``leaf_paths`` (jax keystr of each leaf, in flatten order) and per-array
crc32 ``checksums``. Leaves are in jax's flatten order: the TrainState's
fields in order (``.params``, ``.opt_state``, ``.step``), dict keys sorted
at every level — ``.params['0_LSTM']['bias']``, ...,
``.opt_state['count']``, ``.opt_state['mu'][...]``,
``.opt_state['nu'][...]``, ``.step``. Restore needs no jax treedef:
:func:`load_checkpoint` takes the leaves under ``.params`` by their
``leaf_paths`` (serving), and :func:`load_train_state` restores a whole
TrainState — optimizer state included — into the structure of a ``like``
state, so either package resumes the other's training.

Saves keep the JAX package's multi-process protocol: in a
``torch.distributed`` group every rank holds the whole (replicated)
state, writes its own ``arrays-{rank}.emt`` and a ``checksums-{rank}.json``
sidecar into ``step_{step:08d}.tmp``; after a barrier rank 0 merges the
sidecars into the manifest (``num_processes`` = the group's size),
removes them and renames the directory into place, so it is visible only
once complete. Loading verifies every shard the manifest names and reads
this rank's (shard 0 where the checkpoint has fewer).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any, Callable, Mapping

import torch

from euromillioner_tpu_torch.resilience import fault_point
from euromillioner_tpu_torch.utils import serialization
from euromillioner_tpu_torch.utils.errors import CheckpointError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("train.checkpoint")

_MANIFEST = "manifest.json"
_ARRAYS = "arrays-{proc:05d}.emt"
_CHECKSUMS = "checksums-{proc:05d}.json"
_KEY = re.compile(r"\['([^']*)'\]")


def _crc(value) -> int:
    _code, arr = serialization.host_array(value)
    return zlib.crc32(arr.tobytes()) & 0xFFFFFFFF


def _map_tree(prefix: str, tree: Any, fn: Callable[[str, Any], Any]) -> Any:
    """Apply ``fn(keystr, leaf)`` to every leaf of ``tree`` (dicts, whose
    dotted keys are paths — ``"0_LSTM.wx"`` → ``['0_LSTM']['wx']`` — and
    tuples), keeping its structure."""
    if isinstance(tree, Mapping):
        return {k: _map_tree(prefix + "".join(f"['{p}']" for p in k.split(".")),
                             v, fn)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map_tree(f"{prefix}[{i}]", v, fn)
                     for i, v in enumerate(tree))
    return fn(prefix, tree)


def _section(prefix: str, tree: Any) -> list[tuple[str, Any]]:
    """``(keystr, leaf)`` of one TrainState field in jax's order: dict keys
    sorted at every level, i.e. by the key path."""
    pairs: list[tuple[str, Any]] = []
    _map_tree(prefix, tree, lambda k, v: pairs.append((k, v)))
    return sorted(pairs, key=lambda kv: _KEY.findall(kv[0]))


def _state_leaves(state) -> list[tuple[str, Any]]:
    return (_section(".params", state.params)
            + _section(".opt_state", state.opt_state)
            + [(".step", state.step)])


def _state_path(keystr: str) -> str | None:
    """``".params['0_LSTM']['wx']"`` → ``"0_LSTM.wx"``; None for leaves
    outside params."""
    if not keystr.startswith(".params["):
        return None
    return ".".join(_KEY.findall(keystr[len(".params"):]))


def _process(group=None) -> tuple[int, int]:
    """(this process's rank in ``group``, its size; None: the default
    group); (0, 1) outside a group."""
    if torch.distributed.is_initialized():
        return (torch.distributed.get_rank(group),
                torch.distributed.get_world_size(group))
    return 0, 1


def save_checkpoint(directory: str, state, *, step: int, group=None) -> str:
    """Write ``directory/step_{step:08d}/`` (every rank of ``group``, the
    default process group when None, calls it). ``state`` is a full
    ``TrainState`` (params, optimizer state, step counter) or, for a
    serving checkpoint, a module or ``state_dict`` (params, then ``step``
    as the ``.step`` leaf)."""
    if isinstance(state, (torch.nn.Module, Mapping)):
        flat = state.state_dict() if isinstance(state, torch.nn.Module) else state
        pairs = (_section(".params", flat)
                 + [(".step", torch.tensor(step, dtype=torch.int32))])
    else:
        pairs = _state_leaves(state)
    paths = [k for k, _ in pairs]
    arrays = {f"leaf_{i:06d}": t.detach().cpu()
              for i, (_, t) in enumerate(pairs)}
    target = os.path.join(directory, f"step_{step:08d}")
    tmp = target + ".tmp"
    proc, nproc = _process(group)

    def barrier():
        if nproc > 1:
            torch.distributed.barrier(group)

    if proc == 0:
        os.makedirs(tmp, exist_ok=True)
    barrier()
    fault_point("checkpoint.save.write", step=step, path=tmp, process=proc)
    serialization.save(os.path.join(tmp, _ARRAYS.format(proc=proc)), arrays)
    with open(os.path.join(tmp, _CHECKSUMS.format(proc=proc)), "w") as fh:
        json.dump({k: _crc(v) for k, v in arrays.items()}, fh)
    barrier()
    if proc == 0:
        sums = {}
        for p in range(nproc):
            sidecar = os.path.join(tmp, _CHECKSUMS.format(proc=p))
            with open(sidecar) as fh:
                sums[f"{p:05d}"] = json.load(fh)
            os.remove(sidecar)
        manifest = {
            "step": step,
            "num_leaves": len(arrays),
            "num_processes": nproc,
            "leaf_paths": paths,
            "checksums": sums,
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as fh:
            json.dump(manifest, fh)
        if os.path.isdir(target):
            shutil.rmtree(target)
        os.replace(tmp, target)
    barrier()
    logger.info("saved checkpoint %s (%d leaves)", target, len(arrays))
    fault_point("checkpoint.save.post", step=step, path=target, process=proc)
    return target


def _read_manifest(path: str) -> dict:
    manifest_path = os.path.join(path, _MANIFEST)
    if not os.path.exists(manifest_path):
        raise CheckpointError(f"no manifest at {path}")
    try:
        with open(manifest_path) as fh:
            return json.load(fh)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"unreadable manifest at {path}: {e}") from e


def checkpoint_step(path: str) -> int:
    return int(_read_manifest(path)["step"])


def _load_shard(path: str, manifest: dict, proc: int
                ) -> dict[str, torch.Tensor]:
    """Load and integrity-check one process's shard; CheckpointError on
    truncation, container corruption, count or checksum mismatch."""
    shard = os.path.join(path, _ARRAYS.format(proc=proc))
    try:
        arrays = serialization.load(shard)
    except OSError as e:
        raise CheckpointError(f"unreadable checkpoint shard {shard}: {e}") from e
    if len(arrays) != int(manifest["num_leaves"]):
        raise CheckpointError(
            f"checkpoint has {len(arrays)} leaves, manifest expects "
            f"{manifest['num_leaves']}")
    sums = manifest.get("checksums", {}).get(f"{proc:05d}")
    if sums is not None:  # absent on pre-integrity checkpoints
        for key, arr in arrays.items():
            want = sums.get(key)
            got = _crc(arr)
            if want is None or int(want) != got:
                raise CheckpointError(
                    f"checksum mismatch for {key} in {shard}: "
                    f"manifest {want} != data {got}")
    return arrays


def _verified_own_shard(path: str, manifest: dict, group=None
                        ) -> dict[str, torch.Tensor]:
    """Every shard the manifest names, integrity-checked; returns this
    rank's in ``group`` (shard 0 when the checkpoint has fewer shards than
    the group has ranks: every shard holds the whole state)."""
    nproc = int(manifest.get("num_processes", 1))
    own = _process(group)[0]
    own = own if own < nproc else 0
    for proc in range(nproc):
        if proc != own:
            _load_shard(path, manifest, proc)
    return _load_shard(path, manifest, own)


def verify_checkpoint(path: str) -> bool:
    """True when ``path`` restores: manifest readable and every shard it
    names loads with matching per-array checksums."""
    try:
        manifest = _read_manifest(path)
        for proc in range(int(manifest.get("num_processes", 1))):
            _load_shard(path, manifest, proc)
        return True
    except CheckpointError:
        return False


def latest_checkpoint(directory: str, *, verify: bool = True) -> str | None:
    """Newest intact checkpoint directory, or None; corrupt or partial
    candidates are skipped with a warning."""
    if not os.path.isdir(directory):
        return None
    steps = sorted((d for d in os.listdir(directory)
                    if d.startswith("step_") and not d.endswith(".tmp")),
                   reverse=True)
    for name in steps:
        path = os.path.join(directory, name)
        if not verify or verify_checkpoint(path):
            return path
        logger.warning("skipping corrupt/incomplete checkpoint %s", path)
    return None


def load_checkpoint(path: str, group=None) -> dict[str, torch.Tensor]:
    """The params of the checkpoint at ``path`` as a CPU ``state_dict``
    (``"0_LSTM.wx"`` keys), integrity-checked; this rank's shard in
    ``group`` (None: the default group). Works on checkpoints of either
    package: leaves outside ``.params`` are skipped."""
    fault_point("checkpoint.load", path=path)
    manifest = _read_manifest(path)
    paths = manifest.get("leaf_paths")
    if paths is None:
        raise CheckpointError(f"checkpoint {path} has no leaf_paths")
    arrays = _verified_own_shard(path, manifest, group)
    if len(paths) != len(arrays):
        raise CheckpointError(
            f"manifest names {len(paths)} leaf paths for {len(arrays)} "
            f"leaves")
    params = {}
    for i, keystr in enumerate(paths):
        state_path = _state_path(keystr)
        if state_path is not None:
            params[state_path] = arrays[f"leaf_{i:06d}"]
    if not params:
        raise CheckpointError(f"checkpoint {path} holds no .params leaves")
    logger.info("restored checkpoint %s (step %d)", path, manifest["step"])
    return params


def load_train_state(path: str, like, group=None):
    """Restore the whole TrainState of the checkpoint at ``path`` (either
    package's) into the structure of ``like`` (an initialised
    ``TrainState``): the leaf paths must match ``like``'s exactly, and each
    leaf takes ``like``'s shape, dtype and device. This rank's shard in
    ``group`` is read (None: the default group)."""
    fault_point("checkpoint.load", path=path)
    manifest = _read_manifest(path)
    arrays = _verified_own_shard(path, manifest, group)
    want = _state_leaves(like)
    saved = manifest.get("leaf_paths")
    paths = [k for k, _ in want]
    if saved != paths:
        diff = [(s, w) for s, w in zip(saved or [], paths) if s != w]
        raise CheckpointError(
            f"checkpoint {path} does not hold this TrainState "
            f"({len(saved or [])} leaves for {len(paths)}; first "
            f"difference: {diff[0] if diff else 'length'})")
    values = {}
    for i, (key, leaf) in enumerate(want):
        arr = arrays[f"leaf_{i:06d}"]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise CheckpointError(f"{key}: shape {tuple(arr.shape)} != "
                                  f"expected {tuple(leaf.shape)}")
        values[key] = arr.to(device=leaf.device, dtype=leaf.dtype)
    logger.info("restored train state %s (step %d)", path, manifest["step"])
    return type(like)(
        params=_map_tree(".params", like.params, lambda k, _: values[k]),
        opt_state=_map_tree(".opt_state", like.opt_state,
                            lambda k, _: values[k]),
        step=values[".step"])

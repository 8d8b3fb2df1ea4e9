"""Checkpoints in the JAX package's on-disk format.

A checkpoint is a directory ``step_{step:08d}/`` holding
``arrays-00000.emt`` (EMT1, one entry ``leaf_{i:06d}`` per leaf) and
``manifest.json`` with ``step``, ``num_leaves``, ``num_processes``,
``leaf_paths`` (jax keystr of each leaf, in flatten order) and per-array
crc32 ``checksums``. Restore needs no jax treedef: the port takes the
leaves under ``.params`` by their ``leaf_paths`` — so it restores the
parameters of a checkpoint the JAX package wrote (a full TrainState:
params, optimizer state, step). The port's own :func:`save_checkpoint`
writes params and step, single-process, visible only once complete
(written into ``.tmp`` and renamed).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Mapping

import torch

from euromillioner_tpu_torch.utils import serialization
from euromillioner_tpu_torch.utils.errors import CheckpointError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("train.checkpoint")

_MANIFEST = "manifest.json"
_ARRAYS = "arrays-{proc:05d}.emt"
_KEY = re.compile(r"\['([^']*)'\]")


def _crc(value) -> int:
    _code, arr = serialization.host_array(value)
    return zlib.crc32(arr.tobytes()) & 0xFFFFFFFF


def _keystr(path: str) -> str:
    """``"0_LSTM.wx"`` → jax's keystr ``".params['0_LSTM']['wx']"``."""
    return ".params" + "".join(f"['{p}']" for p in path.split("."))


def _state_path(keystr: str) -> str | None:
    """The inverse of :func:`_keystr`; None for leaves outside params."""
    if not keystr.startswith(".params["):
        return None
    return ".".join(_KEY.findall(keystr[len(".params"):]))


def save_checkpoint(directory: str, params: torch.nn.Module
                    | Mapping[str, torch.Tensor], *, step: int) -> str:
    """Write ``directory/step_{step:08d}/`` with the params (a module or
    a ``state_dict``) and the step, in jax's leaf order (dict keys
    sorted at every level)."""
    flat = params.state_dict() if isinstance(params, torch.nn.Module) else params
    keystrs = {_keystr(path): t for path, t in flat.items()}
    # jax flattens dicts in sorted-key order at each level: sort by the
    # key tuple, then the TrainState's trailing .step leaf
    order = sorted(keystrs, key=lambda k: _KEY.findall(k))
    leaves = [keystrs[k].detach().cpu() for k in order]
    leaves.append(torch.tensor(step, dtype=torch.int32))
    paths = order + [".step"]
    arrays = {f"leaf_{i:06d}": t for i, t in enumerate(leaves)}
    target = os.path.join(directory, f"step_{step:08d}")
    tmp = target + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    serialization.save(os.path.join(tmp, _ARRAYS.format(proc=0)), arrays)
    manifest = {
        "step": step,
        "num_leaves": len(arrays),
        "num_processes": 1,
        "leaf_paths": paths,
        "checksums": {"00000": {k: _crc(v) for k, v in arrays.items()}},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as fh:
        json.dump(manifest, fh)
    if os.path.isdir(target):
        shutil.rmtree(target)
    os.replace(tmp, target)
    logger.info("saved checkpoint %s (%d leaves)", target, len(arrays))
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


def load_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """The params of the checkpoint at ``path`` as a CPU ``state_dict``
    (``"0_LSTM.wx"`` keys), integrity-checked. Works on checkpoints of
    either package: leaves outside ``.params`` are skipped."""
    manifest = _read_manifest(path)
    paths = manifest.get("leaf_paths")
    if paths is None:
        raise CheckpointError(f"checkpoint {path} has no leaf_paths")
    arrays = _load_shard(path, manifest, 0)
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

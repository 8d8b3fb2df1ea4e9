"""Model export: a trained forward as a self-contained program (the JAX
package's ``core/export.py``).

The reference stack's deployment story is a serialized model executed by a
native runtime — xgboost4j's ``Booster.saveModel`` → libxgboost, and
DL4J's ``ModelSerializer`` → libnd4j. Here ``torch.export`` records the
forward (under ``no_grad``, so the LSTM's K1 is the opaque
``emtpu::lstm_sequence`` call and Wide&Deep's K4a ``emtpu::wide_onehot_fwd``)
with the parameters as the program's constants, written next to a JSON
manifest of input/output specs. The program runs from EITHER runtime:

- ``torch``: :func:`load_exported` + ``torch.export.load`` — the program
  run by torch in this process (the JAX package's ``jax`` runtime; the
  port has no JAX).
- ``native``: the program compiled ONCE by AOTInductor into a package
  (``serve/aotstore.compile_program``), cached in the export directory
  under a key of the environment, and run by the C++ runner
  (``core/native_runner``) — no Python in the process that computes, K1
  and K4a launched from the runner's own C++ registration.

A program is exported for one device (its constants live there): it runs
on that device only, and a runner on another one is refused by name.

Layout of an export directory::

    <dir>/program.pt2                 the saved ExportedProgram
    <dir>/manifest.json               {in_specs, out_specs, meta, device}
    <dir>/native/program-<key>.pt2    AOTInductor packages, by environment
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.utils.errors import EuromillionerError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("core.export")

_PROGRAM_FILE = "program.pt2"
_MANIFEST_FILE = "manifest.json"
_NATIVE_DIR = "native"

RUNTIMES = ("torch", "native")


class ExportError(EuromillionerError):
    exit_code = 17


class ModelForward(torch.nn.Module):
    """A model's inference forward as ``export`` writes it (the JAX CLI's
    ``cmd_export`` function): the input cast to the compute dtype unless the
    model converts its own inputs (``cast_inputs = False``, Wide&Deep's id
    lookups), the output cast to float32."""

    def __init__(self, model: torch.nn.Module, compute_dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if getattr(self.model, "cast_inputs", True):
            x = x.to(self.compute_dtype)
        return self.model(x).to(torch.float32)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def exported_program(fn_or_module, example_args):
    """``torch.export`` of ``fn_or_module`` at ``example_args`` under
    ``no_grad`` (non-strict, as the AOT store exports); the tensors a
    function closes over become the program's constants."""
    from euromillioner_tpu_torch.serve.aotstore import _Program

    module = (fn_or_module if isinstance(fn_or_module, torch.nn.Module)
              else _Program(fn_or_module))
    args = tuple(_as_tensor(a) for a in example_args)
    with torch.inference_mode(False), torch.no_grad():
        return torch.export.export(module, args, strict=False)


def out_specs(ep) -> list:
    """``[[shape], dtype]`` of each of the program's outputs."""
    out = next(n for n in ep.graph.nodes if n.op == "output")
    return [[list(a.meta["val"].shape), _dtype_name(a.meta["val"].dtype)]
            for a in out.args[0]]


def export_model(fn_or_module, example_args, out_dir: str,
                 meta: dict | None = None) -> str:
    """Export ``fn_or_module(*example_args)`` to ``out_dir``: the program
    (its parameters, or the tensors a function closes over, as constants)
    and the manifest. The program runs on the example args' device.
    Returns ``out_dir``."""
    args = tuple(_as_tensor(a) for a in example_args)
    ep = exported_program(fn_or_module, args)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(ep, os.path.join(out_dir, _PROGRAM_FILE))
    manifest = {
        "in_specs": [[list(a.shape), _dtype_name(a.dtype)] for a in args],
        "out_specs": out_specs(ep),
        "meta": meta or {},
        "device": args[0].device.type if args else "cpu",
    }
    with open(os.path.join(out_dir, _MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=1)
    logger.info("exported model to %s (%d outputs)", out_dir,
                len(manifest["out_specs"]))
    return out_dir


def load_exported(out_dir: str) -> tuple[bytes, dict]:
    """Read back ``(the saved program's bytes, manifest)``."""
    prog = os.path.join(out_dir, _PROGRAM_FILE)
    man = os.path.join(out_dir, _MANIFEST_FILE)
    if not (os.path.exists(prog) and os.path.exists(man)):
        raise ExportError(f"{out_dir} is not an export dir "
                          f"(need {_PROGRAM_FILE} + {_MANIFEST_FILE})")
    with open(prog, "rb") as f:
        code = f.read()
    with open(man) as f:
        manifest = json.load(f)
    return code, manifest


def _load_program(out_dir: str):
    """The saved program as a module; the custom ops it may call are
    registered first."""
    import euromillioner_tpu_torch.ops  # noqa: F401

    return torch.export.load(os.path.join(out_dir, _PROGRAM_FILE)).module()


def native_package(out_dir: str, device=None) -> tuple[Path, float | None]:
    """The AOTInductor package of ``out_dir``'s program for ``device`` (the
    card unless ``"cpu"``): compiled once and kept under ``native/``, keyed
    on the program's bytes and the environment
    (``serve/aotstore.env_signature``), with concurrent compiles locked out.
    Returns ``(path, seconds it took to compile)`` — None for seconds when
    a finished package was found."""
    from euromillioner_tpu_torch.serve.aotstore import (compile_program,
                                                        env_signature)

    dev = resolve_device(device)
    code, manifest = load_exported(out_dir)
    _check_device(out_dir, manifest, dev)
    env = json.dumps(env_signature(dev, "aoti"), sort_keys=True)
    key = hashlib.sha256(code + env.encode()).hexdigest()[:16]
    native = Path(out_dir) / _NATIVE_DIR
    native.mkdir(exist_ok=True)
    path = native / f"program-{key}.pt2"
    with open(native / f"program-{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return path, None
        t0 = time.perf_counter()
        module = _load_program(out_dir)
        args = tuple(torch.zeros(shape, dtype=getattr(torch, dt), device=dev)
                     for shape, dt in manifest["in_specs"])
        payload = compile_program(module, args, "aoti")
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_bytes(payload)
        os.replace(tmp, path)
        seconds = time.perf_counter() - t0
        logger.info("compiled %s for %s in %.1f s (%.1f MB)", path.name,
                    dev.type, seconds, len(payload) / 2**20)
        return path, seconds


def _check_device(out_dir: str, manifest: dict, dev: torch.device) -> None:
    made_for = manifest.get("device", "cpu")
    if made_for != dev.type:
        raise ExportError(f"{out_dir} was exported for {made_for}; it "
                          f"cannot run on {dev.type} (export it again with "
                          f"--device {dev.type})")


class ExportedRunner:
    """A loaded export, callable per batch.

    ``runtime="torch"`` runs the saved program through torch in this
    process; ``runtime="native"`` compiles it once into an AOTInductor
    package (:func:`native_package`; a second runner on the same directory
    compiles nothing) and runs that in the C++ runner
    (``core/native_runner``), the libnd4j-equivalent boundary. The device
    is the card unless ``device="cpu"``; it must be the one the program was
    exported for. Use as a context manager (native holds a child
    process)."""

    def __init__(self, out_dir: str, runtime: str = "torch", device=None):
        if runtime not in RUNTIMES:
            raise ExportError(f"runtime must be torch|native, got "
                              f"{runtime!r}")
        self.runtime = runtime
        self.device = resolve_device(device)
        code, self.manifest = load_exported(out_dir)
        _check_device(out_dir, self.manifest, self.device)
        self.runner = None  # the native runtime's NativeRunner
        self.compile_s = None
        if runtime == "torch":
            self._fn = _load_program(out_dir)
            return
        from euromillioner_tpu_torch.core.native_runner import NativeRunner

        self.package, self.compile_s = native_package(out_dir, self.device)
        self.runner = NativeRunner(self.package, self.device)

    def __call__(self, *args) -> list[np.ndarray]:
        specs = self.manifest["in_specs"]
        got = [[list(a.shape), _dtype_name(_as_tensor(a).dtype)]
               for a in args]
        if got != specs:
            raise ExportError(f"the program takes {specs}, got {got}")
        if self.runtime == "native":
            if self.runner is None:
                raise ExportError("the runner is closed")
            return self.runner.execute([np.ascontiguousarray(
                a.cpu().numpy() if isinstance(a, torch.Tensor) else a)
                for a in args])
        with torch.inference_mode(False), torch.no_grad():
            out = self._fn(*(_as_tensor(a).to(self.device) for a in args))
        out = out if isinstance(out, (list, tuple)) else [out]
        return [o.cpu().numpy() for o in out]

    def close(self) -> None:
        if self.runner is not None:
            self.runner.close()
            self.runner = None

    def __enter__(self) -> "ExportedRunner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_torch(out_dir: str, *args, device=None) -> list[np.ndarray]:
    """One-shot convenience: execute through torch in this process."""
    with ExportedRunner(out_dir, "torch", device) as r:
        return r(*args)


def run_native(out_dir: str, *args, device=None) -> list[np.ndarray]:
    """One-shot convenience: execute through the C++ runner."""
    with ExportedRunner(out_dir, "native", device) as r:
        return r(*args)

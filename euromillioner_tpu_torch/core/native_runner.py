"""The native runner (``csrc/aoti_runner.cpp``): an AOTInductor package run
by an executable with no Python in its process — the JAX package's
``core/pjrt_runner.py`` and ``native/pjrt_runner.cpp`` in the port.

The runner is built at first use by :func:`ensure_built` from
``csrc/aoti_runner.cpp`` and ``csrc/emtpu_ops.cpp`` with the host's C++
compiler (``$CXX``, else ``g++``) against the installed torch's own headers
and libraries — no ``nvcc``: with a CUDA torch it adds the CUDA headers and
links ``torch_cuda``, ``c10_cuda`` and the CUDA runtime torch loads, and
the kernels come in at run time from the libraries ``ops/common.
build_library`` builds (``build/torch_kernels/``), so the runner and a
Python process launch the same binaries. The executable goes to
``build/torch_runner/`` at the repo root, keyed on the sources, the flags,
the compiler and torch's version, under a file lock so concurrent
processes build once.

Inside the runner, ``csrc/emtpu_ops.cpp`` registers ``emtpu::lstm_sequence``
(K1) and ``emtpu::wide_onehot_fwd`` (K4a) with ``TORCH_LIBRARY``: a CPU
implementation (the plain version in ATen) and, in a CUDA build, a CUDA one
that computes the Python wrapper's launch plan (``csrc/plans.h``) and
launches the kernel on the current stream, counting its launches. It is an
executable, not a library loaded here, because a Python process that
imported the port already holds Python definitions of those ops.

:class:`NativeRunner` starts one runner child per package and device and
speaks the runner's binary protocol over its stdin and stdout (described in
``csrc/aoti_runner.cpp``): an ABI-version handshake, ``execute`` with
float32 and int32 arrays, and ``stats`` (the load time and each op's
launches). Every read has a timeout; the child is killed and reaped on
close and on any error. A runner that cannot be built, started or that
refuses a launch raises :class:`NativeRunnerError` (exit 16): nothing falls
back to Python.

No counterpart by design: the port loads no PJRT plugin, so the reference's
``find_plugin``, ``plugin_create_options``, ``_serialize_options`` and the
plugin's tunnel probe (``plugin_responsive``, ``reset_probe_cache``) have
none.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import select
import shutil
import struct
import subprocess
import tempfile
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.utils.errors import EuromillionerError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("core.native_runner")

ROOT = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("aoti_runner.cpp", "emtpu_ops.cpp")
HEADERS = ("emtpu_ops.h", "plans.h")
BUILD_DIR = ROOT / "build" / "torch_runner"
NAME = "emtpu_aoti_runner"

# Must match kAbiVersion in csrc/aoti_runner.cpp.
_ABI_VERSION = 1
_MAGIC = 0x52544D45  # "EMTR"
_EXECUTE, _STATS = 1, 2

_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.int32): 1}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}

# the kernel libraries a CUDA runner loads (ops/common.build_library)
KERNEL_SOURCES = ("fused_lstm.cu", "wide_onehot.cu")
# seconds a read of the runner's reply may wait
READ_TIMEOUT_S = 600.0


class NativeRunnerError(EuromillionerError):
    exit_code = 16


def _compiler() -> str:
    name = os.environ.get("CXX") or "g++"
    found = shutil.which(name)
    if found is None:
        raise NativeRunnerError(
            f"no C++ compiler {name!r} (set $CXX): the native runner is "
            f"built from csrc/ at first use")
    return found


def _cuda_home() -> Path:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "include" / "cuda_runtime_api.h").is_file():
            return Path(cand)
    raise NativeRunnerError(
        "torch is built for CUDA but no CUDA headers were found "
        "($CUDA_HOME, $CUDA_PATH, /usr/local/cuda)")


def _cudart_flags() -> list[str]:
    """Link the CUDA runtime torch itself loads (a wheel's
    ``nvidia/cuda_runtime/lib``) so the process holds one copy; else the
    toolkit's."""
    lib = Path(torch.__file__).resolve().parents[1] / "nvidia" / \
        "cuda_runtime" / "lib"
    found = sorted(lib.glob("libcudart.so.*")) if lib.is_dir() else []
    if found:
        return [f"-L{lib}", f"-l:{found[0].name}", f"-Wl,-rpath,{lib}"]
    lib64 = _cuda_home() / "lib64"
    return [f"-L{lib64}", "-lcudart", f"-Wl,-rpath,{lib64}"]


def build_flags() -> list[str]:
    """The compiler's flags around the sources: torch's headers and ABI,
    and (with a CUDA torch) ``EMTPU_WITH_CUDA`` and the CUDA headers; then
    the libraries, ``--no-as-needed`` so torch_cuda's AOTInductor CUDA
    runner registers itself though no symbol of it is named."""
    tdir = Path(torch.__file__).resolve().parent
    flags = ["-std=c++17", "-O2", "-pthread",
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             f"-I{tdir / 'include'}",
             f"-I{tdir / 'include' / 'torch' / 'csrc' / 'api' / 'include'}"]
    libs = [f"-L{tdir / 'lib'}", f"-Wl,-rpath,{tdir / 'lib'}",
            "-Wl,--no-as-needed", "-ltorch", "-ltorch_cpu", "-lc10"]
    if torch.version.cuda:
        flags += ["-DEMTPU_WITH_CUDA", f"-I{_cuda_home() / 'include'}"]
        libs += ["-ltorch_cuda", "-lc10_cuda", *_cudart_flags()]
    return flags + libs + ["-ldl"]


def _key(cxx: str, flags: list[str]) -> str:
    h = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join([cxx, *flags, torch.__version__]).encode())
    return h.hexdigest()[:16]


def ensure_built(build_dir: Path | None = None) -> Path:
    """The runner executable, built from ``csrc/`` if no build with the
    same sources, flags, compiler and torch exists; raises
    :class:`NativeRunnerError` when it cannot be built."""
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    cxx = _compiler()
    flags = build_flags()
    out = build_dir / f"{NAME}-{_key(cxx, flags)}"
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / f"{NAME}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        srcs = [str(CSRC / s) for s in SOURCES]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([cxx, *srcs, "-o", str(tmp), *flags],
                                  capture_output=True, text=True,
                                  timeout=1800)
        except (OSError, subprocess.SubprocessError) as e:
            raise NativeRunnerError(f"building {NAME} failed: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeRunnerError(
                f"building {NAME} failed ({proc.returncode}):\n"
                f"{(proc.stdout + proc.stderr)[-4000:]}")
        os.replace(tmp, out)
        logger.info("built %s in %.1f s", out.name, time.perf_counter() - t0)
        return out


def runner_path(build_dir: Path | None = None) -> Path | None:
    """The finished build for this environment, or None."""
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    try:
        out = build_dir / f"{NAME}-{_key(_compiler(), build_flags())}"
    except NativeRunnerError:
        return None
    return out if out.exists() else None


def runner_abi(exe: Path) -> int:
    """The ABI version an executable reports (0: it reports none)."""
    try:
        done = subprocess.run([str(exe), "--abi-version"], capture_output=True,
                              text=True, timeout=60)
        return int(done.stdout.strip()) if done.returncode == 0 else 0
    except (OSError, subprocess.SubprocessError, ValueError):
        return 0


def available(build: bool = False) -> bool:
    """Whether a runner of this ABI is at hand (built first if ``build``)."""
    try:
        exe = ensure_built() if build else runner_path()
    except NativeRunnerError as e:
        logger.warning("%s", e)
        return False
    return exe is not None and runner_abi(exe) == _ABI_VERSION


def package_device(package) -> str:
    """The device type an AOTInductor package was compiled for, from its
    metadata; raises :class:`NativeRunnerError` when it has none."""
    try:
        with zipfile.ZipFile(package) as z:
            for name in z.namelist():
                if ("aotinductor" in name
                        and name.endswith("_metadata.json")):
                    return json.loads(z.read(name))["AOTI_DEVICE_KEY"]
    except (OSError, zipfile.BadZipFile, KeyError, ValueError) as e:
        raise NativeRunnerError(f"{package} is not an AOTInductor package: "
                                f"{e}") from e
    raise NativeRunnerError(f"{package} is not an AOTInductor package "
                            f"(no metadata)")


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.current_device() if dev.index is None else dev.index}"
    return "cpu"


class NativeRunner:
    """One runner child serving one package on one device (the card
    unless ``device="cpu"``).

    Usage::

        with NativeRunner(package, "cpu") as rt:
            outs = rt.execute([x])          # list of numpy arrays
            rt.launch_counts()              # {"lstm_sequence": n, ...}
    """

    def __init__(self, package, device=None, *, runner: Path | None = None,
                 timeout_s: float = READ_TIMEOUT_S):
        self.package = str(package)
        self.timeout_s = timeout_s
        self._proc = None
        self._stderr = None
        dev = resolve_device(device)
        self.device = _device_name(dev)
        made_for = package_device(self.package)
        if made_for != dev.type:
            raise NativeRunnerError(
                f"{self.package} was compiled for {made_for}; it cannot run "
                f"on {self.device}")
        exe = Path(runner) if runner is not None else ensure_built()
        abi = runner_abi(exe)
        if abi != _ABI_VERSION:
            raise NativeRunnerError(
                f"{exe} reports ABI v{abi} != expected v{_ABI_VERSION}: a "
                f"stale build — remove it and let ensure_built() rebuild")
        argv = [str(exe), self.package, self.device]
        if dev.type == "cuda":
            from euromillioner_tpu_torch.ops.common import build_library

            for src in KERNEL_SOURCES:
                argv += ["--kernel", f"{src}={build_library(src)[0]}"]
        self._stderr = tempfile.TemporaryFile()
        try:
            self._proc = subprocess.Popen(argv, stdin=subprocess.PIPE,
                                          stdout=subprocess.PIPE,
                                          stderr=self._stderr, bufsize=0)
        except OSError as e:
            self.close()
            raise NativeRunnerError(f"cannot start {exe}: {e}") from e
        try:
            self._ready()
        except BaseException:
            self.close()
            raise

    # -- the protocol -----------------------------------------------------
    def _fail(self, what: str) -> NativeRunnerError:
        """Kill the child and the error to raise, with its stderr's tail."""
        proc = self._proc
        tail = ""
        if proc is not None:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            what += f" (exit code {proc.returncode})"
            self._stderr.seek(0)
            tail = self._stderr.read()[-2000:].decode(errors="replace")
        self.close()
        return NativeRunnerError(what + (f":\n{tail}" if tail.strip() else ""))

    def _read(self, n: int) -> bytes:
        if self._proc is None:
            raise NativeRunnerError("the runner is closed")
        fd = self._proc.stdout.fileno()
        buf = bytearray()
        deadline = time.monotonic() + self.timeout_s
        while len(buf) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise self._fail(f"the runner sent no reply within "
                                 f"{self.timeout_s:.0f} s")
            ready, _, _ = select.select([fd], [], [], left)
            if not ready:
                continue
            chunk = os.read(fd, min(n - len(buf), 1 << 24))
            if not chunk:
                raise self._fail("the runner exited")
            buf += chunk
        return bytes(buf)

    def _u32(self) -> int:
        return struct.unpack("<I", self._read(4))[0]

    def _str(self) -> str:
        return self._read(self._u32()).decode()

    def _write(self, data: bytes) -> None:
        if self._proc is None:
            raise NativeRunnerError("the runner is closed")
        try:
            self._proc.stdin.write(data)
        except (BrokenPipeError, OSError):
            raise self._fail("the runner exited") from None

    def _ready(self) -> None:
        magic, abi, status = struct.unpack("<III", self._read(12))
        if magic != _MAGIC:
            raise self._fail(f"{self._proc.args[0]} is not the native runner")
        if abi != _ABI_VERSION:
            raise self._fail(f"the runner speaks ABI v{abi}, expected "
                             f"v{_ABI_VERSION}")
        if status != 0:
            raise self._fail(self._str())
        self.load_ms = struct.unpack("<d", self._read(8))[0]
        self.out_spec = self._str()
        logger.info("native runner up: %s on %s (loaded in %.1f ms)",
                    self.package, self.device, self.load_ms)

    def _read_tensor(self) -> np.ndarray:
        code, ndim = struct.unpack("<iI", self._read(8))
        dims = struct.unpack(f"<{ndim}q", self._read(8 * ndim))
        dtype = _CODE_DTYPES[code]
        count = int(np.prod(dims, dtype=np.int64))
        return np.frombuffer(self._read(count * dtype.itemsize),
                             dtype).reshape(dims).copy()

    # -- the API ----------------------------------------------------------
    def execute(self, args) -> list[np.ndarray]:
        """Run the package on ``args`` (float32 or int32 arrays or CPU
        tensors) → its outputs as numpy arrays."""
        parts = [struct.pack("<II", _EXECUTE, len(args))]
        for a in args:
            a = np.ascontiguousarray(a.numpy() if isinstance(a, torch.Tensor)
                                     else a)
            if a.dtype not in _DTYPE_CODES:
                raise NativeRunnerError(
                    f"unsupported arg dtype {a.dtype} (float32/int32 only)")
            parts.append(struct.pack(f"<iI{a.ndim}q", _DTYPE_CODES[a.dtype],
                                     a.ndim, *a.shape))
            parts.append(a.tobytes())
        self._write(b"".join(parts))
        if self._u32() != 0:
            raise NativeRunnerError(f"execute failed: {self._str()}")
        return [self._read_tensor() for _ in range(self._u32())]

    def stats(self) -> dict:
        """The runner's own report: ``load_ms``, ``device``, ``executes``,
        each op's kernel ``launches`` and its ``cpu_calls``."""
        self._write(struct.pack("<I", _STATS))
        if self._u32() != 0:
            raise NativeRunnerError(f"stats failed: {self._str()}")
        return json.loads(self._str())

    def launch_counts(self) -> dict[str, int]:
        """Kernel launches in the runner process, by op."""
        return self.stats()["launches"]

    def num_outputs(self) -> int:
        from torch.utils import _pytree

        return _pytree.treespec_loads(self.out_spec).num_leaves

    def close(self) -> None:
        """End the child (end of input, then a kill if it lingers) and
        reap it."""
        proc, self._proc = self._proc, None
        if proc is not None:
            try:
                proc.stdin.close()
            except OSError:
                pass
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stdout.close()
        if self._stderr is not None:
            self._stderr.close()
            self._stderr = None

    def __enter__(self) -> "NativeRunner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def export_program(fn, *example_args) -> tuple[bytes, list]:
    """The AOTInductor package of ``fn`` (a module or a function of
    tensors) at ``example_args`` and its outputs' ``[shape, dtype]`` specs
    — the analog of the reference's ``export_stablehlo``. The package
    holds the parameters as constants and runs on the example args'
    device."""
    from euromillioner_tpu_torch.core.export import (exported_program,
                                                     out_specs)
    from euromillioner_tpu_torch.serve.aotstore import compile_program

    ep = exported_program(fn, example_args)
    return compile_program(ep.module(), example_args), out_specs(ep)

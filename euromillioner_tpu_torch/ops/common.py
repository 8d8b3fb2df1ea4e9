"""Build, load and launch the hand-written CUDA kernels.

Each kernel source under ``csrc/`` exposes a plain C function that launches
its kernel on a given stream and returns ``cudaGetLastError()``. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library at first use —
from the checkout's sources only, into ``build/torch_kernels/`` at the
repo root, keyed on the hash of the source and flags, and guarded by a
file lock so concurrent processes build once — then loaded with ctypes.
Nothing here runs at import: a CPU-only install imports every module.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("ops.common")

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels are built from source at first use")
    return path


def source_key(source: str) -> str:
    """The build key of ``csrc/<source>``: 16 hex digits of its bytes and
    the nvcc flags (a library built from other bytes has another key)."""
    text = (CSRC / source).read_bytes()
    return hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def build_library(source: str) -> tuple[Path, str]:
    """``csrc/<source>`` → ``(path of the built .so, nvcc's output)``.
    Reuses a finished build with the same source and flags."""
    src = CSRC / source
    out = BUILD_DIR / f"{src.stem}-{source_key(source)}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{src.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out, ""
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {src.name}:\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out, proc.stdout + proc.stderr


# every CudaKernel made in this process, for launch_counts()
_KERNELS: list["CudaKernel"] = []


def launch_counts() -> dict[str, int]:
    """Each kernel entry point's launches in this process, by symbol."""
    return {k.symbol: k.launches for k in _KERNELS}


class CudaKernel:
    """One kernel's C entry point: built and loaded on first use,
    ``launches`` counts the launches that went through :meth:`launch`
    (a plain int; nothing else changes it but a caller resetting it)."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        _KERNELS.append(self)
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self.path = None  # the built library, once built
        self._fn = None
        self._errstr = None
        self._lib = None
        self._lock = threading.Lock()

    @property
    def loaded(self) -> bool:
        return self._fn is not None

    def build(self) -> float:
        """Build (or reuse) and load the library; the seconds it took."""
        with self._lock:
            if self._fn is not None:
                return 0.0
            t0 = time.perf_counter()
            path, self.build_log = build_library(self.source)
            lib = ctypes.CDLL(str(path))
            self.path = path
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            errstr = lib.emt_cuda_error_string
            errstr.argtypes = [ctypes.c_int]
            errstr.restype = ctypes.c_char_p
            self._errstr = errstr
            self._lib = lib
            self._fn = fn
            seconds = time.perf_counter() - t0
            logger.info("built %s (%s) in %.2f s", self.source, path.name,
                        seconds)
            return seconds

    def query(self, symbol: str, argtypes: list, *args) -> int:
        """Call another C function of this kernel's library, one that
        launches nothing (an occupancy query); not counted."""
        if self._fn is None:
            self.build()
        fn = getattr(self._lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn(*args)

    def launch(self, *args) -> None:
        """Launch on the calling thread's current CUDA stream of the
        device named by the last of ``args`` (every entry point ends with
        ``int device, void* stream``); raises on a refused launch."""
        if self._fn is None:
            self.build()
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        stream = (raw(args[-1]) if raw is not None
                  else torch.cuda.current_stream(args[-1]).cuda_stream)
        code = self._fn(*args, stream)
        if code != 0:
            raise RuntimeError(
                f"{self.symbol} launch failed: CUDA error {code} "
                f"({self._errstr(code).decode()})")
        self.launches += 1

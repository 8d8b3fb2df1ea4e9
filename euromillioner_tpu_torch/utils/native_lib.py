"""ctypes loader for the C++ host library ``libemtpu`` (the JAX package's
``utils/native_lib.py``, with the port's own build).

The library is file IO (an atomic write, a whole-file read), a threaded
CSV → float32 matrix parser and the matching ``free``, compiled from
``native/emtpu.cpp``. ``*.so`` files are not committed, so the port builds
it itself at first use: the host's C++ compiler (``$CXX``, else ``g++``)
with the flags of ``native/Makefile`` (``-O3 -fPIC -std=c++17 -shared
-pthread``), into ``build/torch_native/`` at the repo root, keyed on the
hash of the source and flags and guarded by a file lock so concurrent
processes build once (as ``ops/common.py`` builds the CUDA sources).
``native/`` itself is only read.

The library speeds things up and is never required: with no source, no
compiler or a failed build, :func:`get` returns None and the callers take
their Python paths; a library that is built but cannot be loaded logs a
warning instead of being ignored silently.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("utils.native_lib")

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "emtpu.cpp"
BUILD_DIR = ROOT / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")

_searched = False
_lib: "NativeLib | None" = None
_load_lock = threading.Lock()


class NativeLib:
    """Typed wrapper over the C ABI of libemtpu."""

    def __init__(self, cdll: ctypes.CDLL):
        self._c = cdll
        self._c.emtpu_read_file.restype = ctypes.c_ssize_t
        self._c.emtpu_read_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
        self._c.emtpu_write_file.restype = ctypes.c_int
        self._c.emtpu_write_file.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
        self._c.emtpu_free.argtypes = [ctypes.c_void_p]
        self._c.emtpu_parse_csv.restype = ctypes.c_int
        self._c.emtpu_parse_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,       # buffer
            ctypes.c_int,                            # has_header
            ctypes.POINTER(ctypes.c_void_p),         # out values (float*)
            ctypes.POINTER(ctypes.c_size_t),         # out rows
            ctypes.POINTER(ctypes.c_size_t),         # out cols
        ]
        self._c.emtpu_version.restype = ctypes.c_char_p

    def version(self) -> str:
        return self._c.emtpu_version().decode()

    def read_file(self, path: str) -> bytes:
        buf = ctypes.c_void_p()
        n = self._c.emtpu_read_file(path.encode(), ctypes.byref(buf))
        if n < 0:
            raise OSError(f"emtpu_read_file failed for {path}")
        try:
            return ctypes.string_at(buf, n)
        finally:
            self._c.emtpu_free(buf)

    def write_file(self, path: str, data: bytes) -> None:
        """Write ``data`` to ``path`` atomically (a ``.tmp`` sibling,
        fsync, rename, fsync of the directory)."""
        rc = self._c.emtpu_write_file(path.encode(), data, len(data))
        if rc != 0:
            raise OSError(f"emtpu_write_file failed for {path} (rc={rc})")

    def parse_csv(self, text: bytes, has_header: bool) -> np.ndarray:
        """A CSV buffer → ``(rows, cols)`` float32; blank lines skipped,
        the first non-blank one the header when ``has_header``. Raises
        ValueError where the Python parser raises (a non-numeric or empty
        cell, values without a comma between them, C's hex floats)."""
        values = ctypes.c_void_p()
        rows = ctypes.c_size_t()
        cols = ctypes.c_size_t()
        rc = self._c.emtpu_parse_csv(text, len(text), int(has_header),
                                     ctypes.byref(values), ctypes.byref(rows),
                                     ctypes.byref(cols))
        if rc != 0:
            raise ValueError(f"emtpu_parse_csv failed (rc={rc})")
        try:
            n = rows.value * cols.value
            arr = np.ctypeslib.as_array(
                ctypes.cast(values, ctypes.POINTER(ctypes.c_float)), (n,))
            return arr.reshape(rows.value, cols.value).copy()
        finally:
            self._c.emtpu_free(values)


def _compiler() -> str | None:
    return shutil.which(os.environ.get("CXX") or "g++")


def build() -> Path | None:
    """``native/emtpu.cpp`` → the path of the built library, reusing a
    finished build of the same source and flags; None (logged) when there
    is no source or compiler or the build fails."""
    if not SOURCE.is_file():
        logger.info("no %s: the Python paths serve", SOURCE)
        return None
    cxx = _compiler()
    if cxx is None:
        logger.info("no C++ compiler (CXX=%s): the Python paths serve",
                    os.environ.get("CXX") or "g++")
        return None
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"libemtpu-{key[:16]}.so"
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "libemtpu.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if out.exists():
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                                   str(SOURCE)], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                logger.warning("building %s failed (%d): %s; the Python "
                               "paths serve", SOURCE.name, proc.returncode,
                               (proc.stderr or proc.stdout).strip()[-500:])
                return None
            os.replace(tmp, out)
            logger.info("built %s", out)
            return out
    except OSError as e:
        logger.warning("building %s failed: %s; the Python paths serve",
                       SOURCE.name, e)
        return None


def available() -> bool:
    return get() is not None


def get() -> NativeLib | None:
    """The library, built and loaded once per process; None when it
    cannot be built. A built library that fails to load warns and is
    disabled."""
    global _searched, _lib
    with _load_lock:
        if _searched:
            return _lib
        _searched = True
        path = build()
        if path is None:
            return None
        try:
            _lib = NativeLib(ctypes.CDLL(str(path)))
            logger.info("loaded native library %s (%s)", path,
                        _lib.version())
        except (OSError, AttributeError) as e:
            logger.warning("native library %s present but unusable: %s",
                           path, e)
            _lib = None
        return _lib

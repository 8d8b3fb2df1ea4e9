"""EMT1 tensor container, byte-compatible with the JAX package's files.

Format EMT1: magic "EMT1" | u32 n_entries | per entry:
u16 keylen | key utf-8 | u8 dtype | u8 ndim | u32 dims[ndim] | u64 nbytes |
raw bytes | u32 crc32(raw).

Dtype codes follow the JAX package's table by position. Code 6 is
bfloat16: numpy has no bfloat16 of its own, so its bits are read as raw
``uint16`` and rebuilt with ``Tensor.view(torch.bfloat16)`` — no numpy
bfloat16 registration (jax or ml_dtypes) is needed to read or write one.
:func:`loads` returns CPU tensors; :func:`dumps` takes tensors or numpy
arrays (a numpy array whose dtype is named ``bfloat16`` is written as code
6 from its raw bits). :func:`json_entry` / :func:`json_value` carry a JSON
object as a ``uint8`` entry (the migration header), byte for byte as the
JAX package writes one.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Mapping

import numpy as np
import torch

from euromillioner_tpu_torch.utils.errors import CheckpointError

_MAGIC = b"EMT1"

_NAMES = ("float32", "float64", "int32", "int64", "uint8", "bool",
          "bfloat16", "int8", "uint32", "float16")
BF16_CODE = _NAMES.index("bfloat16")


def host_array(value) -> tuple[int, np.ndarray]:
    """``(dtype code, C-contiguous numpy array of the raw values)``; a
    bfloat16 value comes back as its ``uint16`` bits."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return BF16_CODE, t.view(torch.int16).numpy().view(np.uint16)
        arr = t.numpy()
    else:
        # NOT ascontiguousarray: it promotes 0-d arrays to shape (1,)
        arr = np.asarray(value)
        if arr.dtype.name == "bfloat16":
            return BF16_CODE, np.copy(arr, order="C").view(np.uint16)
    if not arr.flags["C_CONTIGUOUS"]:
        arr = np.copy(arr, order="C")
    try:
        return _NAMES.index(arr.dtype.name), arr
    except ValueError:
        raise CheckpointError(f"unsupported dtype {arr.dtype}") from None


def dumps(arrays: Mapping[str, object]) -> bytes:
    out = [_MAGIC, struct.pack("<I", len(arrays))]
    for key, value in arrays.items():
        code, arr = host_array(value)
        kb = key.encode("utf-8")
        raw = arr.tobytes()
        out.append(struct.pack("<H", len(kb)))
        out.append(kb)
        out.append(struct.pack("<BB", code, arr.ndim))
        out.append(struct.pack(f"<{arr.ndim}I", *arr.shape))
        out.append(struct.pack("<Q", len(raw)))
        out.append(raw)
        out.append(struct.pack("<I", zlib.crc32(raw) & 0xFFFFFFFF))
    return b"".join(out)


def loads(data: bytes) -> dict[str, torch.Tensor]:
    if data[:4] != _MAGIC:
        raise CheckpointError("bad magic: not an EMT1 container")
    try:
        (n,) = struct.unpack_from("<I", data, 4)
        off = 8
        out: dict[str, torch.Tensor] = {}
        for _ in range(n):
            (klen,) = struct.unpack_from("<H", data, off); off += 2
            key = data[off:off + klen].decode("utf-8"); off += klen
            code, ndim = struct.unpack_from("<BB", data, off); off += 2
            shape = struct.unpack_from(f"<{ndim}I", data, off); off += 4 * ndim
            (nbytes,) = struct.unpack_from("<Q", data, off); off += 8
            raw = data[off:off + nbytes]; off += nbytes
            (crc,) = struct.unpack_from("<I", data, off); off += 4
            if zlib.crc32(raw) & 0xFFFFFFFF != crc:
                raise CheckpointError(f"CRC mismatch for entry {key!r}")
            if code >= len(_NAMES):
                raise CheckpointError(f"unknown dtype code {code}")
            np_dtype = np.uint16 if code == BF16_CODE else np.dtype(_NAMES[code])
            arr = np.frombuffer(raw, dtype=np_dtype).reshape(shape).copy()
            t = torch.from_numpy(arr)
            out[key] = t.view(torch.bfloat16) if code == BF16_CODE else t
    except (struct.error, UnicodeDecodeError, ValueError) as e:
        # a truncated or garbled container: one failure type for callers
        raise CheckpointError(f"malformed EMT1 container: {e}") from e
    return out


def json_entry(obj: Any) -> np.ndarray:
    """A JSON-serializable object as a ``uint8`` entry: sorted keys and
    compact separators, so the bytes are stable; the container's length
    and crc32 framing guard it like any tensor."""
    raw = json.dumps(obj, sort_keys=True,
                     separators=(",", ":")).encode("utf-8")
    return np.frombuffer(raw, dtype=np.uint8).copy()


def json_value(arr) -> Any:
    """Decode a :func:`json_entry` (numpy array or CPU tensor)."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype != torch.uint8:
            raise CheckpointError(
                f"json entry must be uint8, got {arr.dtype}")
        arr = arr.numpy()
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise CheckpointError(f"json entry must be uint8, got {arr.dtype}")
    try:
        return json.loads(arr.tobytes().decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise CheckpointError(f"malformed json entry: {exc}") from exc


def save(path: str, arrays: Mapping[str, object]) -> None:
    """Write the container to ``path`` (through the native library's
    atomic write when it is built)."""
    native = _native()
    blob = dumps(arrays)
    if native is not None:
        native.write_file(path, blob)
    else:
        with open(path, "wb") as fh:
            fh.write(blob)


def load(path: str) -> dict[str, torch.Tensor]:
    native = _native()
    if native is not None:
        return loads(native.read_file(path))
    with open(path, "rb") as fh:
        return loads(fh.read())


def _native():
    """The C++ fast path, if built (utils/native_lib.py, which itself logs
    a library that is present but unusable)."""
    from euromillioner_tpu_torch.utils import native_lib

    return native_lib.get()

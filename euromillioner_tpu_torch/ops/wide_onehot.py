"""The Wide&Deep wide tower's one-hot contraction: K4a forward, K4b dW.

``csrc/wide_onehot.cu`` replaces the JAX package's Pallas TPU pair in
``euromillioner_tpu/ops/wide_onehot.py`` (the source's note gives the
design and the bound):

* K4a (``_fwd_kernel``, :86): ``out[b] = Σ_k w[k, ids[b, k]]`` — w (K, V, E)
  in float32 or bfloat16, ids (B, K) int32, out (B, E) float32;
* K4b (``_dw_kernel``, :97): ``dw[k, v] = Σ_{b: ids[b, k] = v} dh[b]`` — dh
  (B, E) in w's dtype, sums in float32, dw (K, V, E) dense in w's dtype.

:class:`WideOnehotMatmul` joins them as one ``torch.autograd.Function``, as
``jax.custom_vjp`` joins the Pallas pair: the cotangent is rounded to w's
dtype before K4b (``_vjp_bwd``), the ids get no gradient, and the table is
not saved for the backward. The gradient is dense: every row of the block
is written, zeros included, so an optimizer sees the same gradient as the
JAX package's.

An id outside [0, V) adds nothing (its one-hot row is zero on the TPU).

The device rule: for CPU tensors the wrappers take the plain versions,
which add in the kernels' order (k ascending for K4a; batch order per id
for K4b) and agree with the Pallas kernels in interpret mode bit for bit;
for CUDA tensors they launch the kernel or raise — no fallback. A table
dtype other than float32 or bfloat16 is a :class:`ConfigError` on either
device.
"""

from __future__ import annotations

import ctypes

import torch

from euromillioner_tpu_torch.ops.common import CudaKernel
from euromillioner_tpu_torch.utils.errors import ConfigError

_P = ctypes.c_void_p
_I = ctypes.c_int

# the kernels' C entry points and launch counters (``.launches``):
# K4a: w, ids, out; B, K, V, E, dtype, vec, device; stream
WIDE_ONEHOT_FWD = CudaKernel("wide_onehot.cu", "emt_wide_onehot_fwd",
                             [_P] * 3 + [_I] * 7 + [_P])
# K4b: ids, dh, dw, keys; B, K, V, E, dtype, vec, device; stream
WIDE_ONEHOT_DW = CudaKernel("wide_onehot.cu", "emt_wide_onehot_dw",
                            [_P] * 4 + [_I] * 7 + [_P])

# table dtype → the kernels' dtype code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K4b sorts each position's pow2(B) keys in one block's shared memory
MAX_DW_BATCH = 32768


def check_table_dtype(dtype) -> None:
    """ConfigError for a table dtype the kernels do not take."""
    if dtype not in DTYPE_CODES:
        raise ConfigError(
            f"the wide one-hot kernels take float32 or bfloat16 tables, "
            f"not {dtype}")


def wide_onehot_fwd_reference(w, ids):
    """The plain version of K4a: an f32 gather-sum over positions in k
    order, from zero."""
    k, v, e = w.shape
    out = torch.zeros((ids.shape[0], e), dtype=torch.float32, device=w.device)
    for j in range(k):
        col = ids[:, j].long()
        valid = (col >= 0) & (col < v)
        rows = w[j][col.clamp(0, v - 1)].float()
        out = out + torch.where(valid[:, None], rows, torch.zeros_like(rows))
    return out


def wide_onehot_dw_reference(ids, dh, v: int):
    """The plain version of K4b: per position, ``index_add_`` of dh's rows
    in batch order into an f32 block, cast once to dh's dtype. On a CPU
    tensor ``index_add_`` adds in index order; on a CUDA tensor it adds
    with atomics, in no fixed order."""
    b, k = ids.shape
    e = dh.shape[1]
    dw = torch.zeros((k, v, e), dtype=torch.float32, device=dh.device)
    dh32 = dh.float()
    for j in range(k):
        col = ids[:, j].long()
        valid = (col >= 0) & (col < v)
        dw[j].index_add_(0, col[valid], dh32[valid])
    return dw.to(dh.dtype)


def _vec(e: int, itemsize: int, *tensors) -> int:
    """Widest column vector (16 bytes at most) that divides E and every
    tensor's address."""
    vec = 16 // itemsize
    while vec > 1 and (e % vec or any(t.data_ptr() % (vec * itemsize)
                                      for t in tensors)):
        vec //= 2
    return vec


def _check_ids(ids, batch: int | None = None) -> None:
    if ids.dim() != 2:
        raise ValueError(f"ids must be (B, K), got {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if batch is not None and ids.shape[0] != batch:
        raise ValueError(f"ids hold {ids.shape[0]} rows, expected {batch}")


def _device_of(*tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError("the wide one-hot kernels take contiguous "
                                 "tensors")
    return dev


def wide_onehot_fwd(w, ids):
    """Σ_k w[k, ids[:, k]] → (B, E) float32 — K4a on CUDA tensors, the
    plain version on CPU tensors."""
    check_table_dtype(w.dtype)
    if w.dim() != 3:
        raise ValueError(f"w must be (K, V, E), got {tuple(w.shape)}")
    _check_ids(ids)
    k, v, e = w.shape
    if ids.shape[1] != k:
        raise ValueError(f"ids have {ids.shape[1]} positions, w has {k}")
    if _device_of(w, ids).type == "cpu":
        return wide_onehot_fwd_reference(w, ids)
    b = ids.shape[0]
    out = torch.empty((b, e), dtype=torch.float32, device=w.device)
    vec = _vec(e, w.element_size(), w)
    WIDE_ONEHOT_FWD.launch(w.data_ptr(), ids.data_ptr(), out.data_ptr(), b, k,
                           v, e, DTYPE_CODES[w.dtype], vec, w.device.index)
    return out


def wide_onehot_dw(ids, dh, v: int):
    """The dense (K, V, E) gradient of the table in dh's dtype — K4b on
    CUDA tensors, the plain version on CPU tensors."""
    check_table_dtype(dh.dtype)
    if dh.dim() != 2:
        raise ValueError(f"dh must be (B, E), got {tuple(dh.shape)}")
    _check_ids(ids, dh.shape[0])
    if _device_of(ids, dh).type == "cpu":
        return wide_onehot_dw_reference(ids, dh, v)
    b, k = ids.shape
    e = dh.shape[1]
    if b > MAX_DW_BATCH or v * b >= 2 ** 31:
        raise ValueError(f"K4b takes B <= {MAX_DW_BATCH} and V * B < 2^31, "
                         f"got B={b}, V={v}")
    dw = torch.zeros((k, v, e), dtype=dh.dtype, device=dh.device)
    keys = torch.empty((k, b), dtype=torch.int32, device=dh.device)
    vec = _vec(e, dh.element_size(), dh, dw)
    WIDE_ONEHOT_DW.launch(ids.data_ptr(), dh.data_ptr(), dw.data_ptr(),
                          keys.data_ptr(), b, k, v, e, DTYPE_CODES[dh.dtype],
                          vec, dh.device.index)
    return dw


class WideOnehotMatmul(torch.autograd.Function):
    """``apply(w, ids) -> (B, E) float32``: K4a forward, K4b backward (the
    plain versions on CPU tensors). Gradient to ``w`` only."""

    @staticmethod
    def forward(ctx, w, ids):
        out = wide_onehot_fwd(w, ids)
        ctx.save_for_backward(ids)
        ctx.vocab = w.shape[1]
        ctx.w_dtype = w.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        dw = wide_onehot_dw(ids, g.to(ctx.w_dtype).contiguous(), ctx.vocab)
        return dw, None


def wide_onehot_matmul(w, ids):
    """Σ_k onehot(ids[:, k], V) @ w[k] with the kernels' gradient."""
    return WideOnehotMatmul.apply(w, ids)

"""The trees' split-finder histogram (K3): one launch per tree level.

``csrc/fused_histogram.cu`` replaces the JAX package's Pallas TPU kernel
``euromillioner_tpu/ops/fused_histogram.py:140`` (``_hist_kernel``): per
level, for every feature,

    hist[f, 2·node + stat, bin] = Σᵢ 1[binned[i, f] = bin] · 1[local[i] = node]
                                     · (gw[i] if stat = 0 else hw[i])

in the JAX package's (F, 2K, bins) layout. Its sums are exact f32 adds in
an order fixed by the launch shape, so reruns are bit-identical (the
source's note gives the design and the bound).

:func:`fused_histogram_sets` adds a leading set axis for the random
forest: S sets of (local, gw, hw) over one shared ``binned`` in one
launch, set ``s`` bit-identical to :func:`fused_histogram` on its inputs.

The device rule: for CPU tensors :func:`fused_histogram` takes the plain
version, :func:`fused_histogram_reference` — ``index_add_`` over the flat
(node, feature, bin) index, which adds in row order exactly as the JAX
package's scatter does (``trees/growth.py:120-133``), so the two agree bit
for bit (the set form loops over the sets). For CUDA tensors each launches
the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from euromillioner_tpu_torch.ops.common import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int

# the kernel's C entry point and launch counter (``FUSED_HISTOGRAM.launches``):
# binned, local, gw, hw, out, partial; N, F, n_bins, n_nodes, chunks,
# node_tile, bin_tile, device; stream
FUSED_HISTOGRAM = CudaKernel(
    "fused_histogram.cu", "emt_fused_histogram_f32", [_P] * 6 + [_I] * 8 + [_P])
# the set form's (``FUSED_HISTOGRAM_SETS.launches``): the same arguments with
# the set count after n_nodes
FUSED_HISTOGRAM_SETS = CudaKernel(
    "fused_histogram.cu", "emt_fused_histogram_sets_f32",
    [_P] * 6 + [_I] * 9 + [_P])

_WARPS = 4                      # warps per block, each with a private tile
_SMEM_BYTES = 96 * 1024         # per block: two blocks fit one SM
_MAX_BIN_TILE = 1024
_MIN_CHUNK_ROWS = 512           # rows per chunk, at least
_TARGET_BLOCKS = 4 * 132        # ~4 blocks per SM of an H100


def launch_plan(n_rows: int, n_features: int, n_bins: int,
                n_nodes: int) -> tuple[int, int, int]:
    """``(chunks, node_tile, bin_tile)`` for one launch: the largest tile
    of (node, stat, bin) cells whose four warp copies fit the shared-memory
    budget, then enough row chunks to put ~4 blocks on each SM (never
    fewer than ``_MIN_CHUNK_ROWS`` rows a chunk, unless one chunk holds
    every row)."""
    cells = _SMEM_BYTES // (4 * _WARPS)
    bin_tile = min(n_bins, _MAX_BIN_TILE)
    node_tile = max(1, min(n_nodes, cells // (2 * bin_tile)))
    tiles = -(-n_nodes // node_tile) * -(-n_bins // bin_tile)
    chunks = max(1, min(n_rows // _MIN_CHUNK_ROWS,
                        -(-_TARGET_BLOCKS // max(1, n_features * tiles))))
    return chunks, node_tile, bin_tile


def fused_histogram_reference(binned, local, gw, hw, n_bins: int,
                              n_nodes: int):
    """The plain version: ``index_add_`` of gw and hw over the flat
    (node, feature, bin) index, as the JAX package's scatter formulation,
    returned as (F, 2·n_nodes, n_bins)."""
    n, f = binned.shape
    flat = (local.long()[:, None] * (f * n_bins)
            + torch.arange(f, device=binned.device)[None, :] * n_bins
            + binned.long()).reshape(-1)
    size = n_nodes * f * n_bins
    hists = [torch.zeros(size, dtype=torch.float32, device=binned.device)
             .index_add_(0, flat, w[:, None].expand(n, f).reshape(-1))
             for w in (gw, hw)]
    hist = torch.stack(hists).view(2, n_nodes, f, n_bins)
    return hist.permute(2, 1, 0, 3).reshape(f, 2 * n_nodes, n_bins)


def fused_histogram_sets_reference(binned, local, gw, hw, n_bins: int,
                                   n_nodes: int):
    """The set form's plain version: :func:`fused_histogram_reference` of
    each set, stacked to (S, F, 2·n_nodes, n_bins)."""
    f = binned.shape[1]
    if local.shape[0] == 0:
        return torch.zeros((0, f, 2 * n_nodes, n_bins), dtype=torch.float32,
                           device=binned.device)
    return torch.stack([
        fused_histogram_reference(binned, local[s], gw[s], hw[s], n_bins,
                                  n_nodes) for s in range(local.shape[0])])


def _check(binned, local, gw, hw, sets: bool = False) -> None:
    if binned.dim() != 2:
        raise ValueError(f"binned must be (N, F), got {tuple(binned.shape)}")
    n = binned.shape[0]
    want = (n,)
    if sets:
        want = (local.shape[0], n) if local.dim() == 2 else None
    for name, a in (("local", local), ("gw", gw), ("hw", hw)):
        if want is None or tuple(a.shape) != want:
            shape = "(S, N)" if sets else f"({n},)"
            raise ValueError(f"{name} must be {shape} with N = {n}, got "
                             f"{tuple(a.shape)}")
    for name, a, dt in (("binned", binned, torch.int32),
                        ("local", local, torch.int32),
                        ("gw", gw, torch.float32), ("hw", hw, torch.float32)):
        if a.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {a.dtype}")
        if a.device != binned.device:
            raise ValueError(f"{name} is on {a.device}, binned on "
                             f"{binned.device}")


def _on_card(binned, local, gw, hw) -> bool:
    """True for CUDA tensors (which must then be contiguous), False for CPU
    tensors; any other device raises."""
    if binned.device.type == "cpu":
        return False
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")
    for name, a in (("binned", binned), ("local", local), ("gw", gw),
                    ("hw", hw)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return True


def fused_histogram(binned, local, gw, hw, n_bins: int, n_nodes: int):
    """hist[f, 2·node + stat, bin] over all rows: ``binned`` (N, F) int32
    bin ids, ``local`` (N,) int32 node ids in [0, n_nodes), ``gw``/``hw``
    (N,) f32 weighted grad/hess (stat 0 / stat 1). Returns (F, 2·n_nodes,
    n_bins) f32 — the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    _check(binned, local, gw, hw)
    if not _on_card(binned, local, gw, hw):
        return fused_histogram_reference(binned, local, gw, hw, n_bins,
                                         n_nodes)
    n, f = binned.shape
    chunks, node_tile, bin_tile = launch_plan(n, f, n_bins, n_nodes)
    out = torch.empty((f, 2 * n_nodes, n_bins), dtype=torch.float32,
                      device=binned.device)
    partial = (torch.empty((chunks, *out.shape), dtype=torch.float32,
                           device=binned.device) if chunks > 1 else None)
    FUSED_HISTOGRAM.launch(
        binned.data_ptr(), local.data_ptr(), gw.data_ptr(), hw.data_ptr(),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        n, f, n_bins, n_nodes, chunks, node_tile, bin_tile,
        binned.device.index)
    return out


def fused_histogram_sets(binned, local, gw, hw, n_bins: int, n_nodes: int):
    """:func:`fused_histogram` for S sets at once: ``binned`` (N, F) int32
    shared by every set, ``local`` (S, N) int32, ``gw``/``hw`` (S, N) f32.
    Returns (S, F, 2·n_nodes, n_bins) f32 whose set ``s`` is
    ``fused_histogram(binned, local[s], gw[s], hw[s], …)`` bit for bit —
    one launch on CUDA tensors (the launch plan is one set's), the plain
    version on CPU tensors."""
    _check(binned, local, gw, hw, sets=True)
    if not _on_card(binned, local, gw, hw):
        return fused_histogram_sets_reference(binned, local, gw, hw, n_bins,
                                              n_nodes)
    (n, f), s = binned.shape, local.shape[0]
    out = torch.empty((s, f, 2 * n_nodes, n_bins), dtype=torch.float32,
                      device=binned.device)
    if s == 0:
        return out
    chunks, node_tile, bin_tile = launch_plan(n, f, n_bins, n_nodes)
    partial = (torch.empty((s, chunks, *out.shape[1:]), dtype=torch.float32,
                           device=binned.device) if chunks > 1 else None)
    FUSED_HISTOGRAM_SETS.launch(
        binned.data_ptr(), local.data_ptr(), gw.data_ptr(), hw.data_ptr(),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        n, f, n_bins, n_nodes, s, chunks, node_tile, bin_tile,
        binned.device.index)
    return out

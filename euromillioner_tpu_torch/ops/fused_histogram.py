"""The trees' split-finder histogram (K3): one launch per tree level.

``csrc/fused_histogram.cu`` replaces the JAX package's Pallas TPU kernel
``euromillioner_tpu/ops/fused_histogram.py:140`` (``_hist_kernel``): per
level, for every feature,

    hist[f, 2·node + stat, bin] = Σᵢ 1[binned[i, f] = bin] · 1[local[i] = node]
                                     · (gw[i] if stat = 0 else hw[i])

in the JAX package's (F, 2K, bins) layout. Its sums are exact f32 adds in
an order fixed by the launch plan and the data, so reruns are
bit-identical (the source's note gives the design and the bound).
:func:`launch_plan` chooses the plan: how a block's 16 warps split the
level's cells (copies, owners, feature slots) and whether their lanes take
rows or features, the feature group, bin tile and node tile a block holds,
the rows
it stages at a time and the row chunks.

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
import functools
from typing import NamedTuple

import torch

from euromillioner_tpu_torch.ops.common import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int

# the kernel's C entry point and launch counter (``FUSED_HISTOGRAM.launches``):
# binned, binned_t, local, gw, hw, out, partial; N, F, n_bins, n_nodes,
# chunks, features, copies, owners, by_feature, bin_tile, node_tile, rows,
# device; stream
FUSED_HISTOGRAM = CudaKernel(
    "fused_histogram.cu", "emt_fused_histogram_f32",
    [_P] * 7 + [_I] * 13 + [_P])
# the set form's (``FUSED_HISTOGRAM_SETS.launches``): the same arguments with
# the set count after n_nodes and the sets per block after rows
FUSED_HISTOGRAM_SETS = CudaKernel(
    "fused_histogram.cu", "emt_fused_histogram_sets_f32",
    [_P] * 7 + [_I] * 15 + [_P])

# the kernel's shape (csrc/fused_histogram.cu): warps per block and the most
# dynamic shared memory a block may use
_WARPS = 16
_SMEM_MAX = 232448
_MIN_ROWS, _MAX_ROWS = 256, 4096    # rows per staged tile
_MAX_FEATURES = 64              # features per block
_MIN_CHUNK_ROWS = 512           # rows per chunk, at least (x16 with lanes
#                                 on features, whose copies cost per chunk)
_ONE_FEATURE_ROWS = 4096        # below this, one feature a block
_SPLIT_ROWS = 1024              # staged rows a split block keeps room for
_FEATURE_LANE_BINS = 64         # lanes take features up to this many bins
_SMS = 132                      # SMs of an H100 SXM, one block each


class Plan(NamedTuple):
    """One launch's plan. A block holds ``features`` features' tiles of
    ``node_tile`` nodes (all the level's, unless they do not fit) and
    ``bin_tile`` bins, in ``copies`` copies, and
    streams its chunk in tiles of ``rows`` rows; its 16 warps are copies x
    ``owners`` x feature slots, and their lanes take rows or, with
    ``by_feature``, features; ``sets`` sets share a block in the set form.
    :func:`order_fields` names the fields that fix the order of a set's
    sums."""
    chunks: int
    features: int
    copies: int
    owners: int
    by_feature: int
    bin_tile: int
    node_tile: int
    rows: int
    sets: int


def smem_bytes(plan: Plan) -> int:
    """Dynamic shared memory of one block under ``plan`` (the kernel's
    ``smem_bytes``): the tiles, two stages of staged rows and the split of
    a staged tile among the warps."""
    tiles = plan.sets * plan.features * plan.copies * 2 * plan.node_tile \
        * plan.bin_tile
    stage = plan.rows * ((plan.features | 1) + 3 * plan.sets)
    split = plan.rows // 32 * _WARPS + 2 * plan.rows + _WARPS
    return 4 * (tiles + 2 * stage + split)


def order_fields(plan: Plan) -> tuple:
    """The fields of ``plan`` that fix the order in which a set's sums are
    taken. With one owner, or lanes on features, a warp takes its copy's
    32-row groups as they are, whatever the staged tile's length or the
    feature group; otherwise the rows are split among the owners per
    staged tile, and a one-feature block owns cells rather than nodes."""
    split = plan.owners > 1 and not plan.by_feature
    return (plan.chunks, plan.copies, plan.owners, plan.by_feature,
            plan.bin_tile, plan.node_tile, plan.features if split else None,
            plan.rows if split else None)


@functools.lru_cache(maxsize=1024)
def launch_plan(n_rows: int, n_features: int, n_bins: int, n_nodes: int,
                sets: int = 1) -> Plan:
    """The plan of a launch over ``sets`` sets. The bin tile holds every bin
    unless one feature's tile of all nodes would not fit; the node tile
    holds every node unless one bin of all nodes would not fit, and then
    the bin tile every bin that fits. The warps own
    nodes: as many owners as nodes (up to 16), copies the rest. With few
    bins (``_FEATURE_LANE_BINS``), where 32 rows of a feature pile into few
    cells, the lanes take features if 16 features' tiles fit every copy.
    Else, where small tiles allow it (shallow levels), one owner: the warps
    spread over as many feature slots as there are features (up to 16)
    and copies, when the block holds a feature for every slot; else (deep
    levels) the owners split each staged tile's rows among them, with
    fewer copies if they do not fit. Then the widest feature group that
    fits beside the smallest staged tile (``_SPLIT_ROWS`` rows where the
    rows are split), balanced over the features; then the largest staged
    tile that fits; then enough row chunks to give every SM its blocks,
    never fewer than ``_MIN_CHUNK_ROWS`` rows a chunk and never more than
    four times as many partial bytes as input bytes. Below
    ``_ONE_FEATURE_ROWS`` rows, one feature a block and one chunk: the
    features spread over the SMs, and one launch does it all. Last, the
    sets per block: as many as fit while the launch keeps every SM busy;
    where the staged tile's length orders no sum they may shorten it. So
    no field that orders a set's sums depends on ``sets``: a set adds in
    the same order in any launch. Cached: a tree level calls it once per
    launch."""
    f = n_features
    most = 1 if n_rows < _ONE_FEATURE_ROWS else min(f, _MAX_FEATURES)
    # the (node, bin) cells of one feature that a block holds beside the
    # smallest staged tile
    room = (_SMEM_MAX - smem_bytes(
        Plan(1, 1, 0, 1, 0, 0, 0, _MIN_ROWS, 1))) // 8
    bin_tile = min(n_bins, room // n_nodes)
    k = n_nodes
    if bin_tile < 1:
        bin_tile = min(n_bins, room)
        tiles = -(-n_nodes // (room // bin_tile))
        k = -(-n_nodes // tiles)

    def fits(features, copies, bin_tile, rows, s=1):
        return smem_bytes(Plan(1, features, copies, 1, 0, bin_tile, k, rows,
                               s)) <= _SMEM_MAX

    def widest(copies, bin_tile, rows=_MIN_ROWS):
        g = 0
        while g < most and fits(g + 1, copies, bin_tile, rows):
            g += 1
        return g

    owners = min(_WARPS, 1 << (k.bit_length() - 1))
    copies = _WARPS // owners
    by_feature = int(bin_tile <= _FEATURE_LANE_BINS
                     and widest(copies, bin_tile) >= _WARPS)
    if not by_feature:
        for c in (1 << i for i in range(_WARPS.bit_length())):
            if widest(c, bin_tile) >= _WARPS // c <= most:
                owners, copies = 1, c
                break
        while copies > 1 and not fits(1, copies, bin_tile, _MIN_ROWS):
            copies //= 2
            owners *= 2
    split = owners > 1 and not by_feature
    # split blocks add a staged tile's list 32 rows a warp at a time: they
    # keep room for longer tiles
    features = max(1, widest(copies, bin_tile, _SPLIT_ROWS if split
                             else _MIN_ROWS))
    groups = -(-f // features)
    features = -(-f // groups)

    def most_rows(s):
        rows = _MAX_ROWS
        while rows > 32 and (rows - 32 >= n_rows or not fits(
                features, copies, bin_tile, rows, s)):
            rows -= 32
        return rows

    rows = most_rows(1)
    one = Plan(1, features, copies, owners, by_feature, bin_tile, k, rows, 1)
    blocks = groups * -(-n_bins // bin_tile) * -(-n_nodes // k)
    ratio = 4 * n_rows * (f + 3) // (f * 2 * n_nodes * n_bins)
    least_rows = _MIN_CHUNK_ROWS * (16 if by_feature else 1)
    chunks = 1 if most == 1 else max(1, min(
        n_rows // least_rows, _SMS // blocks, ratio))
    # where the staged tile's length orders no sum, the sets per block may
    # take staged rows
    free_rows = order_fields(one)[-1] is None
    least = _MIN_ROWS if free_rows else rows
    per_block = 1
    while (per_block < sets
           and fits(features, copies, bin_tile, least, per_block + 1)
           and -(-sets // (per_block + 1)) * blocks * chunks >= _SMS):
        per_block += 1
    if free_rows:
        rows = most_rows(per_block)
    return Plan(chunks, features, copies, owners, by_feature, bin_tile, k,
                rows, per_block)


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


def _buffers(binned, plan: Plan, sets: int, n_bins: int, n_nodes: int):
    """The launch's scratch: binned transposed to (F, N) at deep levels
    (the rows split among owners) whose features come in several groups, so
    that a group's columns load contiguously; and the chunks' partial sums
    when there are several chunks."""
    n, f = binned.shape
    binned_t = (torch.empty((f, n), dtype=torch.int32, device=binned.device)
                if order_fields(plan)[-1] is not None and plan.features < f
                else None)
    partial = (torch.empty((sets, plan.chunks, f, 2 * n_nodes, n_bins),
                           dtype=torch.float32, device=binned.device)
               if plan.chunks > 1 else None)
    return binned_t, partial


def _ptr(a):
    return None if a is None else a.data_ptr()


def _planned(plan, n, f, n_bins, n_nodes, sets):
    """``plan``, or :func:`launch_plan`'s when it is None; a given plan
    must fit a block (the kernel checks the rest)."""
    if plan is None:
        return launch_plan(n, f, n_bins, n_nodes, sets)
    if smem_bytes(plan) > _SMEM_MAX or plan.sets > sets:
        raise ValueError(f"{plan} does not fit a block of this launch")
    return plan


def fused_histogram(binned, local, gw, hw, n_bins: int, n_nodes: int,
                    plan: Plan | None = None):
    """hist[f, 2·node + stat, bin] over all rows: ``binned`` (N, F) int32
    bin ids, ``local`` (N,) int32 node ids in [0, n_nodes), ``gw``/``hw``
    (N,) f32 weighted grad/hess (stat 0 / stat 1). Returns (F, 2·n_nodes,
    n_bins) f32 — the kernel on CUDA tensors, the plain version on CPU
    tensors. ``plan`` replaces :func:`launch_plan`'s on the card, to time
    one plan against another; it orders the sums as its fields say."""
    _check(binned, local, gw, hw)
    if not _on_card(binned, local, gw, hw):
        return fused_histogram_reference(binned, local, gw, hw, n_bins,
                                         n_nodes)
    n, f = binned.shape
    plan = _planned(plan, n, f, n_bins, n_nodes, 1)
    out = torch.empty((f, 2 * n_nodes, n_bins), dtype=torch.float32,
                      device=binned.device)
    binned_t, partial = _buffers(binned, plan, 1, n_bins, n_nodes)
    FUSED_HISTOGRAM.launch(
        binned.data_ptr(), _ptr(binned_t), local.data_ptr(), gw.data_ptr(),
        hw.data_ptr(), out.data_ptr(), _ptr(partial), n, f, n_bins, n_nodes,
        *plan[:8], binned.device.index)
    return out


def fused_histogram_sets(binned, local, gw, hw, n_bins: int, n_nodes: int,
                         plan: Plan | None = None):
    """:func:`fused_histogram` for S sets at once: ``binned`` (N, F) int32
    shared by every set, ``local`` (S, N) int32, ``gw``/``hw`` (S, N) f32.
    Returns (S, F, 2·n_nodes, n_bins) f32 whose set ``s`` is
    ``fused_histogram(binned, local[s], gw[s], hw[s], …)`` bit for bit —
    one launch on CUDA tensors (every field of the launch plan but its sets
    per block is one set's), the plain version on CPU tensors; ``plan`` as
    in :func:`fused_histogram`."""
    _check(binned, local, gw, hw, sets=True)
    if not _on_card(binned, local, gw, hw):
        return fused_histogram_sets_reference(binned, local, gw, hw, n_bins,
                                              n_nodes)
    (n, f), s = binned.shape, local.shape[0]
    out = torch.empty((s, f, 2 * n_nodes, n_bins), dtype=torch.float32,
                      device=binned.device)
    if s == 0:
        return out
    plan = _planned(plan, n, f, n_bins, n_nodes, s)
    binned_t, partial = _buffers(binned, plan, s, n_bins, n_nodes)
    FUSED_HISTOGRAM_SETS.launch(
        binned.data_ptr(), _ptr(binned_t), local.data_ptr(), gw.data_ptr(),
        hw.data_ptr(), out.data_ptr(), _ptr(partial), n, f, n_bins, n_nodes,
        s, *plan, binned.device.index)
    return out

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
device. Each launch follows a plan computed here (:func:`fwd_plan`,
:func:`dw_plan`: grid, tiles, shared memory, K4b's scratch), which the C
entry points check against their own layout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from euromillioner_tpu_torch.ops.common import CudaKernel
from euromillioner_tpu_torch.utils.errors import ConfigError

_P = ctypes.c_void_p
_I = ctypes.c_int

# the kernels' C entry points and launch counters (``.launches``):
# K4a: w, ids, out; B, K, V, E, dtype, vec, rows, group, threads, blocks,
# device; stream
WIDE_ONEHOT_FWD = CudaKernel("wide_onehot.cu", "emt_wide_onehot_fwd",
                             [_P] * 3 + [_I] * 11 + [_P])
# K4b: ids, dh, dw, scratch; B, K, V, E, dtype, vec, tile_rows, tiles,
# bin_range, sort_smem, zero_rows, zero_blocks, run_blocks, scratch, parts,
# device; stream
WIDE_ONEHOT_DW = CudaKernel("wide_onehot.cu", "emt_wide_onehot_dw",
                            [_P] * 4 + [_I] * 16 + [_P])

# table dtype → the kernels' dtype code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The launch plans' constants, as csrc/wide_onehot.cu has them: the entry
# points recompute what follows from a plan and refuse one they would lay
# out otherwise.
SMS = 132                 # the H100 SXM's SMs
FWD_THREADS = 128         # K4a's widest block (4 blocks an SM at least)
FWD_RESIDENT = SMS * 512  # K4a threads the card holds at once
# K4a's ways: (rows a thread owns, positions whose loads it issues before
# their adds); (2, 4), (4, 2) and (8, 2) measured slower at B=8192 in both
# dtypes (PERF.md) and are not built
FWD_WAYS = ((1, 24), (1, 8), (2, 8), (4, 4), (8, 1))
FWD_GROUP = {2: 8, 4: 4, 8: 1}  # by rows, past one row a thread
# K4a's rows per thread at large B, at most: 8 f32 rows hold 32 sums a
# thread; bf16 rows hold twice the registers, and one row with 8 positions'
# loads at a time was the fastest bf16 way at B=8192 (chip_smoke.py's
# "K4a ways" lines, PERF.md)
FWD_MAX_ROWS = {torch.float32: 8, torch.bfloat16: 1}
# K4b's sort: a batch past 1024 rows goes in SORT_TILES tiles of 1024 to
# MAX_TILE_ROWS rows, then in more tiles of MAX_TILE_ROWS
MAX_TILE_ROWS = 8192
SORT_TILES = 8
MAX_SORT_SMEM = 64 * 1024  # a placing block's tile of bins and cursors
MAX_POSITIONS = 1024      # K4b: positions K the row writer takes
WRITE_THREADS = 256       # K4b's row writer: threads per block
WRITE_UNITS = 8           # ... (row, column vector) units per zeroing thread
RUN_BLOCKS = SMS * 8      # ... blocks striding over the non-empty rows
# K4b's parts, for timing them apart (``_dw_args(..., parts)``): the
# sort's count, its scan and place, and the row writer
DW_COUNT, DW_PLACE, DW_WRITE = 1, 2, 4
DW_SORT = DW_COUNT | DW_PLACE
DW_ALL = DW_SORT | DW_WRITE


class FwdPlan(NamedTuple):
    """How K4a runs one call: a thread owns one column vector of ``vec``
    columns of ``rows`` consecutive batch rows and adds the positions in
    ascending order, issuing ``group`` positions' loads for its rows before
    their adds (one way of FWD_WAYS); ``blocks`` blocks of ``threads``
    threads cover the ``ceil(B / rows) * E / vec`` threads. No shared
    memory."""
    vec: int
    rows: int
    group: int
    threads: int
    blocks: int


class DwPlan(NamedTuple):
    """How K4b runs one call. The counting sort cuts the batch into
    ``tiles`` tiles of ``tile_rows`` rows. A (tiles, K) grid of blocks
    counts each tile's ids of one position over V + 1 bins (the last for
    ids outside [0, V)), ``bin_range`` bins a pass; then a (tiles, K) grid
    of 1024-thread blocks scans the position's counts and places the
    tile's rows, with ``sort_smem`` bytes of shared memory (the tile's
    bins and the cursors). A one-tile batch whose bins fit one pass
    (``one_block``) skips the count kernel: its placing block counts. The
    row writer's first ``run_blocks`` blocks stride over the non-empty
    (k, v) rows and sum their runs, two column vectors a thread;
    ``zero_blocks`` more own ``zero_rows`` (k, v) rows each and zero the
    empty ones. The scratch is ``scratch`` int32: ``runs`` (K, min(V, B),
    4) — (v, start, end, 0) of each non-empty id, 16-byte aligned —;
    ``counts`` (K, tiles, V+1) (0 when ``one_block``); ``starts`` (K,
    V+1) run starts; ``order`` (K, B) batch rows sorted by id; then K run
    counts."""
    vec: int
    tile_rows: int
    tiles: int
    bin_range: int
    one_block: bool
    sort_smem: int
    zero_rows: int
    zero_blocks: int
    run_blocks: int
    runs: int
    counts: int
    starts: int
    order: int
    scratch: int


def _cdiv(n: int, m: int) -> int:
    return -(-n // m)


@functools.lru_cache(maxsize=256)
def fwd_plan(dtype, batch: int, positions: int, vocab: int, width: int,
             vec: int | None = None, rows: int | None = None,
             group: int | None = None) -> FwdPlan:
    """K4a's plan for (B, K, V, E) = (batch, positions, vocab, width) in
    ``dtype``; ``vec`` is the widest column vector the pointers allow
    (:func:`_vec`; by default that of aligned tensors). A thread owns 1
    row at small B and issues the loads of 24 positions at once; when the
    rows outnumber what the card holds at once, more rows (up to
    FWD_MAX_ROWS) with fewer positions' loads at a time (8 for one row), so
    the resident threads walk the positions together. When the grid would
    not give more
    than a quarter of the SMs a block, blocks narrow to 32 threads, then
    vectors to fewer columns. ``rows`` and ``group`` force a way of
    FWD_WAYS, to time one beside another."""
    check_table_dtype(dtype)
    if vec is None:
        vec = _vec(width, dtype.itemsize)
    nvec = max(1, width // vec)
    large = batch * nvec > FWD_RESIDENT
    if rows is None:
        rows = 1
        while (rows < FWD_MAX_ROWS[dtype]
               and batch * nvec > rows * FWD_RESIDENT):
            rows *= 2
    if group is None:
        group = FWD_GROUP[rows] if rows > 1 else 8 if large else 24
    if (rows, group) not in FWD_WAYS:
        raise ValueError(f"K4a has no way of {rows} rows x {group} "
                         f"positions; it has {FWD_WAYS}")
    threads = FWD_THREADS

    def blocks(threads, vec):
        return _cdiv(_cdiv(batch, rows) * (width // vec), threads)

    while threads > 32 and blocks(threads, vec) < SMS:
        threads //= 2
    while vec > 1 and 0 < blocks(threads, vec) <= SMS // 4:
        vec //= 2
    return FwdPlan(vec, rows, group, threads, blocks(threads, vec))


@functools.lru_cache(maxsize=256)
def dw_plan(dtype, batch: int, positions: int, vocab: int, width: int,
            vec: int | None = None) -> DwPlan:
    """K4b's plan for (B, K, V, E) in ``dtype``, as :func:`fwd_plan`.
    Any B and V: one tile up to 1024 rows, then up to SORT_TILES tiles of
    1024 to MAX_TILE_ROWS rows, then more tiles; bins in passes that fit
    MAX_SORT_SMEM beside the tile. ValueError only where an int32 index of the kernels
    would overflow (K * B, K * V or the scratch at 2^31, far past any
    tensor the card holds) or K exceeds MAX_POSITIONS."""
    check_table_dtype(dtype)
    if vec is None:
        vec = _vec(width, dtype.itemsize)
    k, v = positions, vocab
    if batch <= 1024:
        tile_rows = max(32, _cdiv(batch, 32) * 32)
    else:
        tile_rows = min(MAX_TILE_ROWS,
                        max(1024, _cdiv(_cdiv(batch, SORT_TILES), 32) * 32))
    tiles = max(1, _cdiv(batch, tile_rows))
    bins = v + 1
    bin_range = min(bins, MAX_SORT_SMEM // 4 - tile_rows)
    one_block = tiles == 1 and bins <= bin_range
    nvec = max(1, width // vec)
    zero_rows = max(1, WRITE_THREADS * WRITE_UNITS // nvec)
    cap = min(v, batch)
    run_blocks = max(1, min(RUN_BLOCKS,
                            _cdiv(k * cap * _cdiv(nvec, 2), WRITE_THREADS)))
    runs = 4 * k * cap
    counts = 0 if one_block else k * tiles * bins
    starts, order = k * bins, k * batch
    scratch = runs + counts + starts + order + k
    if max(k * batch, k * v, scratch) >= 2 ** 31 or k > MAX_POSITIONS:
        raise ValueError(f"K4b indexes in int32 and takes at most "
                         f"{MAX_POSITIONS} positions: (B, K, V) = ({batch}, "
                         f"{k}, {v}) is too large")
    return DwPlan(vec, tile_rows, tiles, bin_range, one_block,
                  4 * (tile_rows + bin_range), zero_rows,
                  _cdiv(k * v, zero_rows), run_blocks, runs, counts, starts,
                  order, scratch)


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
    # a fresh allocation is aligned to 512 bytes: only w limits the vector
    plan = fwd_plan(w.dtype, b, k, v, e, _vec(e, w.element_size(), w))
    WIDE_ONEHOT_FWD.launch(*_fwd_args(plan, w, ids, out))
    return out


@torch.library.custom_op("emtpu::wide_onehot_fwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def wide_onehot_fwd_op(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """:func:`wide_onehot_fwd` as a torch custom op
    (``emtpu::wide_onehot_fwd``): the one route from a model to K4a when
    nothing is differentiated — the eager serving programs and the programs
    compiled ahead of time (serve/aotstore.py), which keep it as an opaque
    call. The launch goes through :func:`wide_onehot_fwd`, so
    ``WIDE_ONEHOT_FWD.launches`` counts it wherever it runs."""
    return wide_onehot_fwd(w, ids)


@wide_onehot_fwd_op.register_fake
def _wide_onehot_fwd_fake(w, ids):
    # the kernel's output: a fresh contiguous (B, E) float32
    return w.new_empty((ids.shape[0], w.shape[2]), dtype=torch.float32)


def _fwd_args(plan: FwdPlan, w, ids, out) -> tuple:
    """K4a's C arguments for one call: the pointers, the shape, the dtype
    code, the plan's fields and the device."""
    k, v, e = w.shape
    return (w.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.shape[0], k, v,
            e, DTYPE_CODES[w.dtype], plan.vec, plan.rows, plan.group,
            plan.threads, plan.blocks, w.device.index)


def wide_onehot_dw(ids, dh, v: int):
    """The dense (K, V, E) gradient of the table in dh's dtype — K4b on
    CUDA tensors, the plain version on CPU tensors. Every row of the block
    comes from the kernel, zeros included: it is allocated empty."""
    check_table_dtype(dh.dtype)
    if dh.dim() != 2:
        raise ValueError(f"dh must be (B, E), got {tuple(dh.shape)}")
    _check_ids(ids, dh.shape[0])
    if _device_of(ids, dh).type == "cpu":
        return wide_onehot_dw_reference(ids, dh, v)
    b, k = ids.shape
    e = dh.shape[1]
    dw = torch.empty((k, v, e), dtype=dh.dtype, device=dh.device)
    plan = dw_plan(dh.dtype, b, k, v, e, _vec(e, dh.element_size(), dh))
    scratch = torch.empty((plan.scratch,), dtype=torch.int32,
                          device=dh.device)
    WIDE_ONEHOT_DW.launch(*_dw_args(plan, ids, dh, dw, scratch))
    return dw


def _dw_args(plan: DwPlan, ids, dh, dw, scratch, parts: int = DW_ALL
             ) -> tuple:
    """K4b's C arguments for one call: the pointers, the shape, the dtype
    code, the plan's fields, the parts to run and the device."""
    k, v, e = dw.shape
    return (ids.data_ptr(), dh.data_ptr(), dw.data_ptr(), scratch.data_ptr(),
            ids.shape[0], k, v, e, DTYPE_CODES[dh.dtype], plan.vec,
            plan.tile_rows, plan.tiles, plan.bin_range, plan.sort_smem,
            plan.zero_rows, plan.zero_blocks, plan.run_blocks, plan.scratch,
            parts, dh.device.index)


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
    """Σ_k onehot(ids[:, k], V) @ w[k] with the kernels' gradient: the
    Function when w is differentiated, else the custom op."""
    if torch.is_grad_enabled() and w.requires_grad:
        return WideOnehotMatmul.apply(w, ids)
    return wide_onehot_fwd_op(w, ids)

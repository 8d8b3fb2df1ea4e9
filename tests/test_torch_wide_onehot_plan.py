"""K4a's and K4b's launch plans (euromillioner_tpu_torch/ops/wide_onehot.py
``fwd_plan``, ``dw_plan``) and what the wrappers hand their C entry points.

The plans are pure Python, so these tests reach them on the CPU: at the
main paths' shapes (the serving buckets 8, 32 and 128, the training batch
64, bench.py's 8192), at a batch past the earlier K4b's limit (40000, F6)
and at the odd shape, the grids cover every output exactly once, small
batches spread over more than a quarter of the SMs with all of a row's
loads issued at once, large batches give each thread more rows, and the
counting sort's tiles, bin passes, shared memory and scratch follow the
layout the C source recomputes. A model of the counting sort in numpy
shows that the layout gives batch order within each id, over tiles and
bin passes. Stand-in CUDA tensors then show each wrapper passing the
plan's fields and scratch of the plan's size to its C entry point, one
counted launch per call, with K4b's block allocated empty. The kernels
themselves are held to their plain versions on the card by chip_smoke.py.
"""

import itertools

import numpy as np
import pytest
import torch

from euromillioner_tpu_torch.ops import wide_onehot as port

torch.set_num_threads(2)

DTYPES = (torch.float32, torch.bfloat16)
FULL = (21, 4096, 1040)  # the pair tables: K positions, V codes, width E
MAIN_BATCHES = (8, 32, 128, 64, 8192)
F6_BATCH = 40000
SHAPES = ([(b, *FULL) for b in MAIN_BATCHES + (F6_BATCH,)]
          + [(5, 3, 300, 20)])
CASES = list(itertools.product(SHAPES, DTYPES))
IDS = [f"{b}x{k}x{v}x{e}-{str(dt)[6:]}" for (b, k, v, e), dt in CASES]


def _cdiv(n, m):
    return -(-n // m)


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_fwd_plan_covers_every_output_once(shape, dtype):
    """A thread owns one column vector of ``rows`` consecutive batch rows:
    the grid has exactly enough threads for ceil(B / rows) x E / vec of
    them, blocks of 32 to 128 threads, and the vector divides E in at
    most 16 bytes."""
    b, k, v, e = shape
    plan = port.fwd_plan(dtype, b, k, v, e)
    assert e % plan.vec == 0 and plan.vec * dtype.itemsize <= 16
    assert (plan.rows, plan.group) in port.FWD_WAYS
    assert plan.rows * plan.group >= 8  # loads in flight per thread
    assert plan.threads in (32, 64, 128)
    units = _cdiv(b, plan.rows) * (e // plan.vec)
    assert (plan.blocks - 1) * plan.threads < units <= (plan.blocks
                                                         * plan.threads)
    # threads (g, c), c fastest: each (row, column) once
    if units <= 4096:
        owned = np.zeros((b, e), np.int64)
        for t in range(units):
            g, c = divmod(t, e // plan.vec)
            rows = slice(g * plan.rows, min(b, (g + 1) * plan.rows))
            owned[rows, c * plan.vec:(c + 1) * plan.vec] += 1
        assert (owned == 1).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", (8, 32, 64, 128))
def test_fwd_small_batches_spread_and_issue_every_load_at_once(dtype,
                                                               batch):
    """At the serving and training batches a thread owns one row and
    issues the loads of all 21 positions before its first add, and more
    than a quarter of the SMs get a block (narrower blocks, then narrower
    vectors, where 128-thread blocks would not give them one)."""
    plan = port.fwd_plan(dtype, batch, *FULL)
    assert plan.rows == 1 and plan.group >= FULL[0]
    assert plan.blocks > port.SMS // 4
    assert plan.threads < port.FWD_THREADS or plan.blocks >= port.SMS


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", (8192, F6_BATCH))
def test_fwd_large_batches_walk_positions_together(dtype, batch):
    """Past what the card holds at once a thread issues fewer positions'
    loads at a time: f32 threads own 8 rows and walk the positions one at
    a time; bf16 threads (whose sums take twice the registers) own one row
    and load 8 positions at a time; 128-thread blocks, 16-byte vectors."""
    plan = port.fwd_plan(dtype, batch, *FULL)
    assert plan.rows == port.FWD_MAX_ROWS[dtype]
    assert (plan.rows, plan.group) == {torch.float32: (8, 1),
                                       torch.bfloat16: (1, 8)}[dtype]
    assert plan.threads == 128 and plan.vec * dtype.itemsize == 16
    assert batch * FULL[2] // plan.vec > port.FWD_RESIDENT


@pytest.mark.parametrize("rows,group", port.FWD_WAYS)
def test_fwd_ways_can_be_forced(rows, group):
    """chip_smoke.py times every way beside the plan's; a way not in
    FWD_WAYS (no kernel instantiation) is refused."""
    plan = port.fwd_plan(torch.bfloat16, 8192, *FULL, rows=rows, group=group)
    assert (plan.rows, plan.group) == (rows, group)
    assert plan.blocks == _cdiv(_cdiv(8192, rows) * 130, plan.threads)
    with pytest.raises(ValueError, match="no way"):
        port.fwd_plan(torch.bfloat16, 8192, *FULL, rows=rows, group=3)


def test_fwd_plan_at_the_main_paths_bf16():
    """The plans chip_smoke.py times, pinned."""
    want = {8: (4, 1, 24, 32, 65), 32: (8, 1, 24, 32, 130),
            64: (8, 1, 24, 32, 260), 128: (8, 1, 24, 64, 260),
            8192: (8, 1, 8, 128, 8320)}
    for batch, fields in want.items():
        assert tuple(port.fwd_plan(torch.bfloat16, batch, *FULL)) == fields


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_dw_plan_layout(shape, dtype):
    """The sort's tiles cover the batch in whole warps (one tile up to 1024
    rows, else SORT_TILES tiles of 1024 to MAX_TILE_ROWS rows), its bins
    go in passes that fit MAX_SORT_SMEM beside the tile, a one-tile batch
    sorts in one launch, the writer's zeroing blocks cover the K x V rows
    and its run blocks fill the card at most once, and the scratch is
    runs (first, 16-byte aligned), counts, starts, order and run counts
    end to end."""
    b, k, v, e = shape
    plan = port.dw_plan(dtype, b, k, v, e)
    assert e % plan.vec == 0 and plan.vec * dtype.itemsize <= 16
    assert plan.tile_rows % 32 == 0
    assert 32 <= plan.tile_rows <= port.MAX_TILE_ROWS
    assert (plan.tiles - 1) * plan.tile_rows < b <= plan.tiles * plan.tile_rows
    assert plan.tiles == 1 if b <= 1024 else (
        plan.tiles <= port.SORT_TILES and plan.tile_rows >= 1024)
    assert plan.bin_range == min(v + 1, port.MAX_SORT_SMEM // 4
                                 - plan.tile_rows)
    assert plan.one_block == (plan.tiles == 1)  # V + 1 fits one pass here
    assert plan.sort_smem == 4 * (plan.tile_rows + plan.bin_range)
    assert plan.sort_smem <= port.MAX_SORT_SMEM
    nvec = e // plan.vec
    assert plan.zero_rows * nvec <= port.WRITE_THREADS * port.WRITE_UNITS
    assert (plan.zero_blocks - 1) * plan.zero_rows < k * v <= (
        plan.zero_blocks * plan.zero_rows)
    assert 1 <= plan.run_blocks <= port.RUN_BLOCKS
    # a run thread takes two column vectors of a row
    assert (plan.run_blocks - 1) * port.WRITE_THREADS < (
        k * min(v, b) * _cdiv(nvec, 2))
    assert plan.runs == 4 * k * min(v, b)  # (v, start, end, 0) each
    assert plan.counts == (0 if plan.one_block else k * plan.tiles * (v + 1))
    assert plan.starts == k * (v + 1)
    assert plan.order == k * b
    assert plan.scratch == (plan.runs + plan.counts + plan.starts
                            + plan.order + k)


def test_dw_plan_at_the_main_paths_bf16():
    """The plans chip_smoke.py times, pinned: the training batch sorts in
    one launch, bench.py's in 8 tiles of 1024 rows, B=40000 in 8 of 5024;
    the run blocks cover the most non-empty rows the batch can have (K x
    B), up to 8 an SM."""
    for batch, want in {64: (64, 1, True, 16644, 342),
                        8192: (1024, 8, False, 20484, 1056),
                        F6_BATCH: (5024, 8, False, 36484, 1056)}.items():
        plan = port.dw_plan(torch.bfloat16, batch, *FULL)
        assert (plan.tile_rows, plan.tiles, plan.one_block, plan.sort_smem,
                plan.run_blocks) == want
        assert (plan.vec, plan.zero_rows, plan.zero_blocks) == (8, 15, 5735)
    assert port.dw_plan(torch.bfloat16, 8, *FULL).run_blocks == 43


def test_dw_plan_passes_over_a_large_vocabulary():
    """A vocabulary whose bins do not fit beside the tile goes in passes:
    V = 40000 at B=8192 takes 3 passes of 15360 bins, and even one tile is
    counted by its own kernel then."""
    plan = port.dw_plan(torch.float32, 8192, 3, 40000, 16)
    assert plan.bin_range == 16384 - 1024 and not plan.one_block
    small = port.dw_plan(torch.float32, 64, 3, 40000, 16)
    assert small.tiles == 1 and not small.one_block
    assert small.counts == 3 * 1 * 40001


def test_dw_plan_accepts_batches_past_the_earlier_limit():
    """F6: the earlier K4b sorted a position's keys in one block's shared
    memory and refused B > 32768; the counting sort takes any batch: at
    B = 40000, 8 tiles of 5024 rows and 7.8 MB of scratch; a million rows
    in 123 tiles of 8192."""
    for dtype in DTYPES:
        plan = port.dw_plan(dtype, F6_BATCH, *FULL)
        assert plan.tiles == 8 and plan.tile_rows == 5024
        assert not plan.one_block
        assert plan.scratch * 4 < 7.9e6
        assert port.dw_plan(dtype, 1_000_000, *FULL).tiles == 123
    assert not hasattr(port, "MAX_DW_BATCH")


def test_dw_plan_refuses_only_int32_overflow():
    """The kernels index the scratch in int32: ten million rows plan (1.0e9
    scratch ints), a batch whose K x B order outgrows int32 does not."""
    assert port.dw_plan(torch.float32, 10_000_000, 21, 4096,
                        8).scratch < 2 ** 31
    with pytest.raises(ValueError, match="int32"):
        port.dw_plan(torch.float32, 2 ** 31 // 21 + 1, 21, 4096, 8)


def _counting_sort(ids, v, plan):
    """The counting sort as csrc/wide_onehot.cu runs it, in numpy: counts
    per (position, tile) over V + 1 bins in passes of bin_range; per
    position the bins' totals scanned from k * B in (bin, tile) order, the
    non-empty ids v < V listed; then each tile's rows placed in order at
    their bin's cursor, 32 at a time. Returns (order, starts, lists) as the
    row writer reads them."""
    b, k = ids.shape
    bins = v + 1
    binned = np.where((ids >= 0) & (ids < v), ids, v)
    counts = np.zeros((k, plan.tiles, bins), np.int64)
    for tile in range(plan.tiles):
        rows = binned[tile * plan.tile_rows:(tile + 1) * plan.tile_rows]
        for pos in range(k):
            for v0 in range(0, bins, plan.bin_range):
                n = min(plan.bin_range, bins - v0)
                local = rows[:, pos] - v0
                local = local[(local >= 0) & (local < n)]
                counts[pos, tile, v0:v0 + n] = np.bincount(local,
                                                           minlength=n)
    offs = np.zeros_like(counts)
    starts = np.zeros((k, bins), np.int64)
    lists = []
    for pos in range(k):
        totals = counts[pos].sum(axis=0)
        starts[pos] = pos * b + np.cumsum(totals) - totals
        offs[pos] = starts[pos] + np.cumsum(counts[pos], axis=0) - counts[pos]
        lists.append(np.flatnonzero(totals[:v]))
    order = np.full(k * b, -1, np.int64)
    for tile, pos in itertools.product(range(plan.tiles), range(k)):
        r0 = tile * plan.tile_rows
        for v0 in range(0, bins, plan.bin_range):
            n = min(plan.bin_range, bins - v0)
            cursor = offs[pos, tile, v0:v0 + n].copy()
            for chunk in range(r0, min(b, r0 + plan.tile_rows), 32):
                for row in range(chunk, min(b, r0 + plan.tile_rows,
                                            chunk + 32)):
                    local = binned[row, pos] - v0
                    if 0 <= local < n:
                        order[cursor[local]] = row
                        cursor[local] += 1
    return order, starts, lists


@pytest.mark.parametrize("b,v,tile_rows,bin_range", [
    (300, 50, 64, 51), (300, 50, 32, 16), (1000, 9, 1024, 10),
    (77, 400, 32, 100)])
def test_counting_sort_layout_gives_batch_order_within_each_id(
        b, v, tile_rows, bin_range):
    """Over several tiles and bin passes (ids outside [0, V) included),
    each position's order is its rows sorted by id, batch order within an
    id — a stable argsort — the run of id v is [starts[k, v], starts[k,
    v + 1]), and the list holds exactly the ids with a run, at most
    min(V, B) of them."""
    k = 3
    rng = np.random.default_rng(b + v)
    ids = rng.integers(-2, v + 2, size=(b, k)).astype(np.int32)
    ids[: b // 2, 1] = 3  # a long run across tiles
    plan = port.dw_plan(torch.float32, b, k, v, 16)._replace(
        tile_rows=tile_rows, tiles=_cdiv(b, tile_rows), bin_range=bin_range)
    order, starts, lists = _counting_sort(ids, v, plan)
    for pos in range(k):
        binned = np.where((ids[:, pos] >= 0) & (ids[:, pos] < v),
                          ids[:, pos], v)
        want = np.argsort(binned, kind="stable")
        np.testing.assert_array_equal(order[pos * b:(pos + 1) * b], want)
        for vv in range(v):
            run = order[starts[pos, vv]:starts[pos, vv + 1]]
            np.testing.assert_array_equal(run, np.flatnonzero(binned == vv))
        np.testing.assert_array_equal(lists[pos],
                                      np.unique(binned[binned < v]))
        assert len(lists[pos]) <= min(v, b)


# -- what the wrappers pass to the C entry points ----------------------------

class _CudaTensorLike:
    """What the wrappers read of a tensor, placed on a CUDA device (this
    CPU-only build cannot make a real one); each has its own address."""

    _next = 0x1000

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)
        _CudaTensorLike._next += 0x1000
        self.ptr = _CudaTensorLike._next

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.ptr

    def element_size(self):
        return self.dtype.itemsize


class _Entry:
    """Stands in for a C entry point: records its arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def card(monkeypatch):
    """Stand-in CUDA tensors, stream and C entry points; ``torch.zeros``
    refuses, so a wrapper that zero-fills fails. Returns the tensors the
    wrappers allocate, in order."""
    made = []

    def empty(shape, dtype=torch.float32, **kw):
        made.append(_CudaTensorLike(
            shape if isinstance(shape, tuple) else (shape,), dtype))
        return made[-1]

    def zeros(*args, **kw):
        raise AssertionError("K4's wrappers allocate with torch.empty")

    monkeypatch.setattr(port.torch, "empty", empty)
    monkeypatch.setattr(port.torch, "zeros", zeros)
    monkeypatch.setattr(port.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    for kernel in (port.WIDE_ONEHOT_FWD, port.WIDE_ONEHOT_DW):
        monkeypatch.setattr(kernel, "_fn", _Entry())
        # the counts go back after the test: other files read them from 0
        monkeypatch.setattr(kernel, "launches", kernel.launches)
    return made


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_forward_wrapper_passes_the_plan(card, shape, dtype):
    b, k, v, e = shape
    kernel = port.WIDE_ONEHOT_FWD
    before = kernel.launches
    w = _CudaTensorLike((k, v, e), dtype)
    ids = _CudaTensorLike((b, k), torch.int32)
    out = port.wide_onehot_fwd(w, ids)
    assert kernel.launches == before + 1
    (args,) = kernel._fn.calls
    assert card == [out]
    assert tuple(out.shape) == (b, e) and out.dtype == torch.float32
    plan = port.fwd_plan(dtype, b, k, v, e)
    assert len(args) == len(kernel.argtypes)
    assert args[:3] == (w.ptr, ids.ptr, out.ptr)
    assert args[3:9] == (b, k, v, e, port.DTYPE_CODES[dtype], plan.vec)
    assert args[9:13] == (plan.rows, plan.group, plan.threads, plan.blocks)
    assert args[13:] == (0, 7)  # device, then the current stream


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_dw_wrapper_passes_the_plan_and_scratch(card, shape, dtype):
    b, k, v, e = shape
    kernel = port.WIDE_ONEHOT_DW
    before = kernel.launches
    ids = _CudaTensorLike((b, k), torch.int32)
    dh = _CudaTensorLike((b, e), dtype)
    dw = port.wide_onehot_dw(ids, dh, v)
    assert kernel.launches == before + 1
    (args,) = kernel._fn.calls
    plan = port.dw_plan(dtype, b, k, v, e)
    assert card[0] is dw and tuple(dw.shape) == (k, v, e)
    assert dw.dtype == dtype
    scratch = card[1]
    assert tuple(scratch.shape) == (plan.scratch,)
    assert scratch.dtype == torch.int32
    assert len(args) == len(kernel.argtypes)
    assert args[:4] == (ids.ptr, dh.ptr, dw.ptr, scratch.ptr)
    assert args[4:10] == (b, k, v, e, port.DTYPE_CODES[dtype], plan.vec)
    assert args[10:18] == (plan.tile_rows, plan.tiles, plan.bin_range,
                           plan.sort_smem, plan.zero_rows, plan.zero_blocks,
                           plan.run_blocks, plan.scratch)
    assert args[18:] == (port.DW_ALL, 0, 7)


def test_dw_parts_select_the_sort_or_the_writer(card):
    """``_dw_args(..., parts)`` launches some of K4b's parts alone, for
    timing them apart: the sort's count (bit 1), its scan and place (2)
    and the row writer (4)."""
    ids = _CudaTensorLike((64, 21), torch.int32)
    dh = _CudaTensorLike((64, 1040), torch.bfloat16)
    dw = _CudaTensorLike((21, 4096, 1040), torch.bfloat16)
    plan = port.dw_plan(torch.bfloat16, 64, *FULL)
    scratch = _CudaTensorLike((plan.scratch,), torch.int32)
    assert (port.DW_COUNT, port.DW_PLACE, port.DW_WRITE) == (1, 2, 4)
    assert (port.DW_SORT, port.DW_ALL) == (3, 7)
    for parts in (port.DW_SORT, port.DW_WRITE, port.DW_COUNT):
        args = port._dw_args(plan, ids, dh, dw, scratch, parts)
        assert args[18] == parts and args[:18] == port._dw_args(
            plan, ids, dh, dw, scratch)[:18]


def test_misaligned_pointers_narrow_the_vector(card):
    """A table whose address is only 4-byte aligned gets 2-column bf16
    vectors in the plan the wrapper launches."""
    w = _CudaTensorLike((21, 4096, 1040), torch.bfloat16)
    w.ptr += 4
    ids = _CudaTensorLike((8192, 21), torch.int32)
    port.wide_onehot_fwd(w, ids)
    (args,) = port.WIDE_ONEHOT_FWD._fn.calls
    plan = port.fwd_plan(torch.bfloat16, 8192, *FULL, vec=2)
    assert args[8] == plan.vec == 2 and plan.blocks == 8192 * 520 // 128
    assert args[9:13] == (plan.rows, plan.group, plan.threads, plan.blocks)

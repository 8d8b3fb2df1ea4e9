"""K1's and K2's launch plan (euromillioner_tpu_torch/ops/fused_lstm.py
``lstm_plan``) and what the wrappers hand their C entry points.

The plan is pure Python, so these tests reach it on the CPU: every plan of
the main paths' shapes and of the odd widths fits a block, each hidden unit
is owned by exactly one CTA of a cluster, padded rows and units fall
outside the masks, the weight slice is resident or streamed by dtype and
width, and no width the kernels took before is refused. A stand-in CUDA
tensor then shows each wrapper passing the plan's fields and scratch of
the plan's sizes to its C entry point, one counted launch per call. The
kernels themselves are held to their plain versions on the card by
chip_smoke.py."""

import itertools

import pytest
import torch

from euromillioner_tpu_torch.ops import fused_lstm as port

torch.set_num_threads(2)

DTYPES = (torch.float32, torch.bfloat16)
# the main paths' batches at the flagship's width: the serving buckets 8,
# 32 and 128, the training batch 64 and bench.py's 2048
MAIN_BATCHES = (8, 32, 64, 128, 2048)
HIDDEN = 512
# odd widths: one CTA, padded units, and the widest the kernels took
# before the plan (MAX_HIDDEN_BWD was 1139)
ODD_HIDDEN = (8, 100, 1024, 1139)
SHAPES = ([(b, HIDDEN) for b in MAIN_BATCHES]
          + [(64, h) for h in ODD_HIDDEN] + [(8, h) for h in ODD_HIDDEN])
STEPS = 64


def _plans():
    for (batch, hidden), dtype, backward in itertools.product(
            SHAPES, DTYPES, (False, True)):
        yield batch, hidden, dtype, backward


@pytest.mark.parametrize("batch,hidden,dtype,backward", list(_plans()))
def test_plan_fits_a_block(batch, hidden, dtype, backward):
    """Every main-path and odd-width plan exists and fits the H100's
    opt-in shared memory, with at most 512 threads and the smem the C
    sources lay out."""
    plan = port.lstm_plan(dtype, batch, hidden, STEPS, backward)
    assert plan is not None
    assert plan.smem <= port.SMEM_PER_BLOCK == 232448
    assert plan.smem == port._smem(dtype == torch.bfloat16, backward,
                                   plan.rows, plan.units, plan.k_pad,
                                   plan.ktile, plan.slots, plan.splits,
                                   plan.resident)
    assert 0 < plan.threads <= 512 and plan.threads % 32 == 0 or (
        dtype == torch.float32 and plan.threads % 8 == 0)


@pytest.mark.parametrize("batch,hidden,dtype,backward", list(_plans()))
def test_each_unit_has_one_owner_and_padding_is_masked(batch, hidden, dtype,
                                                       backward):
    """CTA c of a cluster owns units [c*U, (c+1)*U): the cluster covers
    every unit exactly once, the padded units past H lie outside the
    kernels' ``unit < H`` masks (zero weights, zero h, no stores), and the
    batch tiles cover the batch with fewer than ``rows`` padded rows."""
    plan = port.lstm_plan(dtype, batch, hidden, STEPS, backward)
    assert 1 <= plan.cluster <= port.MAX_CLUSTER == 16
    assert plan.cluster & (plan.cluster - 1) == 0
    assert plan.units % 8 == 0
    owners = [c for c in range(plan.cluster)
              for u in range(c * plan.units, (c + 1) * plan.units)
              if u < hidden]
    assert len(owners) == hidden
    assert owners == sorted(owners)
    # U is the least multiple of 8 that covers H with the cluster
    assert plan.cluster * (plan.units - 8) < hidden <= (plan.cluster
                                                         * plan.units)
    assert plan.tiles * plan.rows >= batch > (plan.tiles - 1) * plan.rows
    assert plan.rows % (16 if dtype == torch.bfloat16 else 8) == 0
    assert plan.rows <= 64
    if not backward:  # the product's depth, padded to whole k-tiles
        assert plan.k_pad >= plan.cluster * plan.units
        assert plan.k_pad % plan.ktile == 0 and plan.ktile % 16 == 0
    else:             # one chunk of 4U gate columns per peer
        assert plan.ktile == 4 * plan.units
        assert plan.k_pad == plan.cluster * plan.ktile


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backward", (False, True))
def test_flagship_plans_split_wh_over_a_cluster(dtype, backward):
    """At H=512 every main-path batch, the serving bucket of 8 and
    bench.py's 2048 included, runs on clusters of 16 CTAs of 32 units; a
    bf16 tile is mma's 16-row blocks up to 64 rows, an f32 tile no more
    rows than the batch (8 at B=8)."""
    for batch in MAIN_BATCHES:
        plan = port.lstm_plan(dtype, batch, HIDDEN, STEPS, backward)
        assert (plan.cluster, plan.units) == (16, 32)
        step = 16 if dtype == torch.bfloat16 else 8
        assert plan.rows == min(64, -(-batch // step) * step)
    assert port.lstm_plan(torch.float32, 8, HIDDEN).rows == 8


@pytest.mark.parametrize("hidden,dtype,backward,resident", [
    (512, torch.bfloat16, False, True), (512, torch.bfloat16, True, True),
    (512, torch.float32, False, False), (512, torch.float32, True, False),
    (8, torch.float32, False, True), (8, torch.bfloat16, True, True),
    (100, torch.float32, True, True), (100, torch.bfloat16, False, True),
    (1024, torch.bfloat16, False, False), (1139, torch.bfloat16, True, False),
    (1139, torch.float32, False, False), (1139, torch.float32, True, False)])
def test_resident_or_streamed_follows_dtype_and_width(hidden, dtype, backward,
                                                      resident):
    """bf16 keeps the flagship's wh slice (128 KiB) resident; f32's (256
    KiB) is streamed (K1: a ring of 2 to 6 k-tiles; K2: one chunk per peer
    beside its dgates chunk); small widths are resident in either dtype,
    the widest streamed in both."""
    plan = port.lstm_plan(dtype, 64, hidden, STEPS, backward)
    assert plan.resident is resident
    if backward:
        assert 2 <= plan.slots <= 6
    else:
        tiles = plan.k_pad // plan.ktile
        assert plan.slots == tiles if resident else 2 <= plan.slots <= 6


@pytest.mark.parametrize("dtype", DTYPES)
def test_refuses_no_width_the_kernels_took(dtype):
    """Every H up to 1139 (the earlier kernels' MAX_HIDDEN_BWD) has a plan
    both ways at every batch tile, and kernel_refusal passes it; the cap
    derives from the plan."""
    assert min(port.MAX_HIDDEN, port.MAX_HIDDEN_BWD) >= 1139
    for hidden in range(1, 1140):
        assert port.kernel_refusal(dtype, hidden) is None, hidden
    for hidden in (1, 7, 8, 9, 33, 100, 511, 512, 513, 1000, 1139):
        for batch in (1, 8, 64, 2048):
            for backward in (False, True):
                assert port.lstm_plan(dtype, batch, hidden, 3,
                                      backward) is not None, (hidden, batch)
    cap = min(port.MAX_HIDDEN, port.MAX_HIDDEN_BWD)
    assert "shared-memory cap" in port.kernel_refusal(dtype, cap + 1)


def test_f32_depth_split_fills_a_serving_bucket():
    """An 8-row f32 tile has 32 (unit, row-group) threads a CTA; the plan
    splits the depth 8 ways (a fixed order of partial sums), so each CTA
    runs 256 threads. At 64 rows no split is needed."""
    small = port.lstm_plan(torch.float32, 8, HIDDEN)
    assert (small.splits, small.threads) == (8, 256)
    assert small.ktile % small.splits == 0
    big = port.lstm_plan(torch.float32, 64, HIDDEN)
    assert (big.splits, big.threads) == (1, 256)


def test_dwh_split_covers_the_card():
    """K2's dwh at bench.py's B=2048: 64 output tiles of 128 x 128 x 4
    slices of R = 63 * 2048 rows = 256 CTAs (two waves of 132 SMs); a
    one-step call (R = 0) keeps one slice."""
    plan = port.lstm_plan(torch.bfloat16, 2048, HIDDEN, STEPS, True)
    assert plan.dwh_split == 4
    assert 64 * plan.dwh_split >= 132
    assert port.lstm_plan(torch.float32, 64, HIDDEN, STEPS,
                          True).dwh_split == 4
    assert port.lstm_plan(torch.bfloat16, 8, HIDDEN, 1, True).dwh_split == 1


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

    def zero_(self):
        return self


class _Entry:
    """Stands in for a C entry point: records its arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def card(monkeypatch):
    """Stand-in CUDA tensors and a stand-in stream; returns the tensors
    the wrappers allocate, in order."""
    made = []

    def empty(shape, dtype=torch.float32, **kw):
        made.append(_CudaTensorLike(shape, dtype))
        return made[-1]

    def empty_like(t, **kw):
        made.append(_CudaTensorLike(t.shape, t.dtype))
        return made[-1]

    monkeypatch.setattr(port.torch, "empty", empty)
    monkeypatch.setattr(port.torch, "empty_like", empty_like)
    monkeypatch.setattr(port.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    return made


def _loaded(monkeypatch, kernel):
    entry = _Entry()
    monkeypatch.setattr(kernel, "_fn", entry)
    return entry


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch,steps,hidden", [(8, 8, 512), (2048, 64, 512),
                                                (5, 3, 100)])
@pytest.mark.parametrize("residuals", (False, True))
def test_forward_wrapper_passes_the_plan(card, monkeypatch, dtype, batch,
                                         steps, hidden, residuals):
    kernel = port._FWD_KERNELS[dtype]
    entry = _loaded(monkeypatch, kernel)
    before = kernel.launches
    x_proj = _CudaTensorLike((steps, batch, 4 * hidden), dtype)
    wh = _CudaTensorLike((hidden, 4 * hidden), dtype)
    peep = _CudaTensorLike((4, hidden), torch.float32)
    run = port.lstm_forward if residuals else port.lstm_sequence
    run(x_proj, wh, peep, True)
    assert kernel.launches == before + 1
    (args,) = entry.calls
    plan = port.lstm_plan(dtype, batch, hidden)
    hs = card[0]
    assert tuple(hs.shape) == (steps, batch, hidden) and hs.dtype == dtype
    assert args[:4] == (x_proj.ptr, wh.ptr, peep.ptr, hs.ptr)
    if residuals:
        assert args[4:6] == (card[1].ptr, card[2].ptr)
        assert tuple(card[2].shape) == tuple(x_proj.shape)
    else:
        assert args[4:6] == (None, None) and len(card) == 1
    assert args[6:10] == (steps, batch, hidden, 1)
    assert args[10:19] == (plan.cluster, plan.rows, plan.units, plan.k_pad,
                           plan.ktile, plan.slots, plan.splits, plan.threads,
                           plan.smem)
    assert args[19:] == (0, 7)  # device, then the current stream


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch,steps,hidden", [(64, 64, 512),
                                                (2048, 64, 512),
                                                (5, 3, 100), (4, 1, 512)])
def test_backward_wrapper_passes_the_plan_and_scratch(card, monkeypatch,
                                                      dtype, batch, steps,
                                                      hidden):
    kernel = port._BWD_KERNELS[dtype]
    entry = _loaded(monkeypatch, kernel)
    before = kernel.launches
    res = tuple(_CudaTensorLike(s, dtype) for s in (
        (steps, batch, hidden), (steps, batch, hidden),
        (steps, batch, 4 * hidden)))
    wh = _CudaTensorLike((hidden, 4 * hidden), dtype)
    peep = _CudaTensorLike((4, hidden), torch.float32)
    g_hs = _CudaTensorLike((steps, batch, hidden), dtype)
    dxp, dwh, dpeep = port.lstm_backward(wh, peep, res, g_hs, True)
    assert kernel.launches == before + 1
    (args,) = entry.calls
    plan = port.lstm_plan(dtype, batch, hidden, steps, backward=True)
    dwh_part, dpeep_part = card[3], card[4]
    assert tuple(dwh_part.shape) == (plan.dwh_split, hidden, 4 * hidden)
    assert tuple(dpeep_part.shape) == (plan.tiles, 3,
                                       plan.cluster * plan.units)
    assert dwh_part.dtype == dpeep_part.dtype == torch.float32
    assert args[:11] == (g_hs.ptr, res[0].ptr, res[1].ptr, res[2].ptr,
                         wh.ptr, peep.ptr, dxp.ptr, dwh.ptr, dpeep.ptr,
                         dwh_part.ptr, dpeep_part.ptr)
    assert (dxp.dtype, dwh.dtype, dpeep.dtype) == (dtype, dtype,
                                                   torch.float32)
    assert args[11:15] == (steps, batch, hidden, 1)
    assert args[15:24] == (plan.cluster, plan.rows, plan.units,
                           int(plan.resident), plan.slots, plan.splits,
                           plan.threads, plan.smem, plan.dwh_split)
    assert args[24:] == (port.BWD_ALL, 0, 7)


@pytest.mark.parametrize("dtype", DTYPES)
def test_empty_calls_launch_nothing(card, monkeypatch, dtype):
    """T = 0 or B = 0: outputs of the right shapes, no launch counted."""
    fwd = _loaded(monkeypatch, port._FWD_KERNELS[dtype])
    bwd = _loaded(monkeypatch, port._BWD_KERNELS[dtype])
    counts = (port._FWD_KERNELS[dtype].launches,
              port._BWD_KERNELS[dtype].launches)
    hidden = 16
    x_proj = _CudaTensorLike((0, 4, 4 * hidden), dtype)
    wh = _CudaTensorLike((hidden, 4 * hidden), dtype)
    peep = _CudaTensorLike((4, hidden), torch.float32)
    port.lstm_forward(x_proj, wh, peep, True)
    res = tuple(_CudaTensorLike(s, dtype) for s in (
        (3, 0, hidden), (3, 0, hidden), (3, 0, 4 * hidden)))
    port.lstm_backward(wh, peep, res, _CudaTensorLike((3, 0, hidden), dtype))
    assert (fwd.calls, bwd.calls) == ([], [])
    assert (port._FWD_KERNELS[dtype].launches,
            port._BWD_KERNELS[dtype].launches) == counts


def test_max_active_clusters_queries_the_plan(monkeypatch):
    """The occupancy entry point of the plan's instantiation gets the
    plan's fields and the device, and counts no launch."""
    calls = []

    def query(symbol, argtypes, *args):
        calls.append((symbol, len(argtypes), args))
        return 7

    for dtype, backward in itertools.product(DTYPES, (False, True)):
        kernel = (port._BWD_KERNELS if backward else port._FWD_KERNELS)[dtype]
        monkeypatch.setattr(kernel, "query", query)
        before = kernel.launches
        plan = port.lstm_plan(dtype, 64, HIDDEN, STEPS, backward)
        assert port.max_active_clusters(dtype, plan, backward) == 7
        assert kernel.launches == before
        symbol, nargs, args = calls[-1]
        suffix = "bf16" if dtype == torch.bfloat16 else "f32"
        assert symbol == (f"emt_lstm_max_clusters_"
                          f"{'bwd' if backward else 'fwd'}_{suffix}")
        assert args == port.plan_args(plan, backward)[:nargs - 1] + (0,)

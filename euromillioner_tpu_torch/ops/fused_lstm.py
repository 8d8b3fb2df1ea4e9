"""Fused LSTM sequence kernels: the whole time loop in one launch each way.

Two CUDA kernels replace the JAX package's Pallas TPU pair in
``euromillioner_tpu/ops/fused_lstm.py`` (each source's note gives its
design and bound):

* K1, ``csrc/fused_lstm.cu`` (``_fwd_kernel``, :88): a peephole LSTM over
  ``x_proj`` (T, B, 4H) from a zero carry, with the recurrent product
  inside the kernel; serving runs it forward-only, training also writes
  the residuals (cs and the activated gates).
* K2, ``csrc/fused_lstm_bwd.cu`` (``_bwd_kernel``, :175): the reverse-time
  backward from those residuals — dxp, dwh and dpeep, all computed by
  hand-written code.

Both run a batch tile on a thread-block cluster that splits wh by hidden
unit; :func:`lstm_plan` gives every size of a call (pure Python, so the CPU
tests reach it) and the C sources refuse a plan they would lay out
otherwise.

:class:`LSTMSequence` joins them as one ``torch.autograd.Function``, as
``jax.custom_vjp`` joins the Pallas pair.

The device rule: for a CPU tensor the wrappers take the plain versions,
:func:`lstm_sequence_reference` and :func:`lstm_backward_reference`; for a
CUDA tensor they launch the kernel or raise — no fallback.

The dtype contract is the Pallas pair's: x_proj, wh and the residuals
share one dtype, float32 or bfloat16; peep is always float32; the (h, c)
carry, the accumulation, dwh's sum and dpeep are float32; dxp comes back
in the residuals' dtype and dwh in wh's. Each dtype has its own C entry
point and launch counter (``FUSED_LSTM_FWD`` / ``FUSED_LSTM_FWD_BF16``,
``FUSED_LSTM_BWD`` / ``FUSED_LSTM_BWD_BF16``), so a run can show which
instantiation its path launched. Any other dtype on CUDA raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from euromillioner_tpu_torch.nn.recurrent import lstm_cell
from euromillioner_tpu_torch.ops.common import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int

# K1's entry points and launch counters (``FUSED_LSTM_FWD.launches``): 6
# pointers, T, B, H, peepholes, the plan's cluster, rows, units, k_pad,
# ktile, slots, splits, threads, smem, then device and stream
_FWD_ARGS = [_P] * 6 + [_I] * 14 + [_P]
FUSED_LSTM_FWD = CudaKernel("fused_lstm.cu", "emt_lstm_fwd_f32", _FWD_ARGS)
FUSED_LSTM_FWD_BF16 = CudaKernel("fused_lstm.cu", "emt_lstm_fwd_bf16",
                                 _FWD_ARGS)

# K2's: 11 pointers (inputs, outputs, and two f32 scratch buffers: dwh's
# per-slice partial sums and dpeep's per-tile ones), T, B, H, peepholes,
# the plan's cluster, rows, units, resident, slots, splits, threads, smem,
# dwh_split, the parts to run (``BWD_ALL``), then device and stream
_BWD_ARGS = [_P] * 11 + [_I] * 15 + [_P]
FUSED_LSTM_BWD = CudaKernel("fused_lstm_bwd.cu", "emt_lstm_bwd_f32",
                            _BWD_ARGS)
FUSED_LSTM_BWD_BF16 = CudaKernel("fused_lstm_bwd.cu", "emt_lstm_bwd_bf16",
                                 _BWD_ARGS)
# K2's parts: the recurrence (dxp and dpeep's tile partials), dwh (the
# split product and its reduction) and dpeep's reduction; the wrapper
# runs all three, chip_smoke.py times them apart
BWD_RECURRENCE, BWD_DWH, BWD_DPEEP = 1, 2, 4
BWD_ALL = BWD_RECURRENCE | BWD_DWH | BWD_DPEEP

# the instantiation each compute dtype launches
_FWD_KERNELS = {torch.float32: FUSED_LSTM_FWD,
                torch.bfloat16: FUSED_LSTM_FWD_BF16}
_BWD_KERNELS = {torch.float32: FUSED_LSTM_BWD,
                torch.bfloat16: FUSED_LSTM_BWD_BF16}

# -- the launch plan ---------------------------------------------------------
# The C sources compute every shared-memory offset from the same fields
# and refuse a launch whose ``smem`` differs from theirs.
SMEM_PER_BLOCK = 232448     # the H100's opt-in shared memory per block
MAX_CLUSTER = 16            # non-portable cluster size (portable: 8)
STREAM_SLOTS = range(6, 1, -1)  # ring depths of a streamed weight slice
_SMS = 132                  # the H100 SXM's SMs: the dwh grid covers them
_WARPS_BF16 = 16            # a bf16 CTA's warps: one 16-row x 8-unit tile each
_MAX_THREADS_F32 = 256


class Plan(NamedTuple):
    """How K1 or K2 runs one call. A cluster of ``cluster`` CTAs shares a
    tile of ``rows`` batch rows; CTA c owns the hidden units ``[c *
    units, (c + 1) * units)`` — all four gates of each — so the cluster
    owns ``cluster * units >= H`` units, the padded ones masked. Its slice
    of wh (K1: the 4 * units gate columns of its units, k_pad deep, in
    ``ktile``-row tiles; K2: its units' rows of wh, one ``ktile`` = 4 *
    units wide chunk per peer) is ``resident`` in shared memory for the
    whole call, or streamed from L2. Each step the CTAs share h (K1) or
    dgates (K2) through the rows they write (hs, dxp), read back from L2
    after one cluster barrier. K1 holds ``slots`` weight tiles (all of
    them when resident, else a ring of 2 to 6); K2's ring of ``slots``
    dgates chunks (with their weight chunks when streamed) runs within a
    step. f32 CTAs split the product's depth among ``splits`` thread
    groups, summed in a fixed order; bf16 CTAs run it on the tensor cores
    (``mma.sync``), 16 warps. ``tiles`` batch tiles make the grid:
    ``tiles * cluster`` CTAs. K2's ``dwh`` sums the (T - 1) * B rows in
    ``dwh_split`` slices (1 for K1)."""
    cluster: int
    rows: int
    units: int
    k_pad: int
    resident: bool
    ktile: int
    slots: int
    splits: int
    threads: int
    smem: int
    tiles: int
    dwh_split: int


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def _smem(bf16: bool, backward: bool, rows: int, units: int, k_pad: int,
          ktile: int, slots: int, splits: int, resident: bool = True) -> int:
    """Shared memory per CTA, in bytes, as the C sources lay it out."""
    u4 = 4 * units
    if not backward:
        if bf16:   # h_prev [rows][k_pad + 8]; weight tiles; the step's h,
            # c and gates staged for 16-byte stores
            return 2 * (rows * (k_pad + 8) + slots * ktile * u4
                        + 6 * rows * units)
        # h_prev [rows][k_pad]; weight tiles; split partials
        return 4 * (k_pad * rows + slots * ktile * u4
                    + (splits - 1) * rows * u4)
    chunks = k_pad // ktile if resident else slots
    if bf16:       # weight chunks [U][4U + 8]; the ring of dgates chunks
        # (4 gate tiles [rows][U] a slot, 1024-byte aligned, with 1024 bytes
        # of room to align the base), which also holds the own dgates and
        # the depth groups' sums
        return (-(-2 * chunks * units * (u4 + 8) // 1024) * 1024
                + slots * 8 * rows * units + 1024)
    # weight chunks [U][4U + 4]; the ring of dgates chunks; split partials
    return 4 * (chunks * units * (u4 + 4) + slots * rows * u4
                + (splits - 1) * rows * units)


def _bwd_kgroups(rows: int, units: int) -> int:
    """A bf16 K2 CTA's depth groups: its 16 warps over 16-row blocks x
    passes of 32 units x groups, no more groups than k16 steps in a chunk
    (csrc/fused_lstm_bwd.cu ``bwd_kgroups``)."""
    return min(16 // ((rows // 16) * -(-units // 32)), units // 4)


def lstm_plan(dtype, batch: int, hidden: int, steps: int = 1,
              backward: bool = False) -> Plan | None:
    """The launch plan of K1 (``backward=False``) or K2 for a call of
    ``steps`` x ``batch`` x ``hidden`` in ``dtype`` (float32 or bfloat16);
    None when no plan fits a block (then :func:`kernel_refusal` says so).

    The cluster is the least power of two giving each CTA at most ~H / 16
    units, at least 8 (H = 512: 16 CTAs of 32 units; clusters of 8 were
    no faster for K2 and slower for K1 on the card, chip_smoke.py's
    ``LSTM_WAYS`` lines). A bf16 tile is 64 rows (``mma.sync``'s 16-row
    tiles, one a warp), fewer for a small batch or wide CTAs; an f32 tile
    at most 64 rows, a multiple of 8, so a serving bucket of 8 pays for 8.
    The wh slice is resident when it fits beside the rest, else streamed.
    f32 CTAs under 256 threads split the depth (up to 8 ways) to fill the
    SM."""
    cluster = 1
    while cluster < MAX_CLUSTER and cluster * 8 < hidden:
        cluster *= 2
    return _plan(dtype, batch, hidden, steps, backward, cluster)


def _plan(dtype, batch: int, hidden: int, steps: int, backward: bool,
          cluster: int) -> Plan | None:
    """:func:`lstm_plan` on a given cluster of CTAs (a power of two up to
    16)."""
    bf16 = dtype == torch.bfloat16
    units = _ceil(-(-hidden // cluster), 8)
    u4 = 4 * units
    if backward:
        k_pad, ktile, tiles_k = 4 * cluster * units, u4, cluster
    else:
        ktile = min(64 if bf16 else 32, _ceil(cluster * units, 16))
        k_pad = _ceil(cluster * units, ktile)
        tiles_k = k_pad // ktile
    if bf16:
        if units // 8 > _WARPS_BF16:
            return None
        # 16-row tiles: one warp each per 8 units, 16 warps
        candidates = [16 * min(4, _WARPS_BF16 // (units // 8),
                               -(-max(batch, 1) // 16))]
    else:
        rows = min(64, _ceil(max(batch, 1), 8))
        candidates = list(range(rows, 0, -8))
    for rows in candidates:
        if bf16:
            threads, splits = 32 * _WARPS_BF16, 1
        else:
            base = rows // 8 * units
            if base > _MAX_THREADS_F32:
                continue
            # a group's depth is a multiple of 4 (a float4 of h or dgates)
            splits = 1
            while (splits < 8 and 2 * splits * base <= 256
                   and ktile % (8 * splits) == 0):
                splits *= 2
            threads = splits * base
        if backward:  # the dgates ring's depth, wh resident or streamed
            ways = [(r, n) for r in (True, False) for n in (6, 5, 4, 3, 2)]
        else:
            ways = [(True, tiles_k), *((False, n) for n in STREAM_SLOTS)]
        for resident, slots in ways:
            if (backward and bf16
                    and _bwd_kgroups(rows, units) > 2 * (slots - 1)):
                continue  # the depth groups' sums need slots - 1 slots
            smem = _smem(bf16, backward, rows, units, k_pad, ktile, slots,
                         splits, resident)
            if smem <= SMEM_PER_BLOCK:
                tiles = -(-max(batch, 1) // rows)
                return Plan(cluster, rows, units, k_pad, resident, ktile,
                            slots, splits, threads, smem, tiles,
                            _dwh_split(bf16, (steps - 1) * batch, hidden)
                            if backward else 1)
    return None


def _dwh_split(bf16: bool, r: int, hidden: int) -> int:
    """Slices of dwh's R = (T - 1) * B rows: enough for the grid of 128 x
    128 output tiles to cover two waves of the card's SMs, no more slices
    than blocks of rows (64 a block in bf16, 16 in f32)."""
    tiles = -(-hidden // 128) * -(-4 * hidden // 128)
    blocks = -(-r // (64 if bf16 else 16))
    return max(1, min(blocks, 2 * _SMS // tiles))


def _max_hidden(backward: bool) -> int:
    """The widest H both dtypes plan for at the smallest batch tile."""
    lo, hi = 8, 4096
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if all(lstm_plan(dt, 8, mid, 2, backward) is not None
               for dt in (torch.float32, torch.bfloat16)):
            lo = mid
        else:
            hi = mid - 1
    return lo


MAX_HIDDEN = _max_hidden(False)
MAX_HIDDEN_BWD = _max_hidden(True)


def kernel_refusal(dtype, hidden: int) -> str | None:
    """Why K1 and K2 together cannot run an LSTM layer of this compute
    dtype and hidden width on the card, with what to change; None when
    they can."""
    if dtype not in _FWD_KERNELS:
        return (f"the CUDA LSTM kernels take float32 or bfloat16, not "
                f"{dtype}: set model.compute_dtype to one of them, or build "
                f"the layer with fused='off' to scan")
    cap = min(MAX_HIDDEN, MAX_HIDDEN_BWD)
    if hidden > cap:
        return (f"hidden {hidden} exceeds the CUDA LSTM kernels' "
                f"shared-memory cap of {cap}: use a narrower layer, or "
                f"build it with fused='off' to scan")
    return None


def plan_args(plan: Plan, backward: bool) -> tuple[int, ...]:
    """The plan's fields as its C entry point takes them."""
    if backward:
        return (plan.cluster, plan.rows, plan.units, int(plan.resident),
                plan.slots, plan.splits, plan.threads, plan.smem,
                plan.dwh_split)
    return (plan.cluster, plan.rows, plan.units, plan.k_pad, plan.ktile,
            plan.slots, plan.splits, plan.threads, plan.smem)


def max_active_clusters(dtype, plan: Plan, backward: bool = False,
                        device: int = 0) -> int:
    """``cudaOccupancyMaxActiveClusters`` for the plan's recurrence kernel
    on ``device``: how many of its clusters the card holds at once (0: it
    cannot be placed). Builds the library; launches nothing."""
    kernel = (_BWD_KERNELS if backward else _FWD_KERNELS)[dtype]
    symbol = kernel.symbol.replace("emt_lstm_", "emt_lstm_max_clusters_")
    args = plan_args(plan, backward)[:8 if backward else 9]
    return kernel.query(symbol, [_I] * (len(args) + 1), *args, device)


def lstm_sequence_reference(x_proj, wh, peep, peepholes: bool = True):
    """The plain version: a Python loop of the cell step over ``x_proj``
    (T, B, 4H) from a zero carry, with the kernels' arithmetic in either
    dtype (the JAX package's ``_fwd_kernel``): the (h, c) carry in f32,
    ``x_proj[t]`` read up to f32, h rounded to wh's dtype as the operand
    of the recurrent product, which sums in f32, and f32 peepholes.
    Returns ``(hs, cs, gates)`` — (T, B, H), (T, B, H) and the activated
    gates [i, f, g, o] (T, B, 4H) — rounded to ``x_proj``'s dtype. In f32
    every cast is a no-op and this is the scan's step."""
    t, b, four_h = x_proj.shape
    h = four_h // 4
    dt, f32 = x_proj.dtype, torch.float32
    p = peep.to(f32)
    p = (p[0], p[1], p[2]) if peepholes else None
    wh_f = wh.to(f32)
    h_prev = torch.zeros((b, h), dtype=f32, device=x_proj.device)
    c_prev = torch.zeros_like(h_prev)
    hs, cs, gates = [], [], []
    for k in range(t):
        # bf16 operands are exact in f32, so the f32 product of the
        # rounded h and wh is the kernels' bf16 product with f32 sums
        h_prev, c_prev, act = lstm_cell(x_proj[k].to(f32),
                                        h_prev.to(wh.dtype).to(f32), c_prev,
                                        wh_f, p)
        hs.append(h_prev.to(dt))
        cs.append(c_prev.to(dt))
        gates.append(torch.cat(act, dim=-1).to(dt))
    return torch.stack(hs), torch.stack(cs), torch.stack(gates)


def lstm_backward_reference(wh, peep, residuals, g_hs,
                            peepholes: bool = True):
    """The plain version of the backward, written out step by step as the
    JAX package's ``_bwd`` is: walk time in reverse from zero dh/dc
    carries, form the gate gradients from the residuals ``(hs, cs,
    gates)``, carry ``dh = dgates . wh^T``, sum the peephole gradients,
    then ``dwh = sum_t h_prev^T . dgates`` as one product. Returns
    ``(dxp, dwh, dpeep)``: dxp (T, B, 4H) in hs's dtype, dwh and dpeep
    accumulated in f32 and cast to wh's and peep's dtypes."""
    hs, cs, gates = residuals
    t, b, h = hs.shape
    f32 = torch.float32
    dev = hs.device
    p = peep.to(f32)
    wh_f = wh.to(f32)
    dh_carry = torch.zeros((b, h), dtype=f32, device=dev)
    dc_carry = torch.zeros_like(dh_carry)
    dpeep = torch.zeros((4, h), dtype=f32, device=dev)
    dxp = torch.empty((t, b, 4 * h), dtype=hs.dtype, device=dev)
    for k in reversed(range(t)):
        i, f, g, o = gates[k].to(f32).split(h, dim=-1)
        c = cs[k].to(f32)
        c_prev = cs[k - 1].to(f32) if k else torch.zeros_like(c)
        tanh_c = torch.tanh(c)
        dh = g_hs[k].to(f32) + dh_carry
        do_pre = dh * tanh_c * o * (1.0 - o)
        dc = dh * o * (1.0 - tanh_c * tanh_c) + dc_carry
        if peepholes:
            dc = dc + do_pre * p[2]
        di_pre = dc * g * i * (1.0 - i)
        df_pre = dc * c_prev * f * (1.0 - f)
        dg_pre = dc * i * (1.0 - g * g)
        dc_prev = dc * f
        if peepholes:
            dc_prev = dc_prev + di_pre * p[0] + df_pre * p[1]
            dpeep[0] += (di_pre * c_prev).sum(dim=0)
            dpeep[1] += (df_pre * c_prev).sum(dim=0)
            dpeep[2] += (do_pre * c).sum(dim=0)
        dgates = torch.cat([di_pre, df_pre, dg_pre, do_pre], dim=-1)
        dxp[k] = dgates.to(dxp.dtype)
        # operands rounded to wh's dtype, f32 accumulation
        dh_carry = dgates.to(wh.dtype).to(f32) @ wh_f.T
        dc_carry = dc_prev
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
    dwh = h_prev.reshape(t * b, h).to(f32).T @ dxp.reshape(t * b, 4 * h).to(f32)
    return dxp, dwh.to(wh.dtype), dpeep.to(peep.dtype)


def _check(x_proj, wh, peep) -> tuple[int, int, int]:
    if x_proj.dim() != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"x_proj must be (T, B, 4H), got {tuple(x_proj.shape)}")
    t, b, four_h = x_proj.shape
    h = four_h // 4
    if tuple(wh.shape) != (h, four_h):
        raise ValueError(f"wh must be ({h}, {four_h}), got {tuple(wh.shape)}")
    if tuple(peep.shape) != (4, h):
        raise ValueError(f"peep must be (4, {h}), got {tuple(peep.shape)}")
    return t, b, h


def _check_cuda(device, named) -> torch.dtype:
    """The kernels' contract for CUDA tensors: ``named`` is ``(name,
    tensor)`` pairs, the first setting the compute dtype (float32 or
    bfloat16) that every other tensor shares except ``peep``, which is
    float32; all on one device, dense. Raises; never casts. Returns the
    compute dtype."""
    dtype = named[0][1].dtype
    if dtype not in _FWD_KERNELS:
        raise TypeError(f"the fused LSTM kernels take float32 or bfloat16; "
                        f"{named[0][0]} is {dtype}")
    for name, a in named:
        want = torch.float32 if name == "peep" else dtype
        if a.dtype != want:
            raise TypeError(f"{name} is {a.dtype}; the fused LSTM kernels "
                            f"take it as {want} with {named[0][0]} in "
                            f"{dtype}")
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, expected {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dtype


def _fwd(x_proj, wh, peep, peepholes: bool, residuals: bool):
    """Run the forward kernel; ``residuals`` also writes cs and gates.
    Returns ``(hs, cs, gates)`` with None for residuals not asked for."""
    t, b, h = _check(x_proj, wh, peep)
    if x_proj.device.type == "cpu":
        hs, cs, gates = lstm_sequence_reference(x_proj, wh, peep, peepholes)
        return (hs, cs, gates) if residuals else (hs, None, None)
    if x_proj.device.type != "cuda":
        raise ValueError(f"unsupported device {x_proj.device}")
    dtype = _check_cuda(x_proj.device,
                        (("x_proj", x_proj), ("wh", wh), ("peep", peep)))
    plan = lstm_plan(dtype, b, h)
    if plan is None or h > MAX_HIDDEN:
        raise ValueError(f"hidden {h} exceeds the kernel's shared-memory "
                         f"cap {MAX_HIDDEN}")
    hs = torch.empty((t, b, h), dtype=dtype, device=x_proj.device)
    cs = gates = None
    if residuals:
        cs = torch.empty_like(hs)
        gates = torch.empty_like(x_proj)
    if t and b:
        _FWD_KERNELS[dtype].launch(*_fwd_args(plan, x_proj, wh, peep, hs, cs,
                                              gates, peepholes))
    return hs, cs, gates


def _fwd_args(plan: Plan, x_proj, wh, peep, hs, cs, gates,
              peepholes: bool) -> tuple:
    """K1's C arguments for one call: the tensors' pointers (null for the
    residuals not written), the shape, the plan's fields and the device."""
    t, b, four_h = x_proj.shape
    return (x_proj.data_ptr(), wh.data_ptr(), peep.data_ptr(), hs.data_ptr(),
            None if cs is None else cs.data_ptr(),
            None if gates is None else gates.data_ptr(),
            t, b, four_h // 4, int(bool(peepholes)), *plan_args(plan, False),
            x_proj.device.index)


def lstm_sequence(x_proj, wh, peep, peepholes: bool = True):
    """Run the LSTM recurrence over ``x_proj`` (T, B, 4H), with
    ``x_proj = x @ wx + bias`` precomputed. ``wh``: (H, 4H); ``peep``:
    (4, H) f32, rows i, f, o and one zero row (zeros when ``peepholes`` is
    False). Returns hs (T, B, H); the residual writes are skipped."""
    return _fwd(x_proj, wh, peep, peepholes, residuals=False)[0]


@torch.library.custom_op("emtpu::lstm_sequence", mutates_args=(),
                         device_types=("cpu", "cuda"))
def lstm_sequence_op(x_proj: torch.Tensor, wh: torch.Tensor,
                     peep: torch.Tensor, peepholes: bool) -> torch.Tensor:
    """:func:`lstm_sequence` as a torch custom op (``emtpu::lstm_sequence``):
    the one route from a model to K1 when nothing is differentiated — the
    eager serving programs and the programs compiled ahead of time
    (serve/aotstore.py), which keep it as an opaque call. The launch goes
    through :func:`lstm_sequence`, so ``FUSED_LSTM_FWD.launches`` counts it
    wherever it runs."""
    return lstm_sequence(x_proj, wh, peep, peepholes)


@lstm_sequence_op.register_fake
def _lstm_sequence_fake(x_proj, wh, peep, peepholes):
    # the kernel's output: a fresh contiguous (T, B, H) in x_proj's dtype
    t, b, h = _check(x_proj, wh, peep)
    return x_proj.new_empty((t, b, h))


def lstm_forward(x_proj, wh, peep, peepholes: bool = True):
    """As :func:`lstm_sequence`, returning ``(hs, cs, gates)`` — the
    residuals the backward pass keeps (the JAX package's ``_fwd``)."""
    return _fwd(x_proj, wh, peep, peepholes, residuals=True)


def lstm_backward(wh, peep, residuals, g_hs, peepholes: bool = True):
    """The backward of :func:`lstm_forward`: ``(dxp, dwh, dpeep)`` from its
    residuals ``(hs, cs, gates)`` and the gradient ``g_hs`` (T, B, H) of
    its hs (the JAX package's ``_bwd``). dxp (T, B, 4H), dwh (H, 4H) and
    dpeep (4, H, row 3 zero) come back in the dtypes of hs, wh and peep."""
    hs, cs, gates = residuals
    t, b, h = _check(gates, wh, peep)
    for name, a in (("hs", hs), ("cs", cs), ("g_hs", g_hs)):
        if tuple(a.shape) != (t, b, h):
            raise ValueError(f"{name} must be ({t}, {b}, {h}), got "
                             f"{tuple(a.shape)}")
    if gates.device.type == "cpu":
        return lstm_backward_reference(wh, peep, residuals, g_hs, peepholes)
    if gates.device.type != "cuda":
        raise ValueError(f"unsupported device {gates.device}")
    dtype = _check_cuda(gates.device, (("gates", gates), ("g_hs", g_hs),
                                       ("hs", hs), ("cs", cs), ("wh", wh),
                                       ("peep", peep)))
    plan = lstm_plan(dtype, b, h, t, backward=True)
    if plan is None or h > MAX_HIDDEN_BWD:
        raise ValueError(f"hidden {h} exceeds the backward kernel's "
                         f"shared-memory cap {MAX_HIDDEN_BWD}")
    dxp = torch.empty_like(gates)
    dwh = torch.empty_like(wh)
    dpeep = torch.empty_like(peep)
    if not (t and b):
        return dxp, dwh.zero_(), dpeep.zero_()
    args, scratch = _bwd_args(plan, wh, peep, residuals, g_hs, dxp, dwh,
                              dpeep, peepholes, BWD_ALL)
    _BWD_KERNELS[dtype].launch(*args)
    del scratch  # freed in stream order, after the launch
    return dxp, dwh, dpeep


def _bwd_args(plan: Plan, wh, peep, residuals, g_hs, dxp, dwh, dpeep,
              peepholes: bool, parts: int) -> tuple[tuple, tuple]:
    """K2's C arguments for one call — the tensors' pointers, the two f32
    scratch buffers the plan sizes (dwh's per-slice partial sums, dwh_split
    x H x 4H; dpeep's per-tile ones, tiles x 3 x cluster * units), the
    shape, the plan's fields, ``parts`` and the device — and the scratch
    tensors, which the caller keeps until it has launched."""
    hs, cs, gates = residuals
    t, b, h = hs.shape
    dev = gates.device
    dwh_part = torch.empty((plan.dwh_split, h, 4 * h), dtype=torch.float32,
                           device=dev)
    dpeep_part = torch.empty((plan.tiles, 3, plan.cluster * plan.units),
                             dtype=torch.float32, device=dev)
    return (g_hs.data_ptr(), hs.data_ptr(), cs.data_ptr(), gates.data_ptr(),
            wh.data_ptr(), peep.data_ptr(), dxp.data_ptr(), dwh.data_ptr(),
            dpeep.data_ptr(), dwh_part.data_ptr(), dpeep_part.data_ptr(),
            t, b, h, int(bool(peepholes)), *plan_args(plan, True), parts,
            dev.index), (dwh_part, dpeep_part)


class LSTMSequence(torch.autograd.Function):
    """K1 and K2 as one differentiable op (the JAX package's
    ``jax.custom_vjp`` of ``lstm_sequence``): ``apply(x_proj, wh, peep,
    peepholes) -> hs``. Forward runs K1 with residuals and saves them;
    backward runs K2. On CPU tensors both are the plain versions."""

    @staticmethod
    def forward(ctx, x_proj, wh, peep, peepholes):
        hs, cs, gates = lstm_forward(x_proj, wh, peep, peepholes)
        ctx.save_for_backward(hs, cs, gates, wh, peep)
        ctx.peepholes = peepholes
        return hs

    @staticmethod
    def backward(ctx, g_hs):
        hs, cs, gates, wh, peep = ctx.saved_tensors
        dxp, dwh, dpeep = lstm_backward(wh, peep, (hs, cs, gates),
                                        g_hs.contiguous(), ctx.peepholes)
        return dxp, dwh.to(wh.dtype), dpeep.to(peep.dtype), None

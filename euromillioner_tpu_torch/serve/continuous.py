"""Sequence serving for the lstm family (the JAX package's
``serve/continuous.py``): the step scheduler (``serve.scheduler=
"continuous"``) and the whole-sequence scheduler (``"batch"``).

:class:`RecurrentBackend` wraps a stacked-LSTM model with the programs
both schedulers run and ``predict``, the direct single-sequence path every
profile is measured against:

* ``block_fn(states, x_block, reset)`` — ``K`` timesteps for the whole
  slot pool from the pool's carried per-layer (h, c), slots flagged in
  ``reset`` zeroed first, so a freed slot's state never reaches the next
  sequence. Every step runs each layer's projection, cell and the head at
  the pool's row count on a fresh copy of the step's rows: each step's
  products see one shape whatever ``K`` is, so a sequence's reply does
  not depend on the block sizes that carried it (a block switch or a
  coalesced readback changes no bit). The JAX package runs the scan here
  in every profile, and so does the port: no fused kernel takes a carry.
* ``padded_fn(x, last_idx)`` — a time-padded whole-sequence apply with a
  per-row gather at each true last step (the batch scheduler's program).

:class:`StepScheduler` keeps ``max_slots`` sequences' state on the
device. Each dispatch fills freed slots from an admission heap ordered by
(SLO class priority, deadline, arrival), advances every active slot by one
step block — its size picked from the ``step_blocks`` ladder by load, with
hysteresis — and uploads the block's rows through a pinned, non-blocking
copy, with up to ``inflight`` blocks enqueued through ``DoubleBuffer``.
Finishers' output rows are gathered on the device and drained in one
device→host read per ``readback_interval_ms`` (sooner when a finisher's
deadline is due, and at idle): the only host sync. All device work runs on
the dispatcher thread, in ``torch.inference_mode()``. A failed dispatch
fails the slot-holding sequences only, and the pool is rebuilt; a fault
the dispatcher cannot recover from (the rebuild fails too) fails every
request it holds and closes the engine.

:class:`WholeSequenceScheduler` coalesces ragged sequences into
micro-batches (count reaches the largest row bucket, the oldest request's
deadline passes, or classes mix), pads time to the smallest fitting time
bucket and rows to the smallest row bucket, and runs ``padded_fn``.

Profiles, as the JAX package's: ``f32`` serves in the checkpoint's
compute dtype (the oracle's arithmetic); ``bf16`` casts the params to
bfloat16 once and runs (and carries the slot pool) in bfloat16; ``fused``
serves float32, the padded programs through the fused CUDA sequence kernel
(ops/fused_lstm.py), one launch per LSTM layer per micro-batch; ``int8w``
keeps weight-only int8 params and their scales resident and dequantizes
them to float32 at each call. Each but ``f32`` serves behind its pinned
envelope of the oracle, with its drift sampled. ``profiles=`` serves extra
profiles beside the default, each on a child scheduler of its own.

The step scheduler's governance, each part off by default:

* **Preemption** (``serve.preempt``): at a block boundary, when the
  admission heap holds a strictly more urgent class than a slot-holder,
  the least urgent holder's per-layer (h, c) rows are gathered to the
  host in the pool's own dtype (one read, which returns once the copy is
  done), parked in a bounded ledger, and the victim re-enters the heap
  under its original ordering; its restore is uploaded ahead of the block
  (pinned, non-blocking) and scattered back, so it finishes bit-equal to a
  never-preempted run. A parked sequence whose deadline passes is shed
  loudly (on a block boundary, a submit, ``stats()`` or ``close``).
* **The elastic pool** (``serve.preempt.elastic``): the live pool grows
  and shrinks between ``min_slots`` and ``max_slots`` by load; a shrink
  evicts the occupied high slots. The block program runs at ``max_slots``
  rows whatever the live size (the lanes past it idle, their carry
  reset): on the card a product rounds otherwise at another row count.
* **The budget** (``serve.budget``, serve/session.py ``MemoryLedger``):
  every class of serving bytes is tracked; enabled, parked state beyond
  ``ledger_bytes`` spills LRU to crc32-checked EMT1 files in the pool's
  own dtype, and the governor degrades loudest-first — no preemption the
  ledger cannot hold, a restore the RAM tier cannot take stays parked,
  a submit past ``queue_bytes`` is shed naming the budget. A corrupt
  spill file sheds its own sequence only.
* **Paging** (``serve.paging``): the state lives in a page store; the live
  set may oversubscribe its rows, each block gathers its scheduled rows
  into a dense ``pool_slots`` block and scatters them back, and cold
  sequences demote to the ledger and promote on their next block.
* **Live migration**: :meth:`StepScheduler.export_sequence` packs a live
  sequence (the JAX package's EMT1 migration container,
  :func:`unpack_migration`) and :meth:`StepScheduler.import_sequence`
  admits one from either package, judged by the params' fingerprint
  (serve/aotstore.py) and the pool's layout.

Telemetry (obs/telemetry.py): each scheduler's counters live in its
metrics registry (``stats()`` reads them, ``GET /metrics`` renders them),
each request carries a trace span over the seven stages of obs/trace.py
stamped on the host clock (no sync is added for them), and SLO attainment
is judged per class. The fault points of resilience/inject.py sit where
the JAX package has them: ``serve.request``, ``serve.budget``,
``serve.admit``, ``serve.step``, ``serve.preempt``, ``serve.spill``,
``serve.resize``, ``serve.page`` and (the batch scheduler)
``serve.dispatch``; ``serve.quant`` covers a profile's restore-time cast
or quantization, whose failure falls the backend back to the f32 programs
(a fused kernel that fails to build still raises).

The AOT program store (``serve.aot``, serve/aotstore.py): with a store,
the batch scheduler's (rows, steps) programs (``padded``) and the step
scheduler's rungs and finishers' gathers (``ladder``) are compiled ahead of
time from the backend's ``padded_pure`` and ``block_pure`` (the serving
params as an input) through one executable cache per scheduler, shared with
its profile children; warmup preloads the warm manifest first, so rungs an
elastic pool grew into load from disk too. The paged dispatch's row
gathers and scatters stay eager.

The serving mesh (``serve.mesh``, serve/session.py
``build_serving_mesh``): the step scheduler shards its slot pool over the
``data`` axis. ``max_slots`` rounds up to a multiple of the axis (logged
once) and each block's slots split into equal shards, each run on its
data shard's device and stream through the backend's block program on a
copy of the params placed there; the shards' carry and outputs join on
shard 0's device, where the pool's state stays between blocks. The
per-slot program is the unsharded one, so replies stay bit-identical.
The ``serve.shard`` fault point sits before each block's upload: a fault
fails the slot-holding sequences only and the pool is rebuilt, as a
``serve.step`` fault. ``stats()`` and every step record carry ``mesh``
(and the records ``shard_put_ms``). A model axis above 1 replicates
compute (warned), paging refuses a mesh, a meshed pool is not bound to
the AOT store, and the batch scheduler logs and ignores the mesh.
"""

from __future__ import annotations

import collections
import heapq
import itertools
import math
import os
import threading
import time
from concurrent.futures import CancelledError, Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from euromillioner_tpu_torch.core.device import resolve_device, upload
from euromillioner_tpu_torch.core.mesh import (AXIS_DATA, AXIS_MODEL,
                                               mesh_desc, round_up_multiple)
from euromillioner_tpu_torch.core.precision import (cast_floats,
                                                    dequantize_int8w,
                                                    fake_quant_int8,
                                                    quantize_int8w,
                                                    resolve_serve_precision,
                                                    serve_envelope)
from euromillioner_tpu_torch.core.prefetch import DoubleBuffer
from euromillioner_tpu_torch.models.lstm import init_step_states, padded_apply
from euromillioner_tpu_torch.nn.recurrent import LSTM, LSTMCell
from euromillioner_tpu_torch.serve.batcher import (LATENCY_WINDOW,
                                                   MicroBatcher, Request,
                                                   percentile, pick_bucket,
                                                   resolve_future,
                                                   validate_buckets)
from euromillioner_tpu_torch.serve.aotstore import params_fingerprint
from euromillioner_tpu_torch.obs.telemetry import ServeTelemetry
from euromillioner_tpu_torch.obs.trace import Span
from euromillioner_tpu_torch.resilience import fault_point
from euromillioner_tpu_torch.serve.engine import (DRIFT_EVERY, ClassStats,
                                                  DriftStats, MetricsSink,
                                                  obs_kwargs, param_bytes,
                                                  resolve_classes,
                                                  resolve_request_class)
from euromillioner_tpu_torch.serve.session import (BudgetPolicy,
                                                   ExecutableCache,
                                                   MemoryLedger,
                                                   ShardedRows, _skeleton,
                                                   admit_queue_bytes)
from euromillioner_tpu_torch.utils import serialization
from euromillioner_tpu_torch.utils.errors import (CheckpointError,
                                                  ConfigError, ServeError)
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("serve.continuous")


class _PaddedProgram(torch.nn.Module):
    """``padded_apply`` as a module, so ``torch.func.functional_call`` can
    run it on params held outside the model (the bf16 and int8w tiers')."""

    def __init__(self, model, fused: bool):
        super().__init__()
        self.model = model
        self.fused = fused

    def forward(self, x, last_idx):
        return padded_apply(self.model, x, last_idx, fused=self.fused)


class _BlockProgram(torch.nn.Module):
    """The step scheduler's block program as a module, the padded one's
    twin: ``(carry, x (slots, K, F)) → (carry, (slots, K, out))``. Each
    step runs on a fresh copy of its rows through the layers' own
    single-step apply — an LSTM's cell (``LSTMCell.apply``: ``x_t @ wx +
    bias``, then the cell) from its carried (h, c), every other layer's
    ``apply`` — so each step's products see the pool's row count and one
    alignment whatever K is."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, carry, x):
        carry = list(carry)
        ys = []
        for t in range(x.shape[1]):
            h = x[:, t].clone()
            si = 0
            for _name, layer in self.model.named_layers():
                if isinstance(layer, LSTM):
                    carry[si], h = LSTMCell.apply(layer, (carry[si], h))
                    si += 1
                else:
                    h = layer.apply(h)
            ys.append(h)
        return carry, torch.stack(ys, 1)


class RecurrentBackend:
    """Serving backend for a stacked-LSTM model whose parameters already
    sit on the serving device.

    * ``block_fn(states, x_block, reset)`` — the step scheduler's program:
      ``states`` the pool's per-layer (h, c) in ``serve_dtype``, ``x_block``
      (slots, K, F) float32 and ``reset`` (slots, 1) bool on the device →
      ``(new states, (slots, K, out) float32)``; see the module docstring.
    * ``padded_fn(x, last_idx)`` — ``x`` (rows, steps, F) float32 on the
      host, ``last_idx`` (rows,) → (rows, out) float32 on the device: the
      batch scheduler's program, at this backend's profile.
    * ``predict(x)`` — (T, F) → (out,) through the scan in the compute
      dtype on the checkpoint's params: the oracle, whatever the profile.

    ``serve_dtype`` is what the programs compute in: the compute dtype
    under ``f32``, bfloat16 under ``bf16``, float32 under ``fused`` and
    ``int8w`` (the JAX package's ``sdt``). ``bf16`` and ``int8w`` run on
    ``serve_params`` (the bf16 cast, or the int8 values and scales): both
    programs run a private skeleton of the model (its params on the meta
    device) on them. ``padded_pure(params, x, last_idx)`` and
    ``block_pure(params, states, x_block, reset)`` are the same programs
    with the params an input (what the AOT store compiles)."""

    family = "lstm"

    def __init__(self, model, feat_dim: int = 11, compute_dtype=None,
                 precision: str = "f32", act_quant: bool = False,
                 fused_unroll: int = 8):
        self.name = f"seq:{type(model).__name__}"
        self.model = model.requires_grad_(False)
        # the oracle is the scan: the fused tiers opt back in explicitly
        # through padded_apply(fused=True)
        for _name, layer in model.named_layers():
            if isinstance(layer, LSTM):
                layer.fused = "off"
        self.device = resolve_device(next(model.parameters()).device)
        self.feat_dim = int(feat_dim)
        self.out_dtype = np.float32
        self.compute_dtype = compute_dtype or torch.bfloat16
        self._act_quant = bool(act_quant)
        self._fused_unroll = int(fused_unroll)
        if self._fused_unroll < 2:
            raise ConfigError(
                f"serve.fused_unroll must be >= 2 (the JAX package measures "
                f"its fast tier's envelope at unroll >= 2), got "
                f"{self._fused_unroll}")
        self.precision = resolve_serve_precision(precision)
        self.envelope = serve_envelope(self.family, self.precision)
        # cast / quantize once, here (the serve.quant fault point): a
        # failure falls this backend back to the f32 programs, whose
        # replies are bit-equal to the oracle's. The try holds the cast
        # and the quantization only: the fused kernel's build stays out
        self.serve_params = None
        if self.precision != "f32":
            try:
                fault_point("serve.quant", profile=self.precision,
                            family=self.family)
                if self.precision == "bf16":
                    self.serve_params = cast_floats(model.state_dict(),
                                                    torch.bfloat16)
                elif self.precision == "int8w":
                    # min_size=16, as the JAX package: small models
                    # quantize too
                    self.serve_params = quantize_int8w(model.state_dict(),
                                                       min_size=16)
            except Exception as e:  # noqa: BLE001 — degrade, don't die
                logger.warning(
                    "serve.precision=%s setup failed at restore (%r); "
                    "falling back to the f32 programs for this session",
                    self.precision, e)
                self.precision = "f32"
                self.envelope = 0.0
                self.serve_params = None
        fused = self.precision in ("fused", "int8w")
        self.serve_dtype = {"f32": self.compute_dtype,
                            "bf16": torch.bfloat16}.get(self.precision,
                                                        torch.float32)
        if fused and self.device.type == "cuda":
            # build here, on the constructing thread — never lazily on
            # the scheduler's dispatcher thread
            from euromillioner_tpu_torch.ops.fused_lstm import FUSED_LSTM_FWD

            FUSED_LSTM_FWD.build()
        # ``padded_pure`` and ``block_pure`` run a private skeleton of the
        # model (its params on the meta device) through functional_call on
        # the params, an input: what the AOT store compiles
        # (serve/aotstore.py). The eager programs are the same functions
        # over the model's own modules under f32 and fused (no rebinding
        # per call), and over the skeleton on serve_params otherwise
        skel = _skeleton(model)
        pure_padded = _PaddedProgram(skel, fused)
        pure_block = _BlockProgram(skel)
        own = self.serve_params is None
        eager_padded = _PaddedProgram(model, fused) if own else pure_padded
        eager_block = _BlockProgram(model) if own else pure_block
        lock = threading.Lock()  # functional_call swaps the skeleton's params
        quantized = self.precision == "int8w"
        act_q = self._act_quant and quantized
        sdt = self.serve_dtype
        dev = self.device
        f32 = torch.float32

        def run(program, p, args):
            if p is None:  # the model's own modules and params
                return program(*args)
            if quantized:  # int8 stays resident, dequantized at each call
                p = dequantize_int8w(p, f32)
            with lock:
                return torch.func.functional_call(
                    program, {f"model.{k}": v for k, v in p.items()}, args)

        def padded_on(program, p, x, last_idx):
            h = x.to(sdt)
            if act_q:
                h = fake_quant_int8(h)
            return run(program, p, (h, last_idx)).to(f32)

        def block_on(program, p, states, x_block, reset):
            x = x_block.to(sdt)
            if act_q:
                x = fake_quant_int8(x)
            zero = torch.zeros((), dtype=sdt, device=x.device)
            carry = [(torch.where(reset, zero, h),
                      torch.where(reset, zero, c)) for h, c in states]
            carry, y = run(program, p, (carry, x))
            return carry, y.to(f32)

        def padded_pure(p, x, last_idx):
            return padded_on(pure_padded, p, x, last_idx)

        def block_pure(p, states, x_block, reset):
            return block_on(pure_block, p, states, x_block, reset)

        def padded(x, last_idx):
            with torch.inference_mode():
                return padded_on(eager_padded, self.serve_params,
                                 torch.as_tensor(x, device=dev), last_idx)

        def block(states, x_block, reset):
            with torch.inference_mode():
                return block_on(eager_block, self.serve_params, states,
                                x_block, reset)

        self.padded_fn = padded
        self.block_fn = block
        self.padded_pure = padded_pure
        self.block_pure = block_pure

    def serving_params(self) -> dict:
        """The params the serving programs read: ``serve_params``, or the
        model's own state dict under ``f32`` and ``fused``."""
        if self.serve_params is not None:
            return self.serve_params
        return self.model.state_dict()

    def init_states(self, slots: int) -> list:
        """A zero slot pool: per-layer (h, c) of ``(slots, hidden)`` on
        the serving device, in ``serve_dtype`` (bf16 under ``bf16``)."""
        return init_step_states(self.model, slots, self.serve_dtype)

    def with_profile(self, precision: str) -> "RecurrentBackend":
        """A sibling backend at another serving profile sharing this
        model and its params (the oracle stays the same)."""
        return RecurrentBackend(self.model, feat_dim=self.feat_dim,
                                compute_dtype=self.compute_dtype,
                                precision=precision,
                                act_quant=self._act_quant,
                                fused_unroll=self._fused_unroll)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Direct whole-sequence path (the oracle): (T, F) → (out,)."""
        with torch.inference_mode():
            xt = torch.as_tensor(np.asarray(x, np.float32)[None],
                                 device=self.device)
            y = self.model.apply(xt.to(self.compute_dtype))
            return y.to(torch.float32).cpu().numpy()[0]


def _extra_profiles(backend: RecurrentBackend, profiles) -> list[str]:
    """``serve.profiles`` beyond the backend's own, validated at the front
    door: an unknown name or an unpinned (lstm, profile) pair is a
    ConfigError before any child is built."""
    extra: list[str] = []
    for p in profiles or ():
        p = resolve_serve_precision(p)
        serve_envelope(backend.family, p)
        if p != backend.precision and p not in extra:
            extra.append(p)
    return extra


def _route(engine, profile: str | None):
    """None or the engine's own profile → None (served there); a child's
    profile → that child; else a ServeError naming the servable ones."""
    if profile is None or profile == engine.backend.precision:
        return None
    child = engine._children.get(profile)
    if child is None:
        raise ServeError(
            f"unknown precision profile {profile!r}; serving profiles are "
            f"{[engine.backend.precision, *engine._children]}")
    return child


def _profiles(engine) -> dict:
    """``stats()["profiles"]``: one row per served profile, the default
    first, with its request flow and sampled drift."""
    return {engine.backend.precision: engine._profile_row(),
            **{p: c._profile_row() for p, c in engine._children.items()}}


# Migration wire format: one EMT1 container (utils/serialization.py, crc32
# per entry) holding a "migrate" header (json_entry: model fingerprint,
# profile, pool dtype, per-layer row shapes, steps consumed, class,
# deadline, arrival), the input "x", and for a mid-sequence export the
# per-layer state rows "{i}.h" / "{i}.c" in the pool's own dtype — the JAX
# package's layout byte for byte (tests/golden/migrate_blob_v1.emt1 pins
# version 1), so a blob crosses between the two packages both ways.
MIGRATE_VERSION = 1

_MIGRATE_HEADER_FIELDS = ("migrate_version", "model", "family",
                          "profile", "pool_dtype", "layers", "feat_dim",
                          "steps", "pos", "cls", "priority", "arrival")

# per-scheduler token: spill files of two schedulers never share a name
_SCHEDULER_TOKENS = itertools.count()


def unpack_migration(blob: bytes) -> tuple[dict, np.ndarray, list | None]:
    """One migration blob → ``(header, x, state)``: ``x`` the (steps, F)
    float32 input, ``state`` the per-layer ``(h, c)`` rows as CPU tensors
    in their own dtype, or None for a never-dispatched sequence (``pos ==
    0``). The container, the header's presence and fields and the version
    are checked here (a newer ``migrate_version`` is refused with the
    supported range); whether the blob fits a pool is the importing
    scheduler's to judge."""
    try:
        arrays = serialization.loads(bytes(blob))
    except Exception as e:  # noqa: BLE001 — name the corruption
        raise ServeError(f"migration blob rejected: {e}") from e
    if "migrate" not in arrays:
        raise ServeError("migration blob rejected: no 'migrate' header "
                         "entry (not a migration container)")
    try:
        header = serialization.json_value(arrays["migrate"])
    except Exception as e:  # noqa: BLE001
        raise ServeError(
            f"migration blob rejected: malformed header ({e})") from e
    if not isinstance(header, dict):
        raise ServeError("migration blob rejected: header is not an "
                         "object")
    ver = header.get("migrate_version")
    if not isinstance(ver, int) or not 1 <= ver <= MIGRATE_VERSION:
        raise ServeError(
            f"migration blob rejected: migrate_version {ver!r} outside "
            f"the supported range [1, {MIGRATE_VERSION}]")
    for key in _MIGRATE_HEADER_FIELDS:
        if key not in header:
            raise ServeError(
                f"migration blob rejected: header field {key!r} missing")
    if "x" not in arrays:
        raise ServeError("migration blob rejected: no 'x' input entry")
    x = arrays["x"].numpy()
    pos, steps = int(header["pos"]), int(header["steps"])
    if not 0 <= pos < steps:
        raise ServeError(
            f"migration blob rejected: header field 'pos' ({pos}) "
            f"outside [0, steps={steps})")
    state = None
    if pos > 0:
        state = []
        for i in range(len(header["layers"])):
            if f"{i}.h" not in arrays or f"{i}.c" not in arrays:
                raise ServeError(
                    f"migration blob rejected: state entry for layer "
                    f"{i} missing (header names "
                    f"{len(header['layers'])} layers)")
            state.append((arrays[f"{i}.h"], arrays[f"{i}.c"]))
    return header, x, state


@dataclass(frozen=True)
class PreemptPolicy:
    """``serve.preempt``: slot preemption and the elastic pool of
    :class:`StepScheduler` (the module docstring). The default (all off)
    leaves the scheduler as it is without it."""

    enabled: bool = False
    max_evicted: int = 64
    elastic: bool = False
    min_slots: int = 2
    grow_load: float = 1.0
    shrink_load: float = 0.25
    resize_hysteresis: int = 8

    def validate(self) -> None:
        if self.max_evicted < 1:
            raise ServeError(f"serve.preempt.max_evicted must be >= 1, "
                             f"got {self.max_evicted}")
        if self.min_slots < 2:
            raise ServeError(f"serve.preempt.min_slots must be >= 2 "
                             f"(bit-parity needs M >= 2 rows), got "
                             f"{self.min_slots}")
        if self.resize_hysteresis < 1:
            raise ServeError("serve.preempt.resize_hysteresis must be "
                             f">= 1, got {self.resize_hysteresis}")
        if self.shrink_load >= self.grow_load:
            raise ServeError(
                f"serve.preempt.shrink_load ({self.shrink_load}) must be "
                f"< grow_load ({self.grow_load}) or the pool oscillates")

    @classmethod
    def from_config(cls, pc) -> "PreemptPolicy":
        """``cfg.serve.preempt`` → a policy, validated when on."""
        pol = cls(enabled=pc.enabled, max_evicted=pc.max_evicted,
                  elastic=pc.elastic, min_slots=pc.min_slots,
                  grow_load=pc.grow_load, shrink_load=pc.shrink_load,
                  resize_hysteresis=pc.resize_hysteresis)
        if pol.enabled or pol.elastic:
            pol.validate()
        return pol


@dataclass(frozen=True)
class PagingPolicy:
    """``serve.paging``: the pool's (h, c) state lives in a page store of
    ``pages * page_slots`` rows; each live sequence holds one row, the
    live set may oversubscribe the rows up to ``max_live``, and each
    dispatch gathers its scheduled rows into a dense ``pool_slots`` block,
    runs the same block program and scatters the rows back. Cold
    sequences (least recently dispatched) demote to the ledger's RAM and
    disk tiers in their own dtype and promote on their next block."""

    enabled: bool = False
    page_slots: int = 4
    pages: int = 0      # 0 → ceil(max_slots / page_slots)
    max_live: int = 0   # 0 → 4 × device rows

    def validate(self) -> None:
        if self.page_slots < 1:
            raise ServeError(f"serve.paging.page_slots must be >= 1, "
                             f"got {self.page_slots}")
        if self.pages < 0:
            raise ServeError(f"serve.paging.pages must be >= 0, "
                             f"got {self.pages}")
        if self.max_live < 0:
            raise ServeError(f"serve.paging.max_live must be >= 0, "
                             f"got {self.max_live}")

    def geometry(self, max_slots: int) -> tuple[int, int, int]:
        """``(pages, rows, max_live)`` for a pool of ``max_slots`` lanes:
        0 pages is the dense pool's footprint, 0 max_live 4x the rows."""
        pages = self.pages or -(-max_slots // self.page_slots)
        rows = pages * self.page_slots
        return pages, rows, (self.max_live or 4 * rows)

    @classmethod
    def from_config(cls, pc) -> "PagingPolicy":
        """``cfg.serve.paging`` → a policy, validated when on."""
        if pc is None:
            return cls()
        pol = cls(enabled=pc.enabled, page_slots=pc.page_slots,
                  pages=pc.pages, max_live=pc.max_live)
        if pol.enabled:
            pol.validate()
        return pol


@dataclass(frozen=True)
class _Spilled:
    """A parked state on the disk tier: a crc32-checked EMT1 file of the
    per-layer (h, c) rows in their own dtype. ``nbytes`` is the file's
    size, ``ram_bytes`` what the rows take once read back."""

    path: str
    nbytes: int
    ram_bytes: int


def _dtype_name(t) -> str:
    """numpy's name of a tensor's or an array's dtype ("bfloat16" too)."""
    if isinstance(t, torch.Tensor):
        return str(t.dtype).removeprefix("torch.")
    return np.dtype(t.dtype).name


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def _state_nbytes(state: list) -> int:
    return sum(h.numel() * h.element_size() + c.numel() * c.element_size()
               for h, c in state)


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


@dataclass
class SeqRequest:
    """One queued sequence: ``x`` is (T, F) float32. Admission orders by
    (``priority``, ``deadline``, ``arrival``, ``seq``); ``deadline``
    (absolute monotonic, ``inf`` = none) from ``max_wait_s`` also bounds
    how long the finished output may wait in the readback staging buffer.

    ``seq`` is the local key (ledger, spill file names); ``arrival`` the
    ordering ordinal — equal to ``seq`` for a local submit, the original
    one for a migrated-in sequence. ``pos`` and ``evicted_state`` are a
    parked sequence's resume point: steps consumed and its per-layer
    (h, c) rows on the host in the pool's dtype (a :class:`_Spilled`
    once on disk; None for a never-dispatched one). ``tag`` is a
    client's export handle; ``row`` and ``last_block`` the page-store row
    and the last dispatch ordinal of a paged sequence."""

    x: np.ndarray
    cls: str = "interactive"
    priority: int = 0
    deadline: float = math.inf
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.monotonic)
    seq: int = 0
    arrival: int = 0
    pos: int = 0
    evicted_state: list | _Spilled | None = None
    t_evicted: float = 0.0
    state_bytes: int = 0  # RAM bytes the parked rows take or need
    # the queue-class bytes were released while the heap entry still
    # stood (a sweep or shed resolved it): the pop must not release twice
    queue_released: bool = False
    tag: str | None = None
    row: int | None = None
    last_block: int = -1
    span: Span | None = None  # trace span (None: tracing off)

    @property
    def steps(self) -> int:
        return len(self.x)


# the step scheduler's governance counters (stats() and load_desc): each
# is the telemetry registry's counter of the same name; the paging ones
# exist while serve.paging is enabled
_COUNTERS = ("preempted", "restored", "preempt_shed", "resizes", "spills",
             "spill_restored", "budget_deferred", "budget_shed",
             "page_demoted", "page_promoted", "page_shed")


class StepScheduler(MetricsSink):
    """Continuous batching over a device-resident slot pool
    (``serve.scheduler="continuous"``): ``submit`` returns a future of the
    sequence's final-step output ``(out_dim,)``, ``predict`` blocks. See
    the module docstring; ``start=False`` holds the dispatcher until
    :meth:`start` (a deterministic admission order for tests).

    ``step_blocks`` is the block-size ladder (each rung >= 2): each
    dispatch wants the rung its load — (active + queued) / slots — asks
    for (the top at load >= 1, the others spread over [0.5, 1)), and
    switches after ``hysteresis`` consecutive dispatches wanted the same
    other rung. ``classes`` are the SLO classes, most urgent first.
    ``readback_interval_ms`` coalesces finishers' reads (0: every step).
    ``profiles`` adds a child scheduler per extra profile, with its own
    pool in that profile's dtype. Pool sizes are >= 2, as in the JAX
    package's bit rule for its programs.

    ``preempt``, ``budget`` and ``paging`` are the governance policies
    (:class:`PreemptPolicy`, ``serve.session.BudgetPolicy``,
    :class:`PagingPolicy`; all off by default); the children serve
    without them. ``metrics_jsonl``, ``obs_enabled``, ``trace_capacity``,
    ``slo_ms`` and ``capture_path`` are the telemetry's
    (``serve.metrics_jsonl``, ``serve.obs.*``); the counters ``stats()``
    reports live in its registry."""

    kind = "sequence"  # transport: a request is one ordered sequence

    def __init__(self, backend: RecurrentBackend, *, max_slots: int = 32,
                 step_block: int = 2,
                 step_blocks: Sequence[int] | None = None,
                 inflight: int = 2, warmup: bool = True, start: bool = True,
                 classes: Sequence[str] = ("interactive", "bulk"),
                 readback_interval_ms: float = 0.0, hysteresis: int = 3,
                 profiles: Sequence[str] = (),
                 preempt: PreemptPolicy | None = None,
                 budget: BudgetPolicy | None = None,
                 paging: PagingPolicy | None = None,
                 metrics_jsonl: str | None = None, obs_enabled: bool = True,
                 trace_capacity: int = 512, slo_ms: Sequence[float] = (),
                 capture_path: str | None = None, aot=None,
                 max_executables: int = 16, exec_cache=None, mesh=None):
        if max_slots < 2:
            raise ServeError(f"max_slots must be >= 2, got {max_slots}")
        extra = _extra_profiles(backend, profiles)
        ladder = tuple(sorted({int(b) for b in (step_blocks or ())})) \
            or (int(step_block),)
        if ladder[0] < 2:
            raise ServeError(
                f"every step_block must be >= 2, got {ladder}")
        if inflight < 1:
            raise ServeError(f"inflight must be >= 1, got {inflight}")
        if hysteresis < 1:
            raise ServeError(f"hysteresis must be >= 1, got {hysteresis}")
        if readback_interval_ms < 0:
            raise ServeError("readback_interval_ms must be >= 0, got "
                             f"{readback_interval_ms}")
        self._class_priority = resolve_classes(classes)
        self.classes = tuple(self._class_priority)
        self.backend = backend
        self.mesh = mesh
        self._data_size = 1
        if mesh is not None:
            self._data_size = mesh.shape[AXIS_DATA]
            if mesh.shape[AXIS_MODEL] > 1:
                # slot-pool sharding is data-parallel only: a model axis
                # would just replicate every step across it
                logger.warning(
                    "continuous scheduler shards slots over the data "
                    "axis only; mesh model axis %d replicates compute — "
                    "use serve.mesh=%d,1 instead", mesh.shape[AXIS_MODEL],
                    self._data_size)
            if max_slots % self._data_size:
                new_slots = round_up_multiple(max_slots, self._data_size)
                logger.info("serve.mesh data axis %d: max_slots %d "
                            "rounded up to %d", self._data_size, max_slots,
                            new_slots)
                max_slots = new_slots
            self._shards = ShardedRows(mesh)
            params = backend.serving_params()
            self._shard_params = [
                {k: v.to(d) for k, v in params.items()}
                for d in self._shards.devices]
        self.max_slots = max_slots
        self.step_blocks = ladder
        self.hysteresis = hysteresis
        self.readback_interval_s = readback_interval_ms / 1e3
        self._block_idx = 0      # current rung (dispatcher-only)
        self._block_want = 0     # rung the previous dispatch wanted
        self._block_streak = 0   # consecutive dispatches wanting it
        # preemption and the elastic pool (serve.preempt)
        self._preempt = preempt or PreemptPolicy()
        if self._preempt.enabled or self._preempt.elastic:
            self._preempt.validate()
        self._min_slots = self._preempt.min_slots
        if self._data_size > 1:
            self._min_slots = round_up_multiple(self._min_slots,
                                                self._data_size)
        if self._preempt.elastic and self._min_slots > max_slots:
            raise ServeError(
                f"serve.preempt.min_slots ({self._min_slots}) exceeds "
                f"serve.max_slots ({max_slots})")
        # the live pool: an elastic one starts at its floor
        self.pool_slots = (self._min_slots if self._preempt.elastic
                           else max_slots)
        self._resize_want = 0    # +1 grow / -1 shrink (dispatcher-only)
        self._resize_streak = 0
        self._resize_request = 0  # request_resize's target
        # paged slot state (serve.paging)
        self._paging = paging or PagingPolicy()
        self._page_rows = self.pool_slots
        self._pages = self._max_live = 0
        if self._paging.enabled:
            self._paging.validate()
            if mesh is not None:
                raise ServeError(
                    "serve.paging is single-device for now (the page "
                    "gather/scatter is not mesh-aware); use "
                    "serve.mesh=1,1 or serve.paging.enabled=false")
            if self._preempt.elastic:
                raise ServeError(
                    "serve.paging needs a fixed page store; "
                    "serve.preempt.elastic resizes the dense pool — "
                    "enable one or the other")
            self._pages, self._page_rows, self._max_live = \
                self._paging.geometry(max_slots)
            if self._page_rows < 2:
                raise ServeError(
                    f"serve.paging needs >= 2 device rows (bit-parity "
                    f"needs M >= 2 dispatch lanes), got "
                    f"{self._pages} pages x {self._paging.page_slots}")
            self.pool_slots = min(max_slots, self._page_rows)
        # the block program's row count. On the card (and on the CPU at
        # narrow widths) a product rounds differently at another row
        # count, so an elastic pool steps at max_slots rows whatever its
        # live size: lanes past pool_slots idle with their carry reset,
        # and a sequence that crosses a resize stays bit-equal
        self._block_rows = (max_slots if self._preempt.elastic
                            else self.pool_slots)
        self._live: dict[int, SeqRequest] = {}  # paged: seq → request
        self._row_free: list[int] = (list(range(self._page_rows))
                                     if self._paging.enabled else [])
        self._pg_dispatch = 0   # the paged LRU clock: dispatch ordinal
        self._pg_peak_live = 0
        # byte accounting (serve.budget): tracked always, enforced only
        # under an enabled policy
        self._budget = budget or BudgetPolicy()
        if self._budget.enabled:
            self._budget.validate()
        self._mem = MemoryLedger(
            {"ram": self._budget.ledger_bytes,
             "disk": self._budget.spill_bytes
                     if self._budget.spill_dir else 0,
             "queue": self._budget.queue_bytes}
            if self._budget.enabled else None)
        self._defer_logged_seq = -1  # the last deferral warned about
        self._deferred_head = None   # the head _admit_locked held back
        self._token = next(_SCHEDULER_TOKENS)
        # the eviction ledger: seq → parked request; mutated under
        # self._cond (the deadline sweep also runs on submit/stats/close)
        self._evicted: dict[int, SeqRequest] = {}
        # exports filed by any thread, packed at the next block boundary
        self._export_q: list[tuple[object, str, Future]] = []
        # migration identity: the structure of the checkpoint's params
        self._model_fingerprint = params_fingerprint(
            backend.model.state_dict())
        # restores admitted but not applied (slot → request), and their
        # uploads staged ahead of the block
        self._pending_restore: dict[int, SeqRequest] = {}
        self._restore_staged: set[int] = set()
        self._restore_buf = DoubleBuffer(depth=inflight)
        self._restore_async = True  # tests pin staged == synchronous
        self._buffer = DoubleBuffer(depth=inflight)
        self._cond = threading.Condition()
        # admission heap: (priority, deadline, arrival, seq, request)
        self._q: list[tuple[int, float, int, int, SeqRequest]] = []
        self._n_submitted = 0
        self._closed = False
        self._aborted: BaseException | None = None
        # slot bookkeeping, dispatcher-thread-only (sized to the live pool)
        self._states = None
        self._slot_req: list[SeqRequest | None] = [None] * self.pool_slots
        self._slot_pos = [0] * self.pool_slots
        self._free = list(range(self.pool_slots))
        self._pending_reset: set[int] = set()
        # readback staging: (finished requests, flush deadline, device rows)
        self._staged: list[tuple[list[SeqRequest], float, torch.Tensor]] = []
        self._staged_rows = 0
        # stats, under self._lock; accounting precedes resolving futures
        self._lock = threading.Lock()
        self._step_ms: collections.deque = collections.deque(
            maxlen=LATENCY_WINDOW)
        self._cls_stats = ClassStats(self.classes)
        self._drift = DriftStats(backend.precision, backend.envelope)
        self._drift_tick = 0
        # the AOT program store (serve.aot): the ladder's rungs and the
        # finishers' gather through one executable cache, which the profile
        # children share; without a store the programs run eagerly
        self._exec = exec_cache
        if mesh is not None and aot is not None:
            logger.info("serve.aot: meshed slot-pool executables are not "
                        "persisted (RAM tier only)")
        elif aot is not None and exec_cache is None:
            self._exec = _bind_family(aot, "ladder", backend,
                                      max_executables)
        self._aot_params = backend.serving_params()
        self.telemetry = ServeTelemetry(
            kind="slots", family=backend.family, profile=backend.precision,
            classes=self.classes, enabled=obs_enabled,
            trace_capacity=trace_capacity, slo_ms=slo_ms,
            metrics_jsonl=metrics_jsonl, capture_path=capture_path,
            queue_depth_fn=lambda: self.queue_depth,
            evicted_depth_fn=lambda: len(self._evicted),
            pool_slots_fn=lambda: self.pool_slots,
            pool_bytes_fn=lambda: self._mem.bytes("pool"),
            ram_bytes_fn=lambda: self._mem.bytes("ram"),
            disk_bytes_fn=lambda: self._mem.bytes("disk"),
            pages_fn=(self._pages_snapshot if self._paging.enabled
                      else None),
            aot_counts_fn=(self._exec.aot_counts if self._exec is not None
                           else None))
        tm = self.telemetry
        tm.register_drift(self._drift)
        tm.registry.gauge(
            "serve_slot_occupancy", "Active slots / pool size",
            ("family", "profile")).labels(
            family=backend.family, profile=backend.precision).set_function(
            lambda: self._n_active / self.pool_slots)
        mig = tm.registry.counter(
            "serve_migrations_total",
            "Live sequences exported off / imported into this pool",
            ("family", "profile", "dir"))
        self._counters = {key: getattr(tm, key) for key in _COUNTERS
                          if hasattr(tm, key)}
        self._counters["mig_out"] = mig.labels(
            family=backend.family, profile=backend.precision, dir="out")
        self._counters["mig_in"] = mig.labels(
            family=backend.family, profile=backend.precision, dir="in")
        self._block_counters = {
            k: tm.block_dispatch.labels(family=backend.family,
                                        profile=backend.precision,
                                        block=str(k))
            for k in ladder}
        self._t_start = time.monotonic()
        self._started = threading.Event()
        self._ready = threading.Event()
        self._init_error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, args=(warmup,),
                                        daemon=True,
                                        name="serve-step-dispatch")
        self._thread.start()
        # the pool and the warmup run on the dispatcher thread
        self._ready.wait()
        if self._init_error is not None:
            raise self._init_error
        # what a parked or migrated state must match: per layer, the h
        # and c rows' dtype names and shapes
        self._layout = [((_dtype_name(h), tuple(h.shape[1:])),
                         (_dtype_name(c), tuple(c.shape[1:])))
                        for h, c in self._states]
        self._mem.set_bytes("pool", self._pool_state_bytes())
        self._mem.set_bytes("params",
                            param_bytes(backend.serving_params()))
        if self._paging.enabled:
            # the page store is the pool, under the paged name
            self._mem.set_bytes("pages", self._pool_state_bytes())
        tm.stats_fn = self.stats
        if start:
            self._started.set()
        # children: their own pools and telemetry (JSONL and capture stay
        # the parent's); their registries render in the parent's /metrics
        self._children: dict[str, StepScheduler] = {}
        for p in extra:
            child = StepScheduler(
                backend.with_profile(p), max_slots=max_slots,
                step_block=step_block, step_blocks=step_blocks,
                inflight=inflight, warmup=warmup, start=start,
                classes=classes, readback_interval_ms=readback_interval_ms,
                hysteresis=hysteresis, obs_enabled=obs_enabled,
                trace_capacity=trace_capacity, slo_ms=slo_ms,
                exec_cache=self._exec, mesh=mesh)
            self._children[p] = child
            tm.extra_registries += (child.telemetry.registry,)

    @property
    def children(self) -> dict:
        """The child schedulers, by the extra profile each serves."""
        return dict(self._children)

    @property
    def mesh_desc(self) -> str | None:
        """Serving-mesh shape (``"4x1"``) or None, surfaced in /healthz."""
        return None if self.mesh is None else mesh_desc(self.mesh)

    @property
    def step_block(self) -> int:
        """The block size in effect (the current ladder rung)."""
        return self.step_blocks[self._block_idx]

    def start(self) -> None:
        """Release the dispatcher (and the children's); idempotent."""
        self._started.set()
        for child in getattr(self, "_children", {}).values():
            child.start()

    def _bump(self, key: str, n: int = 1) -> None:
        self._counters[key].inc(n)

    def _count(self, key: str) -> int:
        return int(self._counters[key].get())

    def _pages_snapshot(self) -> dict:
        """The ``serve_pages`` gauges' figures."""
        with self._cond:
            free = len(self._row_free)
            live = len(self._live)
        return {"pages": self._pages, "rows": self._page_rows,
                "free_rows": free, "live": live}

    def _init_states(self) -> list:
        """A zero pool: one row per slot, or the page store's rows."""
        return self.backend.init_states(
            self._page_rows if self._paging.enabled else self.pool_slots)

    def _warmup(self) -> None:
        """Run each rung's block program once at the block's row count,
        then the finisher gather and one read, so the first request pays
        for no library initialisation or allocator growth. With the AOT
        store the warm manifest preloads first — every rung an earlier
        process compiled, those an elastic pool grew into included — and
        every rung's gather is warmed too."""
        if self._exec is not None:
            self._exec.preload_aot()
        rows = self._block_rows
        for k in self.step_blocks:
            _, y = self._block_call(
                self.backend.init_states(rows),
                self._put(np.zeros((rows, k, self.backend.feat_dim),
                                   np.float32)),
                self._put(np.ones((rows, 1), bool)))
            rows_out = self._gather(y, [0], [0])  # a gather per rung's shape
        rows_out.cpu()

    def warmup(self) -> None:
        """The construction-time warmup, callable later from any thread
        and idempotent (the children's too): versioned rollout stages a
        candidate through it before the traffic shift, so with the AOT
        store bound the shift compiles nothing and every fresh compile is
        on disk for the next warm spawn. It runs on fresh states, never
        the live pool."""
        with torch.inference_mode():
            self._warmup()
        for child in self._children.values():
            child.warmup()

    def _compiled_block(self, k: int, rows: int | None = None):
        """The AOT store's block program of one rung: ``(rows, k,
        profile)``, ``rows`` the block's row count by default."""
        b = self.backend
        rows = self._block_rows if rows is None else int(rows)
        return self._exec.get_or_compile(
            (rows, int(k), b.precision), b.block_pure, lambda: (
                self._aot_params, b.init_states(rows),
                torch.zeros((rows, k, b.feat_dim), device=b.device),
                torch.zeros((rows, 1), dtype=torch.bool, device=b.device)))

    def _block_call(self, states, x_dev, reset_dev):
        """One block through the backend's program: eager, or the AOT
        store's compiled rung, or sharded over the mesh's data axis."""
        if self.mesh is not None:
            return self._block_sharded(states, x_dev, reset_dev)
        if self._exec is None:
            return self.backend.block_fn(states, x_dev, reset_dev)
        exe = self._compiled_block(x_dev.shape[1], x_dev.shape[0])
        with torch.inference_mode():
            carry, y = exe(self._aot_params, states, x_dev, reset_dev)
        return [tuple(c) for c in carry], y

    def _block_sharded(self, states, xs, resets):
        """One block with its slots split over the data shards: each shard
        runs the block program on its slots' carry and rows, on its device
        and stream; the carry and outputs join in slot order on the pool's
        device. ``xs``/``resets`` are ``ShardedRows.put``'s lists or whole
        device tensors (the warmup's)."""
        rows = states[0][0].shape[0]
        share = rows // self._data_size
        head = states[0][0].device
        carries, ys = [], []
        for i, dev in enumerate(self._shards.devices):
            sl = slice(i * share, (i + 1) * share)
            with self._shards.stream(i):
                st = [(h[sl].to(dev), c[sl].to(dev)) for h, c in states]
                x = xs[i] if isinstance(xs, list) else xs[sl].to(dev)
                r = (resets[i] if isinstance(resets, list)
                     else resets[sl].to(dev))
                carry, y = self.backend.block_pure(self._shard_params[i],
                                                   st, x, r)
            carries.append(carry)
            ys.append(y)
        join = self._shards.join
        new = [(join([c[li][0] for c in carries], head),
                join([c[li][1] for c in carries], head))
               for li in range(len(states))]
        return new, join(ys, head)

    def _gather(self, y_dev, slots, subs):
        """The finishers' output rows ``y_dev[slots, subs]`` on the device.
        With the AOT store it is a compiled program of the block's shape
        (``("gather", shape, dtype)``): the lanes pad to the block's rows
        and the padding is sliced off after."""
        if self._exec is None:
            return y_dev[self._put(np.asarray(slots, np.int64)),
                         self._put(np.asarray(subs, np.int64))]
        shape = tuple(int(d) for d in y_dev.shape)
        n = len(slots)
        lanes = np.zeros((2, shape[0]), np.int64)
        lanes[0, :n], lanes[1, :n] = slots, subs
        s_dev, b_dev = self._put(lanes[0]), self._put(lanes[1])

        def gather(y, s, b):
            return y[s, b]

        key = ("gather", shape, str(y_dev.dtype).removeprefix("torch."))
        exe = self._exec.get_or_compile(key, gather,
                                        lambda: (y_dev, s_dev, b_dev))
        with torch.inference_mode():
            return exe(y_dev, s_dev, b_dev)[:n]

    def _pick_block(self) -> int:
        """This dispatch's block size from the ladder, by load with
        hysteresis (single-rung ladders short-circuit)."""
        if len(self.step_blocks) == 1:
            return self.step_blocks[0]
        load = (self._n_active + self.queue_depth) / self.pool_slots
        rungs = len(self.step_blocks)
        want = 0
        for r in range(1, rungs):
            if load >= 0.5 + 0.5 * r / (rungs - 1):
                want = r
        if want == self._block_idx:
            self._block_streak = 0
        else:
            # the streak counts ONE wanted rung: load swinging between two
            # other rungs keeps restarting it
            self._block_streak = (self._block_streak + 1
                                  if want == self._block_want else 1)
            if self._block_streak >= self.hysteresis:
                self._block_idx = want
                self._block_streak = 0
        self._block_want = want
        return self.step_blocks[self._block_idx]

    @property
    def slo_desc(self) -> dict:
        """/healthz: the admitted classes and the step-block ladder."""
        return {"classes": list(self.classes),
                "step_blocks": list(self.step_blocks)}

    @property
    def load_desc(self) -> dict:
        """/healthz: constant-time load figures, the preemption, budget
        and migration counts (and the live paged sequences) included."""
        tm = self.telemetry
        n = int(tm.steps.get())
        occ = tm.occupancy_sum.get()
        out = {"queued": self.queue_depth, "active": self._n_active,
               "slots": self.pool_slots,
               "mean_occupancy": round(occ / n, 4) if n else 0.0,
               "preempted": self._count("preempted"),
               "evicted_depth": len(self._evicted),
               "ledger_bytes": int(self._mem.bytes("ram")
                                   + self._mem.bytes("disk")),
               "spilled": self._count("spills"),
               "migrations": self._count("mig_in") + self._count("mig_out")}
        if self._paging.enabled:
            out["pages_live"] = len(self._live)
        if self._exec is not None:
            out["aot_hits"] = int(self._exec.aot_counts()["hits"])
        return out

    @property
    def precision_desc(self) -> dict:
        """/healthz and the banner: profile, envelope, params' size, and
        the served profiles where children serve more."""
        desc = self._drift.desc(param_bytes(self.backend.serving_params()))
        if self._children:
            desc["profiles"] = [self.backend.precision, *self._children]
        return desc

    def _put(self, x: np.ndarray | torch.Tensor) -> torch.Tensor:
        return upload(x, self.backend.device)

    # -- request side ---------------------------------------------------
    def submit(self, x: np.ndarray, max_wait_s: float | None = None,
               cls: str | None = None, tag: str | None = None,
               profile: str | None = None) -> Future:
        """Enqueue one sequence ``(T, F)``; resolves to ``(out_dim,)``.
        ``cls`` names the SLO class (default: the most urgent);
        ``max_wait_s`` sets the deadline that orders admission within a
        class and bounds the output's wait for its readback; ``tag`` is
        an export handle (:meth:`export_sequence`, ``/admin/export``);
        ``profile`` routes the request to that profile's child
        scheduler."""
        child = _route(self, profile)
        if child is not None:
            return child.submit(x, max_wait_s=max_wait_s, cls=cls, tag=tag)
        x = np.asarray(x, np.float32)
        cls, prio = resolve_request_class(self._class_priority, cls)
        if x.ndim != 2 or x.shape[1] != self.backend.feat_dim:
            raise ServeError(
                f"sequence must be (steps, {self.backend.feat_dim}), "
                f"got {x.shape}")
        if len(x) == 0:
            raise ServeError("sequence must have at least one step")
        fault_point("serve.request", rows=len(x))
        if self._evicted:
            # a parked sequence past its deadline is shed here too, not
            # only at the dispatcher's next block boundary
            self._sweep_expired()
        if self._budget.enabled:
            # a fire rejects only this submit
            fault_point("serve.budget", rows=len(x),
                        queue_bytes=int(self._mem.bytes("queue")))
        tm = self.telemetry
        req = SeqRequest(x=x, cls=cls, priority=prio, tag=tag,
                         span=tm.span_start(cls))
        if max_wait_s is not None:
            req.deadline = req.t_submit + max(0.0, float(max_wait_s))
        with self._cond:
            if self._aborted is not None:
                raise ServeError(f"engine stopped after a dispatcher "
                                 f"failure ({self._aborted!r}); request "
                                 f"rejected")
            if self._closed:
                raise ServeError("engine is closed; request rejected")
            if self._budget.enabled:
                # the budget's front door: reserve or shed naming it
                admit_queue_bytes(self._mem, self._budget, x.nbytes, cls,
                                  tm.budget_shed.inc, logger)
            # counted only past the closed check: a rejected submit is
            # not a request
            tm.requests.inc()
            req.seq = req.arrival = self._n_submitted
            self._n_submitted += 1
            heapq.heappush(self._q, (req.priority, req.deadline,
                                     req.arrival, req.seq, req))
            self._cond.notify_all()
        # captured after admission: a rejected submit is not workload
        tm.capture_request(cls, steps=len(x), deadline_s=max_wait_s)
        return req.future

    def predict(self, x: np.ndarray, max_wait_s: float | None = None,
                cls: str | None = None, tag: str | None = None,
                profile: str | None = None) -> np.ndarray:
        return self.submit(x, max_wait_s=max_wait_s, cls=cls, tag=tag,
                           profile=profile).result()

    # -- dispatcher thread ----------------------------------------------
    @property
    def _n_active(self) -> int:
        if self._paging.enabled:
            # every admitted, unfinished sequence, row-holding or demoted
            return len(self._live)
        return self.pool_slots - len(self._free)

    def _admit_locked(self) -> list[tuple[SeqRequest, BaseException]]:
        """Fill freed slots in (class priority, deadline, arrival) order;
        a request whose future is already done (cancelled, shed while
        parked) is dropped. An admitted slot's state is zeroed in its
        first block; a parked sequence's rows are restored instead (no
        reset). Under an enabled budget a head whose spilled state needs
        RAM the ledger cannot free stays parked (the backpressure
        rung). A fired ``serve.admit`` fault fails only that request:
        returned as ``(request, exception)`` pairs, failed by the caller
        outside the lock."""
        if self._paging.enabled:
            return self._admit_paged_locked()
        failed: list[tuple[SeqRequest, BaseException]] = []
        self._deferred_head = None
        while self._free and self._q:
            head = self._q[0][-1]
            if (self._budget.enabled and not self._closed
                    and isinstance(head.evicted_state, _Spilled)
                    and not head.future.done()):
                need = head.evicted_state.ram_bytes
                if (self._mem.headroom("ram") < need
                        and not self._restore_room_locked(need)):
                    self._deferred_head = head
                    self._bump("budget_deferred")
                    if self._defer_logged_seq != head.seq:
                        self._defer_logged_seq = head.seq
                        logger.warning(
                            "serve.budget: restore of one %s sequence "
                            "deferred — %d blob bytes need RAM the "
                            "ledger cannot free (ram %d, disk %d)",
                            head.cls, need, self._mem.bytes("ram"),
                            self._mem.bytes("disk"))
                    break
            req = heapq.heappop(self._q)[-1]
            self._release_queue_bytes(req)
            if req.future.done():
                if self._evicted.pop(req.seq, None) is not None:
                    self._unpark(req)
                continue
            try:
                fault_point("serve.admit", cls=req.cls,
                            queued=len(self._q), free=len(self._free))
            except Exception as e:  # noqa: BLE001 — fail this request only
                if self._evicted.pop(req.seq, None) is not None:
                    self._unpark(req)
                failed.append((req, e))
                continue
            slot = self._free.pop()
            self._slot_req[slot] = req
            self._slot_pos[slot] = req.pos
            # admission retires the ledger entry of both kinds of victim:
            # a never-dispatched one (no state) must not leak a place
            self._evicted.pop(req.seq, None)
            if req.evicted_state is not None:
                self._pending_restore[slot] = req
            else:
                self._pending_reset.add(slot)
                # slot admission is this scheduler's batch cut (a
                # restored sequence keeps its first one)
                self.telemetry.span_stage(req.span, "batch_cut")
        return failed

    def _admit_paged_locked(self) -> list[tuple[SeqRequest,
                                                BaseException]]:
        """Paged admission: the live set fills from the heap in the same
        order up to ``max_live``; a row is taken only when the sequence
        is first scheduled, so admission moves no state. The same
        ``serve.admit`` contract as the dense path."""
        failed: list[tuple[SeqRequest, BaseException]] = []
        self._deferred_head = None
        while self._q and len(self._live) < self._max_live:
            req = heapq.heappop(self._q)[-1]
            self._release_queue_bytes(req)
            if req.future.done():
                if self._evicted.pop(req.seq, None) is not None:
                    self._unpark(req)
                continue
            try:
                fault_point("serve.admit", cls=req.cls,
                            queued=len(self._q),
                            free=self._max_live - len(self._live))
            except Exception as e:  # noqa: BLE001 — fail this request only
                if self._evicted.pop(req.seq, None) is not None:
                    self._unpark(req)
                failed.append((req, e))
                continue
            self._evicted.pop(req.seq, None)
            req.row = None
            req.last_block = -1  # never scheduled: coldest, FIFO
            self._live[req.seq] = req
            self._pg_peak_live = max(self._pg_peak_live, len(self._live))
            if req.evicted_state is None and req.pos == 0:
                self.telemetry.span_stage(req.span, "batch_cut")
        return failed

    def _release_queue_bytes(self, req: SeqRequest) -> None:
        """Retire a request's queue-class bytes once (enabled budgets)."""
        if self._budget.enabled and not req.queue_released:
            self._mem.sub("queue", req.x.nbytes)
            req.queue_released = True

    def _requeue_locked(self, req: SeqRequest) -> None:
        """Park ``req`` in the ledger and back in the heap under its
        original ordering (called under ``self._cond``)."""
        self._evicted[req.seq] = req
        if self._budget.enabled:
            self._mem.add("queue", req.x.nbytes)
            req.queue_released = False
        heapq.heappush(self._q, (req.priority, req.deadline, req.arrival,
                                 req.seq, req))

    def _restore_room_locked(self, need: int) -> bool:
        """Could spilling the RAM-parked blobs (LRU, up to the disk
        tier's headroom) free ``need`` RAM bytes for a restore read?"""
        if not self._budget.spill_dir:
            return False
        spillable = sum(r.state_bytes for r in self._evicted.values()
                        if isinstance(r.evicted_state, list)
                        and r.state_bytes and not r.future.done())
        room = self._mem.headroom("ram") + min(
            spillable, max(0.0, self._mem.headroom("disk")))
        return room >= need

    def _unpark(self, req: SeqRequest) -> None:
        """Retire one parked state's accounting: RAM bytes released, a
        spill file deleted and the disk tier shrunk."""
        state = req.evicted_state
        if isinstance(state, _Spilled):
            self._mem.sub("disk", state.nbytes)
            _remove(state.path)
        elif state is not None and req.state_bytes:
            self._mem.sub("ram", req.state_bytes)
        req.evicted_state = None
        req.state_bytes = 0

    def _admit_or_wait(self) -> bool:
        """One block boundary: shed expired parked sequences, pack filed
        exports, preempt for the queue, tick the elastic pool, admit.
        Blocks while fully idle; False once closed and drained (the
        dispatcher exits)."""
        while True:
            self._sweep_expired()
            self._process_exports()
            self._preempt_for_queue()
            self._maybe_resize()
            shed_head: SeqRequest | None = None
            with self._cond:
                failed = self._admit_locked()
                if failed or (self._n_active or not self._buffer.empty
                              or self._staged):
                    pass  # work to do: stage the restores below
                elif self._closed and not self._q:
                    return False
                else:
                    timeout = self._parked_timeout_locked()
                    head = self._deferred_head
                    if (timeout is None and head is not None
                            and not head.future.done()):
                        # an idle pool and a deadline-less deferred head:
                        # the RAM its restore needs is held by the blobs
                        # queued behind it and will never free. Rung 3:
                        # shed it naming the budget
                        self._evicted.pop(head.seq, None)
                        self._unpark(head)
                        self._release_queue_bytes(head)
                        self._deferred_head = None
                        shed_head = head
                    else:
                        # a bounded wait: a parked deadline or a filed
                        # export is noticed without a notify too
                        self._cond.wait(1.0 if timeout is None
                                        else min(timeout, 1.0))
                        continue
            if shed_head is not None:
                logger.warning(
                    "serve.budget: shedding one deferred %s sequence — "
                    "its spill restore needs RAM the ledger can never "
                    "free (idle pool, no deadline to wait for)",
                    shed_head.cls)
                self._bump("budget_shed")
                self._fail([shed_head], ServeError(
                    f"evicted {shed_head.cls} sequence shed: "
                    f"serve.budget.ledger_bytes cannot free the RAM "
                    f"its spill restore needs and the pool is idle"),
                    "budget", error=False)
                continue
            if failed:
                for req, exc in failed:
                    logger.warning("admission fault for one %s sequence "
                                   "(%r); it fails, the pool keeps "
                                   "serving", req.cls, exc)
                    self._fail([req], exc, "admission", error=False)
                continue
            # restores' uploads start outside the lock, ahead of the
            # block that needs them
            self._stage_restores()
            return True

    # -- preemption and the elastic pool --------------------------------
    def _parked_timeout_locked(self) -> float | None:
        """Seconds to the earliest parked deadline, None if none."""
        dls = [r.deadline for r in self._evicted.values()
               if r.deadline < math.inf]
        if not dls:
            return None
        return max(0.0, min(dls) - time.monotonic()) + 0.001

    def _sweep_expired(self) -> int:
        """Fail every parked sequence whose deadline passed, loudly: a
        ServeError naming the overrun, a shed count and a warning. Runs
        at every block boundary and from submit, stats() and close, so
        an idle dispatcher does not hide an expiry."""
        if not self._evicted:
            return 0
        now = time.monotonic()
        expired: list[SeqRequest] = []
        with self._cond:
            for seq, req in list(self._evicted.items()):
                if req.deadline < now:
                    del self._evicted[seq]
                    self._unpark(req)
                    # the heap entry is dead weight: its queue bytes go now
                    self._release_queue_bytes(req)
                    expired.append(req)
        for req in expired:
            overdue_ms = (now - req.deadline) * 1e3
            logger.warning(
                "shedding evicted %s sequence: deadline passed %.1f ms "
                "ago while preempted (ledger depth %d)", req.cls,
                overdue_ms, len(self._evicted))
            self._bump("preempt_shed")
            self._fail([req], ServeError(
                f"evicted {req.cls} sequence shed: deadline passed "
                f"{overdue_ms:.1f} ms ago while preempted"), "preempt",
                error=False)
        return len(expired)

    def _ledger_blocked(self) -> bool:
        """The ledger's bound or (rung 1) the budget refuses another
        victim: warned and counted."""
        if len(self._evicted) >= self._preempt.max_evicted:
            logger.warning(
                "preemption skipped: eviction ledger full (%d/%d parked)",
                len(self._evicted), self._preempt.max_evicted)
            return True
        if not self._ledger_room(self._per_slot_state_bytes()):
            self._bump("budget_deferred")
            logger.warning(
                "preemption skipped: serve.budget ledger cannot hold "
                "another victim (ram %d/%s, disk %d/%s)",
                self._mem.bytes("ram"), self._mem.budget("ram"),
                self._mem.bytes("disk"), self._mem.budget("disk"))
            return True
        return False

    def _preempt_for_queue(self) -> None:
        """Evict slot-holders the heap's head outranks — a strictly more
        urgent class only (same-class deadlines never preempt), one slot
        per eviction, until the urgent backlog fits the free slots or the
        ledger refuses."""
        if not self._preempt.enabled:
            return
        if self._paging.enabled:
            self._preempt_paged()
            return
        while True:
            victim, vkey = None, None
            for slot, req in enumerate(self._slot_req):
                if req is None:
                    continue
                key = (req.priority, req.deadline, req.arrival, req.seq)
                if vkey is None or key > vkey:
                    victim, vkey = slot, key
            if victim is None:
                return
            need = len(self._free) + 1
            with self._cond:
                if not self._q or self._q[0][0] >= vkey[0]:
                    return  # nothing queued outranks the worst holder
                urgent = 0
                for p, _d, _a, _s, r in self._q:
                    if p < vkey[0] and not r.future.done():
                        urgent += 1
                        if urgent >= need:
                            break
            if urgent <= len(self._free):
                return  # the urgent backlog fits without evicting
            if self._ledger_blocked():
                return
            self._evict_slot(victim, reason="preempt")

    def _preempt_paged(self) -> None:
        """Paged preemption: with the live set full and the heap's head
        outranking (by class) the least urgent live sequence, that one
        parks back in the ledger and the heap."""
        while True:
            with self._cond:
                if len(self._live) < self._max_live:
                    return  # admission has room already
                victim, vkey = None, None
                for req in self._live.values():
                    if req.future.done():
                        continue
                    key = (req.priority, req.deadline, req.arrival,
                           req.seq)
                    if vkey is None or key > vkey:
                        victim, vkey = req, key
                if victim is None or not self._q \
                        or self._q[0][0] >= vkey[0]:
                    return
            if self._ledger_blocked():
                return
            self._evict_live(victim, reason="preempt")

    def _gather_rows(self, row: int) -> list:
        """One pool row's per-layer (h, c) on the host in the pool's own
        dtype: one device gather and one read, which returns only when
        the copy is done — the row is on the host before the slot is
        reused."""
        parts = [t[row] for h, c in self._states for t in (h, c)]
        flat = torch.cat(parts).cpu().split([p.numel() for p in parts])
        return [(flat[2 * i].clone(), flat[2 * i + 1].clone())
                for i in range(len(parts) // 2)]

    def _scatter_row(self, row: int, payload: list) -> None:
        """Write parked rows back into pool row ``row``: out of place, so
        no block in flight reads a tensor being written."""
        dev = self.backend.device
        idx = self._put(np.array([row], np.int64))
        self._states = [
            (h.index_copy(0, idx, ph.to(dev).reshape(1, -1)),
             c.index_copy(0, idx, pc.to(dev).reshape(1, -1)))
            for (h, c), (ph, pc) in zip(self._states, payload)]

    def _evict_live(self, req: SeqRequest, reason: str) -> bool:
        """Park one live paged sequence in the ledger and back in the
        heap under its original ordering (the paged :meth:`_evict_slot`).
        A failed gather fails only this victim."""
        row = req.row
        try:
            fault_point("serve.preempt", cls=req.cls, pos=req.pos,
                        slot=-1 if row is None else row, reason=reason)
            state = req.evicted_state
            if state is None and row is not None and req.pos > 0:
                state = self._gather_rows(row)
        except Exception as e:  # noqa: BLE001 — lose only the victim
            logger.warning("eviction fault for one %s sequence (%r); the "
                           "victim fails, the pool keeps serving",
                           req.cls, e)
            self._drop_live(req)
            self._fail([req], e, "eviction", error=False)
            return False
        if state is not None and req.evicted_state is None:
            self._park_host_state(req, state)
        self._free_row(req)
        with self._cond:
            self._live.pop(req.seq, None)
            req.t_evicted = time.monotonic()
            self._requeue_locked(req)
        self._bump("preempted")
        return True

    def _park_host_state(self, req: SeqRequest, state: list) -> None:
        """Account gathered rows to the RAM tier, spilling colder blobs
        first under an enabled budget; an overshoot parks anyway,
        loudly — never a drop."""
        nb = _state_nbytes(state)
        req.state_bytes = nb
        req.evicted_state = state
        req.t_evicted = time.monotonic()
        if (self._budget.enabled and self._mem.headroom("ram") < nb
                and not self._make_ledger_room(nb)):
            logger.warning(
                "serve.budget: ledger overshoot parking one %s sequence "
                "(%d bytes, ram %d/%s) — parked anyway, never dropped",
                req.cls, nb, self._mem.bytes("ram"),
                self._mem.budget("ram"))
        self._mem.add("ram", nb)

    def _alloc_row(self) -> int:
        """The lowest free page-store row (a heap): pages fill in order,
        so free pages stay whole."""
        return heapq.heappop(self._row_free)

    def _free_row(self, req: SeqRequest) -> None:
        if req.row is not None:
            heapq.heappush(self._row_free, req.row)
            req.row = None

    def _drop_live(self, req: SeqRequest) -> None:
        """Retire a live paged sequence that did not finish: row freed,
        parked bytes released, live entry removed."""
        self._free_row(req)
        with self._cond:
            self._live.pop(req.seq, None)
            self._unpark(req)

    def _pool_state_bytes(self) -> int:
        """Device bytes of the pool's (or page store's) (h, c) state."""
        return sum(h.numel() * h.element_size()
                   + c.numel() * c.element_size() for h, c in self._states)

    def _per_slot_state_bytes(self) -> int:
        """Host bytes one victim's rows take (eviction is a row gather
        in the pool's own dtype, so this is exact)."""
        rows = self._page_rows if self._paging.enabled \
            else self.pool_slots
        return self._pool_state_bytes() // max(1, rows)

    def _ledger_room(self, need: int) -> bool:
        """Can the ledger hold ``need`` more bytes, in RAM or by spilling
        cold RAM blobs to a disk tier with headroom? Always True with the
        budget off."""
        if not self._budget.enabled:
            return True
        if self._mem.headroom("ram") >= need:
            return True
        if not self._budget.spill_dir:
            return False
        return (self._mem.headroom("ram")
                + max(0.0, self._mem.headroom("disk"))) >= need

    def _free_slot(self, slot: int) -> None:
        self._slot_req[slot] = None
        self._slot_pos[slot] = 0
        self._free.append(slot)
        self._pending_reset.discard(slot)

    def _evict_slot(self, slot: int, reason: str) -> bool:
        """Park one slot-holder in the ledger and free its slot. A slot
        whose restore is not applied yet still holds a previous
        occupant's rows: its parked state stays the truth. A failed
        gather or spill fails only this victim."""
        req = self._slot_req[slot]
        pos = self._slot_pos[slot]
        restore_pending = self._pending_restore.get(slot) is not None
        gathered = False
        try:
            fault_point("serve.preempt", cls=req.cls, pos=pos, slot=slot,
                        reason=reason)
            if restore_pending:
                state = req.evicted_state
            elif slot in self._pending_reset or pos == 0:
                state = None  # never dispatched: nothing on the device
            else:
                state = self._gather_rows(slot)
                gathered = True
        except Exception as e:  # noqa: BLE001 — lose only the victim
            logger.warning("eviction fault for one %s sequence (%r); the "
                           "victim fails, the pool keeps serving",
                           req.cls, e)
            if restore_pending:
                self._pending_restore.pop(slot, None)
                self._restore_staged.discard(slot)
                self._unpark(req)
            self._free_slot(slot)
            self._fail([req], e, "eviction", error=False)
            return False
        if restore_pending:
            self._pending_restore.pop(slot, None)
            self._restore_staged.discard(slot)
        if gathered:
            # make RAM room first (LRU spill of colder blobs); with no
            # colder blob to displace the victim spills to disk itself
            nb = _state_nbytes(state)
            req.state_bytes = nb
            if (self._budget.enabled and self._mem.headroom("ram") < nb
                    and not self._make_ledger_room(nb)):
                spilled = None
                if self._budget.spill_dir:
                    try:
                        path, fb = self._write_spill(req, state)
                    except Exception as e:  # noqa: BLE001 — victim only
                        logger.warning(
                            "spill fault for one %s sequence (%r); the "
                            "victim fails, the pool keeps serving",
                            req.cls, e)
                        self._free_slot(slot)
                        req.state_bytes = 0
                        self._fail([req], e, "spill", error=False)
                        return False
                    if self._mem.headroom("disk") >= fb:
                        spilled = _Spilled(path, fb, nb)
                        self._mem.add("disk", fb)
                        self._bump("spills")
                    else:
                        _remove(path)
                if spilled is not None:
                    state = spilled
                else:
                    logger.warning(
                        "serve.budget: ledger overshoot parking one %s "
                        "victim (%d bytes, ram %d/%s) — parked anyway, "
                        "never dropped", req.cls, nb,
                        self._mem.bytes("ram"), self._mem.budget("ram"))
                    self._mem.add("ram", nb)
            else:
                self._mem.add("ram", nb)
        req.pos = pos
        req.evicted_state = state
        req.t_evicted = time.monotonic()
        self._free_slot(slot)
        with self._cond:
            self._requeue_locked(req)
        self._bump("preempted")
        return True

    # -- the spill tier (serve.budget) ----------------------------------
    def _make_ledger_room(self, need: int) -> bool:
        """Spill the coldest (longest-parked) RAM blobs to disk until
        ``need`` bytes fit the RAM tier; whether they now fit."""
        if not (self._budget.enabled and self._budget.spill_dir):
            return self._mem.headroom("ram") >= need
        while self._mem.headroom("ram") < need:
            with self._cond:
                cands = [r for r in self._evicted.values()
                         if r.state_bytes
                         and isinstance(r.evicted_state, list)
                         and not r.future.done()]
                if self._paging.enabled:
                    # demoted live sequences' blobs are as cold
                    cands += [r for r in self._live.values()
                              if r.state_bytes
                              and isinstance(r.evicted_state, list)
                              and not r.future.done()]
                victim = min(cands, key=lambda r: r.t_evicted,
                             default=None)
            if victim is None or not self._spill_one(victim):
                break
        return self._mem.headroom("ram") >= need

    def _write_spill(self, req: SeqRequest, state: list) -> tuple[str, int]:
        """One spill file: crc32-checked EMT1 in the pool's own dtype
        (bfloat16 as code 6). Returns ``(path, file bytes)``; raises on
        an IO failure or a fired ``serve.spill`` fault (the caller loses
        only that victim)."""
        path = os.path.join(self._budget.spill_dir,
                            f"spill-{self._token}-{req.seq}.emt1")
        try:
            fault_point("serve.spill", cls=req.cls, seq=req.seq,
                        bytes=req.state_bytes)
            os.makedirs(self._budget.spill_dir, exist_ok=True)
            serialization.save(path, {
                f"{i}.{tag}": arr
                for i, (h, c) in enumerate(state)
                for tag, arr in (("h", h), ("c", c))})
            return path, os.path.getsize(path)
        except Exception:
            _remove(path)
            raise

    def _spill_one(self, req: SeqRequest) -> bool:
        """Move one RAM-parked blob to disk; False when the disk tier
        cannot take it. A failed write fails only this victim (its RAM
        is freed, so room was made)."""
        paged_live = self._paging.enabled and req.seq in self._live
        with self._cond:
            state = req.evicted_state
            if (req.seq not in self._evicted and not paged_live) \
                    or not isinstance(state, list):
                return True  # shed or cancelled meanwhile
        try:
            path, nbytes = self._write_spill(req, state)
        except Exception as e:  # noqa: BLE001 — lose only this victim
            if paged_live:
                self._drop_live(req)
            else:
                with self._cond:
                    gone = self._evicted.pop(req.seq, None)
                if gone is None:
                    return True
                self._mem.sub("ram", req.state_bytes)
                req.evicted_state = None
                req.state_bytes = 0
            logger.warning("spill fault for one %s sequence (%r); the "
                           "victim fails, the pool keeps serving",
                           req.cls, e)
            self._fail([req], e, "spill", error=False)
            return True
        if self._mem.headroom("disk") < nbytes:
            _remove(path)
            return False  # the disk tier is full too (rung 1 gates)
        drop = False
        with self._cond:
            if (req.seq not in self._evicted
                    and not (self._paging.enabled
                             and req.seq in self._live)) \
                    or req.future.done():
                drop = True  # shed while the file was written
            else:
                req.evicted_state = _Spilled(path, nbytes, req.state_bytes)
                self._mem.sub("ram", req.state_bytes)
                self._mem.add("disk", nbytes)
        if drop:
            _remove(path)
            return True
        self._bump("spills")
        return True

    def _read_parked_state(self, req: SeqRequest) -> list:
        """``req.evicted_state`` as host (h, c) rows. A spilled state is
        read back through the crc32-checked loader and its file retired
        (the RAM tier holds the rows until the scatter); a corrupt or
        unreadable file raises naming it, with its accounting retired."""
        state = req.evicted_state
        if not isinstance(state, _Spilled):
            return state
        try:
            arrays = serialization.load(state.path)
            host = [(arrays[f"{i}.h"], arrays[f"{i}.c"])
                    for i in range(len(arrays) // 2)]
        except Exception as e:
            self._mem.sub("disk", state.nbytes)
            _remove(state.path)
            req.evicted_state = None
            req.state_bytes = 0
            raise CheckpointError(f"spill file {state.path}: {e}") from e
        _remove(state.path)
        self._mem.sub("disk", state.nbytes)
        self._mem.add("ram", state.ram_bytes)
        req.evicted_state = host
        req.state_bytes = state.ram_bytes
        self._bump("spill_restored")
        return host

    def _stage_restores(self) -> None:
        """Start the uploads of newly admitted restores: each parked
        state (read back from disk first when spilled; a corrupt file
        sheds its sequence only) is checked against the pool and
        uploaded without a host sync, so the copy overlaps the block in
        flight; ``_apply_restores`` scatters it. ``_restore_async =
        False`` keeps the payload on the host until the scatter."""
        if not self._pending_restore:
            return
        for slot, req in list(self._pending_restore.items()):
            if slot in self._restore_staged:
                continue
            try:
                if (self._budget.enabled
                        and isinstance(req.evicted_state, _Spilled)):
                    self._make_ledger_room(req.evicted_state.ram_bytes)
                payload = self._read_parked_state(req)
                self._check_restore_payload(payload)
            except Exception as e:  # noqa: BLE001 — shed one, keep serving
                self._shed_spill_casualty(slot, req, e)
                continue
            if self._restore_async:
                payload = [(self._put(h), self._put(c))
                           for h, c in payload]
            self._restore_staged.add(slot)
            done = self._restore_buf.push((slot, req, payload))
            if done is not None:
                self._apply_restore_item(done)

    def _shed_spill_casualty(self, slot: int, req: SeqRequest,
                             exc: BaseException) -> None:
        """A parked state that could not be read back or does not fit
        the pool loses only its sequence: its future carries a ServeError
        naming the failure and its slot frees."""
        self._pending_restore.pop(slot, None)
        self._restore_staged.discard(slot)
        self._free_slot(slot)
        logger.warning("spill restore failed for one %s sequence (%r); "
                       "shedding it, the pool keeps serving", req.cls, exc)
        self._bump("budget_shed")
        self._fail([req], ServeError(
            f"evicted {req.cls} sequence shed: spill blob failed to "
            f"restore ({exc!r})"), "restore", error=False)

    def _apply_restore_item(self, item) -> None:
        """Scatter one staged restore into its slot; a stale item (the
        holder was evicted again before the scatter) is skipped — its
        parked state is still the truth."""
        slot, req, payload = item
        if self._pending_restore.get(slot) is not req:
            return
        self._scatter_row(slot, payload)
        del self._pending_restore[slot]
        self._restore_staged.discard(slot)
        if req.state_bytes:
            self._mem.sub("ram", req.state_bytes)
        req.evicted_state = None
        req.state_bytes = 0
        self._bump("restored")

    def _apply_restores(self) -> None:
        """Apply every staged restore (staging stragglers first) before
        the next dispatch."""
        for item in self._restore_buf.drain():
            self._apply_restore_item(item)
        if self._pending_restore:
            self._stage_restores()
            for item in self._restore_buf.drain():
                self._apply_restore_item(item)

    # -- live migration ---------------------------------------------------
    def export_sequence(self, target, *, reason: str = "migrate",
                        timeout_s: float = 30.0) -> bytes | None:
        """Evict and pack one live sequence into a migration blob and
        remove it from this scheduler: its slot or row frees, its ledger
        entry and bytes retire, and its future fails with a ServeError
        naming the move. ``target`` is the future :meth:`submit`
        returned, the sequence's ``tag``, or its local ordinal. None when
        the sequence is not live here (finished, shed, unknown) or the
        dispatcher did not pack it within ``timeout_s``. Thread-safe:
        the dispatcher packs it at its next block boundary."""
        fut: Future = Future()
        with self._cond:
            if self._closed:
                return None
            self._export_q.append((target, reason, fut))
            self._cond.notify_all()
        try:
            return fut.result(timeout_s)
        except FutureTimeoutError:
            # cancel, so a late pass skips it rather than remove the
            # sequence with no reader
            if fut.cancel():
                logger.warning(
                    "export_sequence timed out after %.1fs (reason=%s); "
                    "the sequence stays on this host", timeout_s, reason)
                return None
            return fut.result(timeout_s)  # the pack is under way
        except CancelledError:
            return None

    def drain_export(self, *, reason: str = "respawn",
                     timeout_s: float = 30.0) -> list[bytes]:
        """Export every live sequence — slot-holders, parked, queued —
        as migration blobs; those that finish meanwhile are absent."""
        with self._cond:
            targets: list[Future] = [
                r.future for r in self._slot_req if r is not None]
            targets += [r.future for r in self._live.values()]
            targets += [r.future for r in self._evicted.values()]
            targets += [e[-1].future for e in self._q
                        if not e[-1].future.done()]
        blobs, seen = [], set()
        for tgt in targets:
            if id(tgt) in seen:
                continue
            seen.add(id(tgt))
            blob = self.export_sequence(tgt, reason=reason,
                                        timeout_s=timeout_s)
            if blob is not None:
                blobs.append(blob)
        return blobs

    def import_sequence(self, blob: bytes) -> Future:
        """Admit one migration blob of a peer scheduler (of either
        package). Its header is judged against this pool first — model
        fingerprint, family, profile, pool dtype, row shapes, feat_dim —
        and a mismatch raises a ServeError naming the field. The sequence
        queues under its original (class, deadline, arrival) ordering
        (the deadline travels as remaining seconds) and its rows restore
        through the same scatter as a preempted one."""
        header, x, state = unpack_migration(blob)
        self._check_migration_header(header)
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape != (int(header["steps"]),
                                      self.backend.feat_dim):
            raise ServeError(
                f"migration blob rejected: input entry 'x' is "
                f"{x.shape}, header says ({header['steps']}, "
                f"{self.backend.feat_dim})")
        cls, prio = resolve_request_class(self._class_priority,
                                          str(header["cls"]))
        req = SeqRequest(x=x, cls=cls, priority=prio,
                         span=self.telemetry.span_start(cls))
        deadline_s = header.get("deadline_s")
        if deadline_s is not None:
            req.deadline = time.monotonic() + max(0.0, float(deadline_s))
        req.pos = int(header["pos"])
        if state is not None:
            payload = [(_as_tensor(h), _as_tensor(c)) for h, c in state]
            self._check_restore_payload(payload)
            req.evicted_state = payload
            req.state_bytes = _state_nbytes(payload)
            req.t_evicted = time.monotonic()
            if self._budget.enabled:
                self._make_ledger_room(req.state_bytes)
        with self._cond:
            if self._closed:
                raise ServeError("engine is closed; migration rejected")
            if self._budget.enabled:
                admit_queue_bytes(self._mem, self._budget, x.nbytes, cls,
                                  self.telemetry.budget_shed.inc, logger)
            self.telemetry.requests.inc()
            req.seq = self._n_submitted
            self._n_submitted += 1
            req.arrival = int(header["arrival"])
            if req.evicted_state is not None:
                self._evicted[req.seq] = req
                if req.state_bytes:
                    if (self._budget.enabled and self._mem.headroom("ram")
                            < req.state_bytes):
                        logger.warning(
                            "serve.budget: ledger overshoot parking one "
                            "migrated-in %s sequence (%d bytes, ram "
                            "%d/%s) — parked anyway, never dropped",
                            req.cls, req.state_bytes,
                            self._mem.bytes("ram"),
                            self._mem.budget("ram"))
                    self._mem.add("ram", req.state_bytes)
            heapq.heappush(self._q, (req.priority, req.deadline,
                                     req.arrival, req.seq, req))
            self._cond.notify_all()
        self._bump("mig_in")
        self._observe({"event": "migrate_import", "cls": cls,
                       "pos": req.pos, "steps": req.steps,
                       "arrival": req.arrival})
        return req.future

    def _check_migration_header(self, header: dict) -> None:
        """Judge a migration header against this pool: identity is the
        params fingerprint, layout the profile, pool dtype, per-layer row
        shapes and feat_dim. A mismatch is a ServeError naming the
        field."""
        for key, want in (("model", self._model_fingerprint),
                          ("family", self.backend.family),
                          ("profile", self.backend.precision),
                          ("pool_dtype", self._layout[0][0][0]),
                          ("feat_dim", int(self.backend.feat_dim)),
                          ("layers", [list(h[1]) for h, _c in self._layout])):
            got = header.get(key)
            if got != want:
                raise ServeError(
                    f"migration blob rejected: header field {key!r} "
                    f"does not match this pool (blob {got!r}, pool "
                    f"{want!r})")

    def _check_restore_payload(self, payload: list) -> None:
        """Parked (h, c) rows must match the pool's per-layer dtype and
        row shape exactly before any scatter; a mismatch sheds its one
        sequence with the field named, never a scatter of reinterpreted
        bytes."""
        if len(payload) != len(self._layout):
            raise ServeError(
                f"restore blob rejected: field 'layers' mismatched "
                f"(blob has {len(payload)} layers, pool has "
                f"{len(self._layout)})")
        for i, ((ph, pc), layout) in enumerate(zip(payload, self._layout)):
            for tag, arr, (want_dt, shape) in (("h", ph, layout[0]),
                                               ("c", pc, layout[1])):
                got_dt = _dtype_name(arr)
                if got_dt != want_dt:
                    raise ServeError(
                        f"restore blob rejected: field 'dtype' "
                        f"mismatched at layer {i}.{tag} (blob "
                        f"{got_dt}, pool {want_dt})")
                if tuple(arr.shape) != shape:
                    raise ServeError(
                        f"restore blob rejected: field 'shape' "
                        f"mismatched at layer {i}.{tag} (blob "
                        f"{tuple(arr.shape)}, pool {shape})")

    def _process_exports(self) -> None:
        """The dispatcher's half of :meth:`export_sequence`: evict and
        pack each filed target at the block boundary."""
        if not self._export_q:
            return
        with self._cond:
            batch, self._export_q = self._export_q, []
        for target, reason, fut in batch:
            if not fut.set_running_or_notify_cancel():
                continue  # the exporter timed out and cancelled
            try:
                fut.set_result(self._export_one(target, reason))
            except Exception as e:  # noqa: BLE001 — fail this export only
                fut.set_exception(e)

    def _export_one(self, target, reason: str) -> bytes | None:
        """Evict and pack one export target on the dispatcher thread; None
        when it is not live here (or its eviction failed it)."""
        req = None
        if self._paging.enabled:
            with self._cond:
                cand = next(
                    (r for r in self._live.values()
                     if self._export_matches(r, target)
                     and not r.future.done()), None)
            if cand is not None:
                if not self._evict_live(cand, reason=reason):
                    return None
                req = cand
        else:
            for slot, r in enumerate(self._slot_req):
                if r is not None and self._export_matches(r, target):
                    if not self._evict_slot(slot, reason=reason):
                        return None
                    req = r
                    break
        if req is None:
            with self._cond:
                for r in self._evicted.values():
                    if self._export_matches(r, target):
                        req = r
                        break
                if req is None:
                    for entry in self._q:
                        r = entry[-1]
                        if (self._export_matches(r, target)
                                and not r.future.done()):
                            req = r
                            break
        if req is None or req.future.done():
            return None
        if isinstance(req.evicted_state, _Spilled):
            try:
                self._read_parked_state(req)
            except Exception as e:  # noqa: BLE001 — shed loudly, keep pool
                with self._cond:
                    self._evicted.pop(req.seq, None)
                    self._release_queue_bytes(req)
                logger.warning(
                    "migration export failed reading the spilled blob "
                    "for one %s sequence (%r); shedding it", req.cls, e)
                self._fail([req], ServeError(
                    f"evicted {req.cls} sequence shed: spill blob "
                    f"failed to restore for export ({e!r})"), "export",
                    error=False)
                return None
        blob = self._pack_migration(req)
        with self._cond:
            # every local claim retires: ledger entry, parked bytes, queue
            # bytes (the heap entry is skipped once the future resolves)
            self._evicted.pop(req.seq, None)
            self._unpark(req)
            self._release_queue_bytes(req)
        resolve_future(req.future, exc=ServeError(
            f"sequence migrated off this host (reason={reason})"))
        self._bump("mig_out")
        self._observe({"event": "migrate_export", "cls": req.cls,
                       "pos": req.pos, "steps": req.steps,
                       "reason": reason, "bytes": len(blob)})
        return blob

    @staticmethod
    def _export_matches(req: SeqRequest, target) -> bool:
        if isinstance(target, Future):
            return req.future is target
        if isinstance(target, str):
            return req.tag == target
        return req.seq == int(target)

    def _pack_migration(self, req: SeqRequest) -> bytes:
        """One parked request → the migration container: the deadline as
        remaining seconds, the arrival ordinal as it is, the rows in the
        pool's own dtype."""
        state = req.evicted_state
        if req.pos > 0 and not isinstance(state, list):
            raise ServeError(
                f"cannot pack migration blob: sequence at pos "
                f"{req.pos} has no parked state")
        deadline_s = None
        if req.deadline < math.inf:
            deadline_s = max(0.0, req.deadline - time.monotonic())
        header = {
            "migrate_version": MIGRATE_VERSION,
            "model": self._model_fingerprint,
            "family": self.backend.family,
            "profile": self.backend.precision,
            "pool_dtype": self._layout[0][0][0],
            "layers": [list(h[1]) for h, _c in self._layout],
            "feat_dim": int(self.backend.feat_dim),
            "steps": int(req.steps),
            "pos": int(req.pos),
            "cls": req.cls,
            "priority": int(req.priority),
            "deadline_s": deadline_s,
            "arrival": int(req.arrival),
        }
        entries: dict[str, object] = {
            "migrate": serialization.json_entry(header), "x": req.x}
        if req.pos > 0:
            for i, (h, c) in enumerate(state):
                entries[f"{i}.h"] = h
                entries[f"{i}.c"] = c
        return serialization.dumps(entries)

    # -- the elastic pool -------------------------------------------------
    def request_resize(self, slots: int) -> None:
        """Resize the live pool at the next block boundary (the elastic
        policy drives the same path by load); clamped to [min_slots,
        max_slots]. Needs an elastic policy."""
        if not self._preempt.elastic:
            raise ServeError("request_resize needs serve.preempt.elastic")
        self._resize_request = max(self._min_slots,
                                   min(self.max_slots, int(slots)))
        with self._cond:
            self._cond.notify_all()

    def _maybe_resize(self) -> None:
        """The elastic tick: double under sustained load >= grow_load,
        halve under sustained load <= shrink_load (after
        ``resize_hysteresis`` boundaries), or honour request_resize."""
        p = self._preempt
        if not p.elastic:
            return
        if self._resize_request:
            target, self._resize_request = self._resize_request, 0
        else:
            load = (self._n_active + self.queue_depth) / self.pool_slots
            want = 0
            if load >= p.grow_load and self.pool_slots < self.max_slots:
                want = 1
            elif (load <= p.shrink_load
                    and self.pool_slots > self._min_slots):
                want = -1
            if want == 0:
                self._resize_streak = 0
                self._resize_want = 0
                return
            self._resize_streak = (self._resize_streak + 1
                                   if want == self._resize_want else 1)
            self._resize_want = want
            if self._resize_streak < p.resize_hysteresis:
                return
            self._resize_streak = 0
            target = (min(self.max_slots, self.pool_slots * 2) if want > 0
                      else max(self._min_slots, self.pool_slots // 2))
        if self._data_size > 1:
            target = round_up_multiple(target, self._data_size)
        target = max(self._min_slots, min(self.max_slots, target))
        if target != self.pool_slots:
            self._resize(target)

    def _resize(self, new: int) -> None:
        """Resize the live pool to ``new`` slots. A shrink is an
        eviction: occupied slots past ``new`` park in the ledger and
        restore into the smaller pool. A shrink the ledger cannot take
        is skipped, loudly."""
        old = self.pool_slots
        occupied_high = ([s for s in range(new, old)
                          if self._slot_req[s] is not None]
                         if new < old else [])
        if new < old and (len(self._evicted) + len(occupied_high)
                          > self._preempt.max_evicted):
            logger.warning(
                "pool shrink %d->%d skipped: eviction ledger cannot "
                "hold %d occupied high slots (%d/%d parked)", old, new,
                len(occupied_high), len(self._evicted),
                self._preempt.max_evicted)
            return
        if new < old and occupied_high and not self._ledger_room(
                self._per_slot_state_bytes() * len(occupied_high)):
            self._bump("budget_deferred")
            logger.warning(
                "pool shrink %d->%d skipped: serve.budget ledger "
                "cannot hold %d victims' bytes (ram %d/%s, disk %d/%s)",
                old, new, len(occupied_high), self._mem.bytes("ram"),
                self._mem.budget("ram"), self._mem.bytes("disk"),
                self._mem.budget("disk"))
            return
        try:
            fault_point("serve.resize", slots=old, target=new,
                        active=self._n_active)
        except Exception as e:  # noqa: BLE001 — lose only this resize
            logger.warning("resize fault (%d->%d slots aborted): %r",
                           old, new, e)
            self._observe({"event": "resize_error", "from": old,
                           "to": new, "error": repr(e)[:200]})
            return
        if new < old:
            for slot in occupied_high:
                # a failed eviction loses only that victim; the slot is
                # free either way
                self._evict_slot(slot, reason="shrink")
            self._states = [(h[:new].clone(), c[:new].clone())
                            for h, c in self._states]
            self._slot_req = self._slot_req[:new]
            self._slot_pos = self._slot_pos[:new]
            self._free = [s for s in self._free if s < new]
            self._pending_reset = {s for s in self._pending_reset
                                   if s < new}
        else:
            self._states = [(torch.cat([h, h.new_zeros((new - old,
                                                        *h.shape[1:]))]),
                             torch.cat([c, c.new_zeros((new - old,
                                                        *c.shape[1:]))]))
                            for h, c in self._states]
            self._slot_req.extend([None] * (new - old))
            self._slot_pos.extend([0] * (new - old))
            self._free.extend(range(old, new))
        self.pool_slots = new
        self._mem.set_bytes("pool", self._pool_state_bytes())
        self._bump("resizes")
        self._observe({"event": "resize", "from": old, "to": new})

    # -- the dispatch loop ------------------------------------------------
    def _run(self, warmup: bool) -> None:
        with torch.inference_mode():
            try:
                self._states = self._init_states()
                if warmup:
                    self._warmup()
            except BaseException as e:  # noqa: BLE001 — the constructor raises it
                self._init_error = e
                return
            finally:
                self._ready.set()
            self._started.wait()
            try:
                while self._admit_or_wait():
                    if self._n_active == 0:
                        # nothing to step: retire the in-flight tail and
                        # drain the staged readbacks (idleness flushes)
                        while not self._buffer.empty:
                            self._complete(self._buffer.pop())
                        self._flush_readback(force=True)
                        continue
                    self._dispatch_step()
                for item in self._buffer.drain():
                    self._complete(item)
                self._flush_readback(force=True)
                # filed exports must not wait out their timeout
                with self._cond:
                    pending, self._export_q = self._export_q, []
                for _target, _reason, fut in pending:
                    if fut.set_running_or_notify_cancel():
                        fut.set_result(None)
            except BaseException as e:  # noqa: BLE001 — no request hangs
                self._abort(e)

    def _dispatch_step(self) -> None:
        if self._paging.enabled:
            self._dispatch_step_paged()
            return
        t0 = time.monotonic()
        pool = self.pool_slots
        rows = self._block_rows
        active = self._n_active
        k = self._pick_block()
        tm = self.telemetry
        admitted = len(self._pending_reset)
        try:
            self._apply_restores()
            fault_point("serve.step", step=int(tm.steps.get()),
                        active=active, queued=self.queue_depth)
            x = np.zeros((rows, k, self.backend.feat_dim), np.float32)
            reset = np.zeros((rows, 1), bool)
            reset[pool:] = True  # idle lanes past the live pool
            new_slots = tuple(self._pending_reset)  # first-block spans
            for slot in new_slots:
                reset[slot] = True
            self._pending_reset.clear()
            takes = [0] * pool
            for slot, req in enumerate(self._slot_req):
                if req is None:
                    continue
                pos = self._slot_pos[slot]
                take = min(k, req.steps - pos)
                takes[slot] = take
                x[slot, :take] = req.x[pos:pos + take]
            states = self._states
            if rows > pool:
                states = [(torch.cat([h, h.new_zeros((rows - pool,
                                                      *h.shape[1:]))]),
                           torch.cat([c, c.new_zeros((rows - pool,
                                                      *c.shape[1:]))]))
                          for h, c in states]
            # the upload and the block are enqueued, not waited for:
            # block N+1's copy overlaps block N's compute
            if self.mesh is not None:
                fault_point("serve.shard", rows=self.max_slots,
                            mesh=self.mesh_desc)
            t_put = time.perf_counter()
            put = self._shards.put if self.mesh is not None else self._put
            x_dev, reset_dev = put(x), put(reset)
            put_ms = (time.perf_counter() - t_put) * 1e3
            t_h2d = time.monotonic()  # upload enqueued (span stamp)
            states, y_dev = self._block_call(states, x_dev, reset_dev)
            if rows > pool:
                states = [(h[:pool].clone(), c[:pool].clone())
                          for h, c in states]
            self._states = states
        except Exception as e:  # noqa: BLE001 — fail in-flight, keep serving
            self._fault(e)
            return
        t_disp = time.monotonic()
        # a span keeps its first block's put and dispatch stamps: only
        # this block's newly admitted slots stamp
        for slot in new_slots:
            req = self._slot_req[slot]
            if req is not None:
                tm.span_stage(req.span, "h2d_put", t_h2d)
                tm.span_stage(req.span, "dispatch", t_disp)
        finished: list[tuple[int, int, SeqRequest]] = []
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            self._slot_pos[slot] += takes[slot]
            if self._slot_pos[slot] >= req.steps:
                # the true last step's output sits at substep take - 1;
                # zero-filled tail substeps touched only this slot's own
                # state, which its next admission zeroes
                finished.append((slot, takes[slot] - 1, req))
                self._slot_req[slot] = None
                self._free.append(slot)
        self._count_step(active / pool, k)
        done = self._buffer.push((finished, active, admitted, k, t0,
                                  y_dev, pool, put_ms))
        if done is not None:
            self._complete(done)

    def _count_step(self, occupancy: float, k: int) -> None:
        self.telemetry.steps.inc()
        self.telemetry.occupancy_sum.inc(occupancy)
        self._block_counters[k].inc()

    def _dispatch_step_paged(self) -> None:
        """One block over the page store: the ``pool_slots`` most urgent
        live sequences (deadline order, least recently dispatched first
        among ties) get rows — demoting the coldest holders, promoting
        parked ones — their rows gather into a dense block, the same
        block program runs, and the stepped rows scatter back. Gather
        and scatter only move data, so replies are bit-equal to a dense
        pool's in any dtype."""
        t0 = time.monotonic()
        pool = self.pool_slots
        self._pg_dispatch += 1
        with self._cond:
            stale = [r for r in self._live.values() if r.future.done()]
        for req in stale:  # cancelled by the client: row and bytes retire
            self._drop_live(req)
        if self._n_active == 0:
            return
        k = self._pick_block()
        with self._cond:
            order = sorted(
                self._live.values(),
                key=lambda r: (r.priority, r.deadline, r.last_block,
                               r.arrival, r.seq))
        scheduled = self._schedule_rows(order[:pool])
        if not scheduled:
            return
        tm = self.telemetry
        admitted = sum(1 for r in scheduled if r.pos == 0)
        try:
            fault_point("serve.step", step=int(tm.steps.get()),
                        active=self._n_active, queued=self.queue_depth)
            x = np.zeros((pool, k, self.backend.feat_dim), np.float32)
            # idle lanes: reset (carry zeroed in the block), gather row 0,
            # and no scatter
            reset = np.ones((pool, 1), bool)
            gidx = np.zeros((pool,), np.int64)
            takes = [0] * pool
            for lane, req in enumerate(scheduled):
                gidx[lane] = req.row
                reset[lane] = req.pos == 0
                take = min(k, req.steps - req.pos)
                takes[lane] = take
                x[lane, :take] = req.x[req.pos:req.pos + take]
            n = len(scheduled)
            g = self._put(gidx)
            dense = [(h.index_select(0, g), c.index_select(0, g))
                     for h, c in self._states]
            x_dev, reset_dev = self._put(x), self._put(reset)
            t_h2d = time.monotonic()
            dense, y_dev = self._block_call(dense, x_dev, reset_dev)
            s = g[:n]
            self._states = [(h.index_copy(0, s, dh[:n]),
                             c.index_copy(0, s, dc[:n]))
                            for (h, c), (dh, dc) in zip(self._states,
                                                        dense)]
        except Exception as e:  # noqa: BLE001 — fail in-flight, keep serving
            self._fault(e)
            return
        t_disp = time.monotonic()
        for req in scheduled:
            if req.pos == 0:
                tm.span_stage(req.span, "h2d_put", t_h2d)
                tm.span_stage(req.span, "dispatch", t_disp)
        active = len(scheduled)
        finished: list[tuple[int, int, SeqRequest]] = []
        with self._cond:
            for lane, req in enumerate(scheduled):
                req.pos += takes[lane]
                req.last_block = self._pg_dispatch
                if req.pos >= req.steps:
                    finished.append((lane, takes[lane] - 1, req))
                    self._live.pop(req.seq, None)
                    self._free_row(req)
        self._count_step(active / pool, k)
        done = self._buffer.push((finished, active, admitted, k, t0, y_dev,
                                  pool, 0.0))
        if done is not None:
            self._complete(done)

    def _schedule_rows(self, chosen: list[SeqRequest]) -> list[SeqRequest]:
        """Give each sequence of this block a page-store row — a free one
        (lowest first), else the coldest unscheduled holder's — and
        promote a parked one's rows into it. A failed promotion sheds
        only that sequence. Returns the block's sequences in lane
        order."""
        keep = {r.seq for r in chosen}
        out: list[SeqRequest] = []
        for req in chosen:
            if req.row is None:
                if not self._row_free:
                    self._demote_coldest(keep)
                if not self._row_free:
                    continue  # more lanes than rows: waits a block
                req.row = self._alloc_row()
            if req.evicted_state is None:
                out.append(req)
                continue
            try:
                fault_point("serve.page", cls=req.cls, seq=req.seq,
                            row=req.row, pos=req.pos)
                if (self._budget.enabled
                        and isinstance(req.evicted_state, _Spilled)):
                    self._make_ledger_room(req.evicted_state.ram_bytes)
                payload = self._read_parked_state(req)
                self._check_restore_payload(payload)
                self._scatter_row(req.row, payload)
            except Exception as e:  # noqa: BLE001 — shed one, keep serving
                logger.warning(
                    "page promotion failed for one %s sequence (%r); "
                    "shedding it, the pool keeps serving", req.cls, e)
                self._drop_live(req)
                self._bump("page_shed")
                self._fail([req], ServeError(
                    f"paged {req.cls} sequence shed: promotion "
                    f"failed ({e!r})"), "promotion", error=False)
                continue
            if req.state_bytes:
                self._mem.sub("ram", req.state_bytes)
            req.evicted_state = None
            req.state_bytes = 0
            self._bump("page_promoted")
            out.append(req)
        return out

    def _demote_coldest(self, keep: set) -> None:
        """Demote the least recently dispatched row-holder outside this
        block: its rows park in the ledger's RAM tier (spilling colder
        ones under a budget) in the pool's own dtype, and its row frees.
        A failed gather loses only that sequence."""
        with self._cond:
            cands = [r for r in self._live.values()
                     if r.row is not None and r.seq not in keep]
        if not cands:
            return
        victim = min(cands, key=lambda r: (r.last_block, r.arrival,
                                           r.seq))
        try:
            if victim.pos > 0:
                self._park_host_state(victim,
                                      self._gather_rows(victim.row))
            # a holder at pos 0 has no carry yet: its row just frees
        except Exception as e:  # noqa: BLE001 — lose only the victim
            logger.warning(
                "page demotion failed for one %s sequence (%r); the "
                "victim fails, the pool keeps serving", victim.cls, e)
            self._drop_live(victim)
            self._fail([victim], e, "demotion", error=False)
            return
        self._free_row(victim)
        self._bump("page_demoted")

    def _complete(self, item) -> None:
        """Retire one in-flight block: gather its finishers' output rows
        on the device (no host transfer) into the staging buffer, then
        flush it if due."""
        finished, active, admitted, k, t0, y_dev, pool, put_ms = item
        tm = self.telemetry
        if finished:
            reqs = [req for _s, _b, req in finished]
            try:
                y_sel = self._gather(y_dev, [s for s, _b, _r in finished],
                                     [b for _s, b, _r in finished])
            except Exception as e:  # noqa: BLE001 — fail them, keep serving
                self._fail(reqs, e, "readback")
            else:
                now = time.monotonic()
                flush_at = now + self.readback_interval_s
                for req in reqs:
                    # the finishing block is enqueued and its rows
                    # gathered (host clock: no sync is added for it)
                    tm.span_stage(req.span, "compute", now)
                    # a finisher's own deadline bounds its staging wait
                    if req.deadline < flush_at:
                        flush_at = max(now, req.deadline)
                self._staged.append((reqs, flush_at, y_sel))
                self._staged_rows += len(reqs)
                self._mem.add("staged", y_sel.numel() * y_sel.element_size())
        now = time.monotonic()
        with self._lock:
            self._step_ms.append((now - t0) * 1e3)
        tm.batch_latency.observe(now - t0)
        tm.step_latency.observe(now - t0)
        rec = {"event": "step", "active": active, "admitted": admitted,
               "finished": len(finished), "queued": self.queue_depth,
               "block": k, "occupancy": round(active / pool, 4),
               "step_ms": round((now - t0) * 1e3, 3)}
        if tm.enabled and finished:
            rec["trace_ids"] = [req.span.trace_id
                                for _s, _b, req in finished
                                if req.span is not None]
        if self.mesh is not None:
            rec["mesh"] = self.mesh_desc
            rec["shard_put_ms"] = round(put_ms, 3)
        self._observe(rec)
        self._flush_readback()

    def _flush_readback(self, force: bool = False) -> None:
        """Drain the staging buffer in ONE device→host read and resolve
        every staged finisher: when the earliest staged deadline is due,
        a pool's worth of rows waits, or ``force`` (idle, close, fault)."""
        if not self._staged:
            return
        if (not force and self._staged_rows < self.pool_slots
                and time.monotonic() < min(dl for _r, dl, _y
                                           in self._staged)):
            return
        entries, self._staged = self._staged, []
        self._staged_rows = 0
        self._mem.sub("staged", sum(y.numel() * y.element_size()
                                    for _r, _dl, y in entries))
        reqs = [req for e_reqs, _dl, _y in entries for req in e_reqs]
        tm = self.telemetry
        try:
            rows = [y for _r, _dl, y in entries]
            out = (rows[0] if len(rows) == 1 else torch.cat(rows)).cpu(
            ).numpy().astype(self.backend.out_dtype)
        except Exception as e:  # noqa: BLE001 — fail staged, keep serving
            self._fail(reqs, e, "readback")
            self._observe({"event": "readback_error",
                           "sequences": len(reqs), "error": repr(e)[:200]})
            return
        now = time.monotonic()
        # accounting BEFORE futures resolve: a returned predict() sees
        # itself in stats()
        for req in reqs:
            tm.span_stage(req.span, "readback", now)
            tm.span_end(req.span)
        with self._lock:
            for req in reqs:
                self._cls_stats.observe(req.cls, now - req.t_submit)
        tm.observe_batch([(r.cls, now - r.t_submit, r.deadline, r.t_submit)
                          for r in reqs], now)
        tm.completed.inc(len(reqs))
        tm.rows.inc(sum(r.steps for r in reqs))
        tm.readbacks.inc()
        for i, req in enumerate(reqs):
            resolve_future(req.future, out[i].copy())
        drift = None
        if self.backend.precision != "f32":
            # the oracle runs after the futures resolve: no client waits
            if self._drift_tick % DRIFT_EVERY == 0:
                drift = self._drift.sample(
                    out[0], lambda: self.backend.predict(reqs[0].x),
                    self._lock)
            self._drift_tick += 1
        rec = {"event": "readback", "sequences": len(reqs),
               "steps_coalesced": len(entries)}
        if tm.enabled:
            rec["trace_ids"] = [r.span.trace_id for r in reqs
                                if r.span is not None]
        if self.backend.precision != "f32":
            rec["precision"] = self.backend.precision
            if drift is not None:
                rec["drift"] = round(drift, 8)
        self._observe(rec)

    def _fail(self, reqs: list[SeqRequest], exc: BaseException,
              what: str, error: bool = True) -> None:
        """Fail ``reqs`` with ``exc``. ``error`` counts (and logs) a
        failed program; a shed or a lost victim, already warned about,
        counts as failed only."""
        if error:
            logger.warning("%s failed for %d sequence(s): %r", what,
                           len(reqs), exc)
            self.telemetry.errors.inc()
        self.telemetry.failed.inc(len(reqs))
        for req in reqs:
            resolve_future(req.future, exc=exc)

    def _fault(self, exc: BaseException) -> None:
        """A failed dispatch fails only the sequences holding slots (or
        device rows): blocks already in flight retire first (their
        finishers' outputs are valid), then every holder gets the
        exception and the pool is rebuilt empty; queued and parked
        sequences admit and complete after it."""
        for item in self._buffer.drain():
            self._complete(item)
        self._flush_readback(force=True)
        if self._paging.enabled:
            self._fault_paged(exc)
            return
        holders = [req for req in self._slot_req if req is not None]
        self._slot_req = [None] * self.pool_slots
        self._slot_pos = [0] * self.pool_slots
        self._free = list(range(self.pool_slots))
        self._pending_reset.clear()
        # restores pending for the holders die with them; ledger entries
        # survive (queued, not in flight) and restore into the new pool
        for req in self._pending_restore.values():
            self._unpark(req)
        self._pending_restore.clear()
        self._restore_staged.clear()
        for _item in self._restore_buf.drain():
            pass
        self._fail(holders, exc, "step block")
        self._observe({"event": "step_error", "failed": len(holders),
                       "error": repr(exc)[:200]})
        self._states = self._init_states()

    def _fault_paged(self, exc: BaseException) -> None:
        """The paged fault: live sequences with a device row fail; those
        whose carry is wholly parked on the host go back to the ledger
        and the heap. The page store is rebuilt zeroed."""
        requeue: list[SeqRequest] = []
        failed: list[SeqRequest] = []
        with self._cond:
            live = list(self._live.values())
            self._live.clear()
        for req in live:
            if req.evicted_state is not None and req.row is None:
                requeue.append(req)
                continue
            req.row = None
            with self._cond:
                self._unpark(req)
            failed.append(req)
        with self._cond:
            for req in requeue:
                self._requeue_locked(req)
        self._row_free = list(range(self._page_rows))  # sorted: a heap
        self._fail(failed, exc, "step block")
        self._states = self._init_states()

    def _abort(self, exc: BaseException) -> None:
        """The dispatcher cannot go on (a fault escaped ``_fault`` itself,
        e.g. a sticky device error that also fails the pool's rebuild):
        close the engine, so ``submit`` raises, and fail every request it
        holds — queued, parked, holding a slot or row, in flight or
        staged — with ``exc``, so no client waits on a future nothing
        will resolve."""
        logger.error("step dispatcher stopped: %r", exc)
        with self._cond:
            self._closed = True
            self._aborted = exc
            reqs = [entry[-1] for entry in self._q]
            self._q = []
            reqs += [r for r in self._live.values()]
            self._live.clear()
            for req in reqs:
                self._unpark(req)
            self._evicted.clear()
            exports, self._export_q = self._export_q, []
        reqs += [req for req in self._slot_req if req is not None]
        reqs += [req for item in self._buffer.drain()
                 for _s, _b, req in item[0]]
        reqs += [req for e_reqs, _dl, _y in self._staged for req in e_reqs]
        self._staged = []
        self._staged_rows = 0
        self._slot_req = [None] * self.pool_slots
        self._free = list(range(self.pool_slots))
        self._pending_restore.clear()
        self._fail(list({id(r): r for r in reqs}.values()), exc,
                   "dispatcher")
        for _target, _reason, fut in exports:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(exc)

    # -- introspection / lifecycle --------------------------------------
    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._q)

    def _profile_row(self) -> dict:
        """This scheduler's row of ``stats()["profiles"]``."""
        tm = self.telemetry
        with self._lock:
            drift = self._drift.snapshot()
        return {"requests": int(tm.requests.get()),
                "completed": int(tm.completed.get()),
                "active": self._n_active, "drift": drift}

    def stats(self) -> dict:
        """The JAX step scheduler's stats() keys, ``preempt``, ``budget``
        and ``paging`` included, the counters read from the telemetry
        registry. The JAX package's ``slo`` and ``trace`` sections are the
        telemetry's ``attainment()`` and ``trace_snapshot()`` (and
        ``/metrics``, ``/trace``) here; its ``aot`` waits for the AOT
        store. Reading them sheds an expired parked sequence too."""
        if self._evicted:
            self._sweep_expired()
        queued = self.queue_depth
        paging = self._paging_stats()
        tm = self.telemetry
        c = {key: self._count(key) for key in self._counters}
        n = int(tm.steps.get())
        with self._lock:
            lat = sorted(self._step_ms)
            cls_snap = self._cls_stats.snapshot()
            prec_snap = self._drift.snapshot()
        out = {
            "scheduler": "continuous",
            "slots": self.max_slots,
            "step_block": self.step_block,
            "step_blocks": list(self.step_blocks),
            "block_hist": {str(k): int(ctr.get()) for k, ctr
                           in sorted(self._block_counters.items())
                           if ctr.get()},
            "active": self._n_active,
            "queued": queued,
            "steps": n,
            "sequences": int(tm.completed.get()),
            "failed": int(tm.failed.get()),
            "errors": int(tm.errors.get()),
            "readbacks": int(tm.readbacks.get()),
            "classes": cls_snap,
            "precision": prec_snap,
            "preempt": {
                "enabled": self._preempt.enabled,
                "elastic": self._preempt.elastic,
                "pool_slots": self.pool_slots,
                "preempted": c["preempted"],
                "restored": c["restored"],
                "shed": c["preempt_shed"],
                "evicted_depth": len(self._evicted),
                "resizes": c["resizes"],
            },
            "mean_occupancy": (round(tm.occupancy_sum.get() / n, 4) if n
                               else 0.0),
            "uptime_s": round(time.monotonic() - self._t_start, 3),
        }
        defaults = ("pool", "params", "staged", "ram", "disk", "queue")
        if self._paging.enabled:
            defaults += ("pages",)
        out["budget"] = {"enabled": self._budget.enabled,
                         **self._mem.snapshot(defaults=defaults),
                         "spills": c["spills"],
                         "spill_restored": c["spill_restored"],
                         "deferred": c["budget_deferred"],
                         "shed": c["budget_shed"]}
        if paging["enabled"]:
            paging.update(demoted=c["page_demoted"],
                          promoted=c["page_promoted"],
                          shed=c["page_shed"])
        out["paging"] = paging
        out["p50_step_ms"] = round(percentile(lat, 0.50), 3)
        out["p99_step_ms"] = round(percentile(lat, 0.99), 3)
        if self._exec is not None:
            out["aot"] = {"enabled": True, **self._exec.aot_counts()}
        if self.mesh is not None:
            out["mesh"] = self.mesh_desc
        if self._children:
            out["profiles"] = _profiles(self)
        return out

    def _paging_stats(self) -> dict:
        """``stats()["paging"]``'s geometry and occupancy (the counters
        are added by stats()); ``{"enabled": False}`` for a dense pool."""
        out: dict = {"enabled": self._paging.enabled}
        if not self._paging.enabled:
            return out
        ps = self._paging.page_slots
        with self._cond:
            free = set(self._row_free)
            live = len(self._live)
        free_pages = sum(
            1 for p in range(self._pages)
            if all(r in free for r in range(p * ps, (p + 1) * ps)))
        out.update({"pages": self._pages, "page_slots": ps,
                    "rows": self._page_rows, "free_rows": len(free),
                    "free_pages": free_pages, "live": live,
                    "max_live": self._max_live,
                    "peak_live": self._pg_peak_live})
        return out

    def close(self) -> None:
        """Stop accepting requests, shed expired parked sequences, drain
        queued and in-flight work, join the dispatcher (children
        first)."""
        for child in self._children.values():
            child.close()
        if self._evicted:
            self._sweep_expired()
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self.start()  # a never-started scheduler still drains and exits
        self._thread.join()
        self.telemetry.close()

    def __enter__(self) -> "StepScheduler":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


class WholeSequenceScheduler(MetricsSink):
    """Request-granular sequence batching (``serve.scheduler="batch"``).

    One micro-batch is one ``padded_fn`` call at a (row bucket, time
    bucket) shape; rows past the batch and steps past each row's length
    are zero padding, and each row's output is read at its true last
    step. Cuts order by (class priority, deadline, arrival); ``profiles``
    adds a child scheduler per extra profile. The telemetry keywords are
    the step scheduler's."""

    kind = "sequence"  # transport: a request is one ordered sequence

    def __init__(self, backend: RecurrentBackend, *,
                 row_buckets: Sequence[int] = (8, 32),
                 time_buckets: Sequence[int] = (8, 16, 32, 64),
                 max_wait_ms: float = 2.0, inflight: int = 2,
                 warmup: bool = False,
                 classes: Sequence[str] = ("interactive", "bulk"),
                 profiles: Sequence[str] = (),
                 metrics_jsonl: str | None = None, obs_enabled: bool = True,
                 trace_capacity: int = 512, slo_ms: Sequence[float] = (),
                 capture_path: str | None = None, aot=None,
                 max_executables: int = 16, exec_cache=None):
        self.backend = backend
        extra = _extra_profiles(backend, profiles)
        # the AOT program store (serve.aot): the (rows, steps) programs
        # through one executable cache the profile children share
        self._exec = exec_cache
        if aot is not None and exec_cache is None:
            self._exec = _bind_family(aot, "padded", backend,
                                      max_executables)
        self._aot_params = backend.serving_params()
        self._class_priority = resolve_classes(classes)
        self.classes = tuple(self._class_priority)
        self._cls_stats = ClassStats(self.classes)
        self._drift = DriftStats(backend.precision, backend.envelope)
        self._drift_tick = 0
        self.row_buckets = validate_buckets(row_buckets)
        self.time_buckets = validate_buckets(time_buckets)
        self.max_wait_s = max_wait_ms / 1000.0
        if inflight < 1:
            raise ServeError(f"inflight must be >= 1, got {inflight}")
        self._batcher = MicroBatcher(self.row_buckets[-1], self.max_wait_s)
        self._buffer = DoubleBuffer(depth=inflight)
        self._lock = threading.Lock()
        self._latencies: collections.deque = collections.deque(
            maxlen=LATENCY_WINDOW)
        self.telemetry = ServeTelemetry(
            kind="sequence", family=backend.family,
            profile=backend.precision, classes=self.classes,
            enabled=obs_enabled, trace_capacity=trace_capacity,
            slo_ms=slo_ms, metrics_jsonl=metrics_jsonl,
            capture_path=capture_path,
            queue_depth_fn=lambda: self._batcher.queue_depth,
            aot_counts_fn=(self._exec.aot_counts if self._exec is not None
                           else None))
        self.telemetry.register_drift(self._drift)
        # row/time fill-ratio sums (this scheduler's two fill figures)
        fills = self.telemetry.registry.counter(
            "serve_seq_fill_ratio_total",
            "Sum of per-batch fill ratios (axis=row|time)",
            ("family", "profile", "axis"))
        lab = {"family": backend.family, "profile": backend.precision}
        self._row_fill = fills.labels(**lab, axis="row")
        self._time_fill = fills.labels(**lab, axis="time")
        self._t_start = time.monotonic()
        self._closed = False
        if warmup:
            self.warmup()
        self.telemetry.stats_fn = self.stats
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-seq-dispatch")
        self._thread.start()
        self._children: dict[str, WholeSequenceScheduler] = {
            p: WholeSequenceScheduler(
                backend.with_profile(p), row_buckets=row_buckets,
                time_buckets=time_buckets, max_wait_ms=max_wait_ms,
                inflight=inflight, warmup=warmup, classes=classes,
                obs_enabled=obs_enabled, trace_capacity=trace_capacity,
                slo_ms=slo_ms, exec_cache=self._exec)
            for p in extra}
        for child in self._children.values():
            self.telemetry.extra_registries += (child.telemetry.registry,)

    @property
    def children(self) -> dict:
        """The child schedulers, by the extra profile each serves."""
        return dict(self._children)

    def warmup(self) -> None:
        """Run every (row bucket, time bucket) program once, so the first
        request pays for no kernel build, allocator growth or library
        initialisation; with the AOT store the warm manifest preloads
        first."""
        if self._exec is not None:
            self._exec.preload_aot()
        for rb in self.row_buckets:
            for tb in self.time_buckets:
                x = np.zeros((rb, tb, self.backend.feat_dim), np.float32)
                self._padded(x, np.zeros((rb,), np.int64)).cpu()

    def _padded(self, x: np.ndarray, last: np.ndarray) -> torch.Tensor:
        """One padded batch through the backend's program: eager, or the
        AOT store's compiled program of its ``((rows, steps, F),
        profile)``."""
        b = self.backend
        if self._exec is None:
            return b.padded_fn(x, last)
        x_dev = torch.as_tensor(x, device=b.device)
        last_dev = torch.as_tensor(last, dtype=torch.long, device=b.device)
        exe = self._exec.get_or_compile(
            (tuple(x.shape), b.precision), b.padded_pure,
            lambda: (self._aot_params, x_dev, last_dev))
        with torch.inference_mode():
            return exe(self._aot_params, x_dev, last_dev)

    @property
    def slo_desc(self) -> dict:
        """/healthz: the admitted classes."""
        return {"classes": list(self.classes)}

    @property
    def load_desc(self) -> dict:
        """/healthz: constant-time load figures."""
        out = {"queued": self._batcher.queue_depth}
        if self._exec is not None:
            out["aot_hits"] = int(self._exec.aot_counts()["hits"])
        return out

    @property
    def precision_desc(self) -> dict:
        """/healthz and the banner: profile, envelope, params' size, and
        the served profiles where children serve more."""
        desc = self._drift.desc(param_bytes(self.backend.serving_params()))
        if self._children:
            desc["profiles"] = [self.backend.precision, *self._children]
        return desc

    # -- request side ---------------------------------------------------
    def submit(self, x: np.ndarray, max_wait_s: float | None = None,
               cls: str | None = None, tag: str | None = None,
               profile: str | None = None) -> Future:
        """Enqueue one sequence ``(T, F)``; resolves to ``(out_dim,)``.
        ``max_wait_s`` shortens this request's flush deadline (clamped to
        the configured ceiling); ``cls`` names its SLO class; ``tag`` is
        accepted as the step scheduler takes it and ignored (this
        scheduler has nothing to export); ``profile`` routes it to that
        profile's child scheduler."""
        child = _route(self, profile)
        if child is not None:
            return child.submit(x, max_wait_s=max_wait_s, cls=cls)
        x = np.asarray(x, np.float32)
        cls, prio = resolve_request_class(self._class_priority, cls)
        if x.ndim != 2 or x.shape[1] != self.backend.feat_dim:
            raise ServeError(
                f"sequence must be (steps, {self.backend.feat_dim}), "
                f"got {x.shape}")
        if not 1 <= len(x) <= self.time_buckets[-1]:
            raise ServeError(
                f"sequence of {len(x)} steps outside [1, "
                f"{self.time_buckets[-1]}] (largest time bucket)")
        fault_point("serve.request", rows=len(x))
        tm = self.telemetry
        # (1, T, F): one request = one row
        req = Request(x=x[None], priority=prio, cls=cls,
                      span=tm.trace_id(cls))
        if max_wait_s is not None:
            # the flush deadline is clamped to the coalescing ceiling;
            # the SLO deadline is the client's raw ask
            req.deadline = req.t_submit + max(
                0.0, min(float(max_wait_s), self.max_wait_s))
            req.slo_deadline = req.t_submit + max(0.0, float(max_wait_s))
        tm.requests.inc()
        try:
            self._batcher.submit(req)
        except Exception:
            tm.requests.inc(-1)  # rejected, never admitted
            raise
        # captured after admission: a rejected submit is not workload
        tm.capture_request(cls, steps=len(x), deadline_s=max_wait_s)
        return req.future

    def predict(self, x: np.ndarray, max_wait_s: float | None = None,
                cls: str | None = None, tag: str | None = None,
                profile: str | None = None) -> np.ndarray:
        return self.submit(x, max_wait_s=max_wait_s, cls=cls, tag=tag,
                           profile=profile).result()

    # -- dispatcher thread ----------------------------------------------
    def _run(self) -> None:
        while True:
            batch = self._batcher.next_batch(
                timeout=None if self._buffer.empty else 0.0)
            if batch is None:
                break
            if batch:
                self._dispatch(batch)
            elif not self._buffer.empty:
                self._complete(self._buffer.pop())
        for item in self._buffer.drain():
            self._complete(item)

    def _dispatch(self, batch: list[Request]) -> None:
        t0 = time.monotonic()
        lens = [r.x.shape[1] for r in batch]
        try:
            fault_point("serve.dispatch", sequences=len(batch))
            tb = pick_bucket(max(lens), self.time_buckets)
            rb = pick_bucket(len(batch), self.row_buckets)
            x = np.zeros((rb, tb, self.backend.feat_dim), np.float32)
            last = np.zeros((rb,), np.int64)
            for i, req in enumerate(batch):
                x[i, :lens[i]] = req.x[0]
                last[i] = lens[i] - 1
            y_dev = self._padded(x, last)
        except Exception as e:  # noqa: BLE001 — fail the batch, keep serving
            self._fail(batch, e)
            return
        # the program takes the host batch: put and dispatch share one
        # enqueue stamp
        t_disp = time.monotonic()
        done = self._buffer.push((batch, rb, tb, lens, t0, t_disp, y_dev))
        if done is not None:
            self._complete(done)

    def _fail(self, batch: list[Request], exc: BaseException) -> None:
        logger.warning("sequence micro-batch of %d failed: %r",
                       len(batch), exc)
        self.telemetry.errors.inc()
        self.telemetry.failed.inc(len(batch))
        for req in batch:
            resolve_future(req.future, exc=exc)
        self._observe({"event": "batch_error", "sequences": len(batch),
                       "error": repr(exc)[:200]})

    def _complete(self, item) -> None:
        batch, rb, tb, lens, t0, t_disp, y_dev = item
        tm = self.telemetry
        t_fin = time.monotonic()
        try:
            y = y_dev.cpu().numpy().astype(self.backend.out_dtype)
        except Exception as e:  # noqa: BLE001 — a device fault fails the batch
            self._fail(batch, e)
            return
        now = time.monotonic()
        # accounting BEFORE futures resolve: a returned predict() sees
        # itself in stats(); spans and attainment are bulk calls
        waits = [now - r.t_submit for r in batch]
        tm.record_batch(batch, (("h2d_put", t_disp), ("dispatch", t_disp),
                                ("compute", t_fin), ("readback", now)), now)
        tm.observe_batch([(r.cls, w, r.slo_deadline, r.t_submit)
                          for r, w in zip(batch, waits)], now)
        with self._lock:
            self._latencies.extend(waits)
            for r, w in zip(batch, waits):
                self._cls_stats.observe(r.cls, w)
        tm.batches.inc()
        tm.completed.inc(len(batch))
        tm.rows.inc(sum(lens))
        tm.batch_latency.observe(now - t0)
        self._row_fill.inc(len(batch) / rb)
        self._time_fill.inc(sum(lens) / (len(batch) * tb))
        for i, req in enumerate(batch):
            resolve_future(req.future, y[i].copy())
        drift = None
        if self.backend.precision != "f32":
            # the oracle runs after the futures resolve: no client waits
            if self._drift_tick % DRIFT_EVERY == 0:
                drift = self._drift.sample(
                    y[0], lambda: self.backend.predict(batch[0].x[0]),
                    self._lock)
            self._drift_tick += 1
        rec = {
            "event": "batch", "sequences": len(batch), "rows_bucket": rb,
            "time_bucket": tb, "row_fill": round(len(batch) / rb, 4),
            "time_fill": round(sum(lens) / (len(batch) * tb), 4),
            "dispatch_to_done_ms": round((now - t0) * 1e3, 3)}
        if tm.enabled:
            rec["trace_ids"] = [r.span for r in batch if r.span is not None]
        if self.backend.precision != "f32":
            rec["precision"] = self.backend.precision
            if drift is not None:
                rec["drift"] = round(drift, 8)
        self._observe(rec)

    # -- introspection / lifecycle --------------------------------------
    def _profile_row(self) -> dict:
        """This scheduler's row of ``stats()["profiles"]``."""
        with self._lock:
            drift = self._drift.snapshot()
        return {"requests": int(self.telemetry.requests.get()),
                "completed": int(self.telemetry.completed.get()),
                "drift": drift}

    def stats(self) -> dict:
        """The JAX batch scheduler's stats() keys less ``slo`` and
        ``trace`` (the telemetry's ``attainment()`` and
        ``trace_snapshot()``); the counters are read from the telemetry
        registry."""
        tm = self.telemetry
        with self._lock:
            lat = sorted(self._latencies)
            cls_snap = self._cls_stats.snapshot()
            prec_snap = self._drift.snapshot()
        n = int(tm.batches.get())
        out = {
            "scheduler": "batch",
            "batches": n,
            "sequences": int(tm.completed.get()),
            "errors": int(tm.errors.get()),
            "queued": self._batcher.queue_depth,
            "mean_row_fill": (round(self._row_fill.get() / n, 4) if n
                              else 0.0),
            "mean_time_fill": (round(self._time_fill.get() / n, 4) if n
                               else 0.0),
            "classes": cls_snap,
            "precision": prec_snap,
            "uptime_s": round(time.monotonic() - self._t_start, 3),
        }
        out["p50_ms"] = round(percentile(lat, 0.50) * 1e3, 3)
        out["p99_ms"] = round(percentile(lat, 0.99) * 1e3, 3)
        if self._exec is not None:
            out["aot"] = {"enabled": True, **self._exec.aot_counts()}
        if self._children:
            out["profiles"] = _profiles(self)
        return out

    def close(self) -> None:
        for child in self._children.values():
            child.close()
        if self._closed:
            return
        self._closed = True
        self._batcher.close()
        self._thread.join()
        self.telemetry.close()

    def __enter__(self) -> "WholeSequenceScheduler":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


def _bind_family(aot, program: str, backend: RecurrentBackend,
                 maxsize: int) -> ExecutableCache:
    """An executable cache over one sequence family of the AOT store
    (``padded`` or ``ladder``): identity the f32 params' structure; the
    profile rides in each program's key."""
    cache = ExecutableCache(maxsize)
    cache.bind_aot(aot.space(program=program, family=backend.family,
                             backend_name=backend.name,
                             params=backend.model.state_dict(),
                             device=backend.device))
    return cache


def make_sequence_engine(backend: RecurrentBackend, cfg, aot=None,
                         mesh=None):
    """``cfg.serve`` → the configured sequence scheduler ("batch" |
    "continuous"), the step scheduler with ``serve.preempt``,
    ``serve.budget`` and ``serve.paging``; the batch scheduler warns that
    it has no slots for the first two. ``aot`` is an open AOT store
    (serve/aotstore.py ``open_store``) or None; ``mesh``
    (serve/session.build_serving_mesh) shards the step scheduler's slot
    pool, and the whole-sequence scheduler logs and ignores it."""
    serve = cfg.serve
    obs = obs_kwargs(serve)
    if aot is not None:
        obs.update(aot=aot, max_executables=serve.max_executables)
    if serve.scheduler == "continuous":
        return StepScheduler(
            backend, max_slots=serve.max_slots, step_block=serve.step_block,
            step_blocks=serve.step_blocks or None, classes=serve.classes,
            readback_interval_ms=serve.readback_interval_ms,
            inflight=serve.inflight, warmup=serve.warmup,
            profiles=serve.profiles,
            preempt=PreemptPolicy.from_config(serve.preempt),
            budget=BudgetPolicy.from_config(serve.budget),
            paging=PagingPolicy.from_config(serve.paging), mesh=mesh,
            **obs)
    if serve.scheduler == "batch":
        if mesh is not None:
            logger.warning("serve.scheduler=batch is single-device; "
                           "serve.mesh ignored (use scheduler=continuous "
                           "for the sharded slot pool)")
        if serve.preempt.enabled or serve.preempt.elastic:
            logger.warning("serve.preempt needs the slot pool; the "
                           "batch scheduler has no slots to preempt — "
                           "use serve.scheduler=continuous")
        if serve.budget.enabled:
            logger.warning("serve.budget governs the continuous "
                           "scheduler's slot pool and eviction ledger; "
                           "the batch scheduler ignores it — use "
                           "serve.scheduler=continuous")
        return WholeSequenceScheduler(
            backend, row_buckets=serve.buckets,
            time_buckets=serve.seq_buckets, max_wait_ms=serve.max_wait_ms,
            inflight=serve.inflight, warmup=serve.warmup,
            classes=serve.classes, profiles=serve.profiles, **obs)
    raise ServeError(f"serve.scheduler must be batch|continuous, "
                     f"got {serve.scheduler!r}")


def load_recurrent_backend(cfg, checkpoint: str, num_features: int = 0,
                           device=None) -> RecurrentBackend:
    """A :class:`RecurrentBackend` from an LSTM checkpoint directory of
    either package, on ``device`` (the card when None). The profile and
    the extra profiles' names are validated before the restore
    (ConfigError)."""
    from euromillioner_tpu_torch.models.registry import restore_for_inference

    profile = resolve_serve_precision(cfg.serve.precision)
    for p in cfg.serve.profiles:
        resolve_serve_precision(p)
    if not checkpoint:
        raise ServeError("serve --model-type lstm needs --checkpoint")
    cfg.model.name = "lstm"
    model, compute_dtype, in_shape, _ck = restore_for_inference(
        cfg, checkpoint, num_features, device)
    return RecurrentBackend(model, feat_dim=in_shape[-1],
                            compute_dtype=compute_dtype, precision=profile,
                            act_quant=cfg.serve.act_quant,
                            fused_unroll=cfg.serve.fused_unroll)

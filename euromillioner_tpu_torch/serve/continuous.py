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

Not ported yet (ROADMAP queue 1): preemption and spill, paging, elastic
resize, live migration, budget enforcement, the serving mesh, the AOT
store, telemetry and traces, and fault points; where the JAX package's
``serve.quant`` fault point falls back to f32 when a cast or quantization
fails, this port raises.
"""

from __future__ import annotations

import collections
import copy
import heapq
import math
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from euromillioner_tpu_torch.core.device import resolve_device, upload
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
from euromillioner_tpu_torch.serve.engine import (DRIFT_EVERY, ClassStats,
                                                  DriftStats,
                                                  resolve_classes,
                                                  resolve_request_class)
from euromillioner_tpu_torch.utils.errors import ConfigError, ServeError
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
    ``serve_params`` (the bf16 cast, or the int8 values and scales); both
    programs run a private skeleton of the model (its own params on the
    meta device) on them."""

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
        fused = self.precision in ("fused", "int8w")
        self.serve_dtype = {"f32": self.compute_dtype,
                            "bf16": torch.bfloat16}.get(self.precision,
                                                        torch.float32)
        # cast / quantize once, here; a failure raises
        self.serve_params = None
        if self.precision == "bf16":
            self.serve_params = cast_floats(model.state_dict(),
                                            torch.bfloat16)
        elif self.precision == "int8w":
            # min_size=16, as the JAX package: small models quantize too
            self.serve_params = quantize_int8w(model.state_dict(),
                                               min_size=16)
        if fused and self.device.type == "cuda":
            # build here, on the constructing thread — never lazily on
            # the scheduler's dispatcher thread
            from euromillioner_tpu_torch.ops.fused_lstm import FUSED_LSTM_FWD

            FUSED_LSTM_FWD.build()
        # the bf16 and int8w tiers run a private skeleton of the model
        # (its params on the meta device) on serve_params
        base = (model if self.serve_params is None
                else copy.deepcopy(model).to("meta"))
        padded_program = _PaddedProgram(base, fused)
        block_program = _BlockProgram(base)
        lock = threading.Lock()  # functional_call swaps the skeleton's params
        quantized = self.precision == "int8w"
        act_q = self._act_quant and quantized
        sdt = self.serve_dtype
        dev = self.device

        def run(program, *args):
            if self.serve_params is None:
                return program(*args)
            params = self.serve_params
            if quantized:  # int8 stays resident, dequantized at each call
                params = dequantize_int8w(params, torch.float32)
            with lock:
                return torch.func.functional_call(
                    program, {f"model.{k}": v for k, v in params.items()},
                    args)

        def padded(x, last_idx):
            with torch.inference_mode():
                h = torch.as_tensor(x, device=dev).to(sdt)
                if act_q:
                    h = fake_quant_int8(h)
                return run(padded_program, h, last_idx).to(torch.float32)

        def block(states, x_block, reset):
            with torch.inference_mode():
                x = x_block.to(sdt)
                if act_q:
                    x = fake_quant_int8(x)
                zero = torch.zeros((), dtype=sdt, device=x.device)
                carry = [(torch.where(reset, zero, h),
                          torch.where(reset, zero, c)) for h, c in states]
                carry, y = run(block_program, carry, x)
                return carry, y.to(torch.float32)

        self.padded_fn = padded
        self.block_fn = block

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


@dataclass
class SeqRequest:
    """One queued sequence: ``x`` is (T, F) float32. Admission orders by
    (``priority``, ``deadline``, arrival ``seq``); ``deadline`` (absolute
    monotonic, ``inf`` = none) from ``max_wait_s`` also bounds how long
    the finished output may wait in the readback staging buffer."""

    x: np.ndarray
    cls: str = "interactive"
    priority: int = 0
    deadline: float = math.inf
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.monotonic)
    seq: int = 0

    @property
    def steps(self) -> int:
        return len(self.x)


class StepScheduler:
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
    package's bit rule for its programs."""

    kind = "sequence"  # transport: a request is one ordered sequence

    def __init__(self, backend: RecurrentBackend, *, max_slots: int = 32,
                 step_block: int = 2,
                 step_blocks: Sequence[int] | None = None,
                 inflight: int = 2, warmup: bool = True, start: bool = True,
                 classes: Sequence[str] = ("interactive", "bulk"),
                 readback_interval_ms: float = 0.0, hysteresis: int = 3,
                 profiles: Sequence[str] = ()):
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
        self.max_slots = max_slots
        self.step_blocks = ladder
        self.hysteresis = hysteresis
        self.readback_interval_s = readback_interval_ms / 1e3
        self._block_idx = 0      # current rung (dispatcher-only)
        self._block_want = 0     # rung the previous dispatch wanted
        self._block_streak = 0   # consecutive dispatches wanting it
        self._buffer = DoubleBuffer(depth=inflight)
        self._cond = threading.Condition()
        # admission heap: (priority, deadline, arrival, request)
        self._q: list[tuple[int, float, int, SeqRequest]] = []
        self._n_submitted = 0
        self._closed = False
        self._aborted: BaseException | None = None
        # slot bookkeeping, dispatcher-thread-only
        self._states = None
        self._slot_req: list[SeqRequest | None] = [None] * max_slots
        self._slot_pos = [0] * max_slots
        self._free = list(range(max_slots))
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
        self._requests = self._completed = self._failed = 0
        self._errors = self._readbacks = self._steps = 0
        self._occupancy = 0.0
        self._block_hist = {k: 0 for k in ladder}
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
        if start:
            self._started.set()
        self._children: dict[str, StepScheduler] = {}
        for p in extra:
            self._children[p] = StepScheduler(
                backend.with_profile(p), max_slots=max_slots,
                step_block=step_block, step_blocks=step_blocks,
                inflight=inflight, warmup=warmup, start=start,
                classes=classes, readback_interval_ms=readback_interval_ms,
                hysteresis=hysteresis)

    @property
    def children(self) -> dict:
        """The child schedulers, by the extra profile each serves."""
        return dict(self._children)

    @property
    def step_block(self) -> int:
        """The block size in effect (the current ladder rung)."""
        return self.step_blocks[self._block_idx]

    def start(self) -> None:
        """Release the dispatcher (and the children's); idempotent."""
        self._started.set()
        for child in self._children.values():
            child.start()

    def _warmup(self) -> None:
        """Run each rung's block program once on a zero pool, then the
        finisher gather and one read, so the first request pays for no
        library initialisation or allocator growth."""
        y = None
        for k in self.step_blocks:
            _, y = self.backend.block_fn(
                self._states,
                self._put(np.zeros((self.max_slots, k,
                                    self.backend.feat_dim), np.float32)),
                self._put(np.ones((self.max_slots, 1), bool)))
        idx = self._put(np.zeros((1,), np.int64))
        y[idx, idx].cpu()

    def _pick_block(self) -> int:
        """This dispatch's block size from the ladder, by load with
        hysteresis (single-rung ladders short-circuit)."""
        if len(self.step_blocks) == 1:
            return self.step_blocks[0]
        load = (self._n_active + self.queue_depth) / self.max_slots
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
        """/healthz: constant-time load figures."""
        n = self._steps
        return {"queued": self.queue_depth, "active": self._n_active,
                "slots": self.max_slots,
                "mean_occupancy": round(self._occupancy / n, 4) if n
                                  else 0.0}

    @property
    def precision_desc(self) -> dict:
        """/healthz and the banner: profile, envelope, params' size, and
        the served profiles where children serve more."""
        desc = self._drift.desc(self.backend.serving_params())
        if self._children:
            desc["profiles"] = [self.backend.precision, *self._children]
        return desc

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return upload(x, self.backend.device)

    # -- request side ---------------------------------------------------
    def submit(self, x: np.ndarray, max_wait_s: float | None = None,
               cls: str | None = None, profile: str | None = None
               ) -> Future:
        """Enqueue one sequence ``(T, F)``; resolves to ``(out_dim,)``.
        ``cls`` names the SLO class (default: the most urgent);
        ``max_wait_s`` sets the deadline that orders admission within a
        class and bounds the output's wait for its readback; ``profile``
        routes the request to that profile's child scheduler."""
        child = _route(self, profile)
        if child is not None:
            return child.submit(x, max_wait_s=max_wait_s, cls=cls)
        x = np.asarray(x, np.float32)
        cls, prio = resolve_request_class(self._class_priority, cls)
        if x.ndim != 2 or x.shape[1] != self.backend.feat_dim:
            raise ServeError(
                f"sequence must be (steps, {self.backend.feat_dim}), "
                f"got {x.shape}")
        if len(x) == 0:
            raise ServeError("sequence must have at least one step")
        req = SeqRequest(x=x, cls=cls, priority=prio)
        if max_wait_s is not None:
            req.deadline = req.t_submit + max(0.0, float(max_wait_s))
        with self._cond:
            if self._aborted is not None:
                raise ServeError(f"engine stopped after a dispatcher "
                                 f"failure ({self._aborted!r}); request "
                                 f"rejected")
            if self._closed:
                raise ServeError("engine is closed; request rejected")
            req.seq = self._n_submitted
            self._n_submitted += 1
            with self._lock:
                self._requests += 1
            heapq.heappush(self._q, (req.priority, req.deadline, req.seq,
                                     req))
            self._cond.notify_all()
        return req.future

    def predict(self, x: np.ndarray, max_wait_s: float | None = None,
                cls: str | None = None, profile: str | None = None
                ) -> np.ndarray:
        return self.submit(x, max_wait_s=max_wait_s, cls=cls,
                           profile=profile).result()

    # -- dispatcher thread ----------------------------------------------
    @property
    def _n_active(self) -> int:
        return self.max_slots - len(self._free)

    def _admit_locked(self) -> None:
        """Fill freed slots in (class priority, deadline, arrival) order;
        a request whose future is already done (cancelled) is dropped.
        An admitted slot's state is zeroed in its first block."""
        while self._free and self._q:
            req = heapq.heappop(self._q)[-1]
            if req.future.done():
                continue
            slot = self._free.pop()
            self._slot_req[slot] = req
            self._slot_pos[slot] = 0
            self._pending_reset.add(slot)

    def _admit_or_wait(self) -> bool:
        """Admit queued sequences; block while fully idle. False once
        closed and drained (the dispatcher exits)."""
        with self._cond:
            while True:
                self._admit_locked()
                if self._n_active or not self._buffer.empty or self._staged:
                    return True
                if self._closed and not self._q:
                    return False
                self._cond.wait()

    def _run(self, warmup: bool) -> None:
        with torch.inference_mode():
            try:
                self._states = self.backend.init_states(self.max_slots)
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
            except BaseException as e:  # noqa: BLE001 — no request hangs
                self._abort(e)

    def _dispatch_step(self) -> None:
        t0 = time.monotonic()
        pool = self.max_slots
        active = self._n_active
        admitted = len(self._pending_reset)
        k = self._pick_block()
        try:
            x = np.zeros((pool, k, self.backend.feat_dim), np.float32)
            reset = np.zeros((pool, 1), bool)
            for slot in self._pending_reset:
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
            # the upload and the block are enqueued, not waited for:
            # block N+1's copy overlaps block N's compute
            self._states, y_dev = self.backend.block_fn(
                self._states, self._put(x), self._put(reset))
        except Exception as e:  # noqa: BLE001 — fail in-flight, keep serving
            self._fault(e)
            return
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
        with self._lock:
            self._steps += 1
            self._occupancy += active / pool
            self._block_hist[k] += 1
        done = self._buffer.push((finished, active, admitted, k, t0, y_dev))
        if done is not None:
            self._complete(done)

    def _complete(self, item) -> None:
        """Retire one in-flight block: gather its finishers' output rows
        on the device (no host transfer) into the staging buffer, then
        flush it if due."""
        finished, active, admitted, k, t0, y_dev = item
        if finished:
            reqs = [req for _s, _b, req in finished]
            try:
                slots = self._put(np.array([s for s, _b, _r in finished]))
                subs = self._put(np.array([b for _s, b, _r in finished]))
                y_sel = y_dev[slots, subs]
            except Exception as e:  # noqa: BLE001 — fail them, keep serving
                self._fail(reqs, e, "readback")
            else:
                now = time.monotonic()
                flush_at = now + self.readback_interval_s
                for req in reqs:
                    # a finisher's own deadline bounds its staging wait
                    if req.deadline < flush_at:
                        flush_at = max(now, req.deadline)
                self._staged.append((reqs, flush_at, y_sel))
                self._staged_rows += len(reqs)
        with self._lock:
            self._step_ms.append((time.monotonic() - t0) * 1e3)
        self._flush_readback()

    def _flush_readback(self, force: bool = False) -> None:
        """Drain the staging buffer in ONE device→host read and resolve
        every staged finisher: when the earliest staged deadline is due,
        a pool's worth of rows waits, or ``force`` (idle, close, fault)."""
        if not self._staged:
            return
        if (not force and self._staged_rows < self.max_slots
                and time.monotonic() < min(dl for _r, dl, _y
                                           in self._staged)):
            return
        entries, self._staged = self._staged, []
        self._staged_rows = 0
        reqs = [req for e_reqs, _dl, _y in entries for req in e_reqs]
        try:
            rows = [y for _r, _dl, y in entries]
            out = (rows[0] if len(rows) == 1 else torch.cat(rows)).cpu(
            ).numpy().astype(self.backend.out_dtype)
        except Exception as e:  # noqa: BLE001 — fail staged, keep serving
            self._fail(reqs, e, "readback")
            return
        now = time.monotonic()
        with self._lock:
            for req in reqs:
                self._cls_stats.observe(req.cls, now - req.t_submit)
            self._completed += len(reqs)
            self._readbacks += 1
        for i, req in enumerate(reqs):
            resolve_future(req.future, out[i].copy())
        if self.backend.precision != "f32":
            # the oracle runs after the futures resolve: no client waits
            if self._drift_tick % DRIFT_EVERY == 0:
                self._drift.sample(
                    out[0], lambda: self.backend.predict(reqs[0].x),
                    self._lock)
            self._drift_tick += 1

    def _fail(self, reqs: list[SeqRequest], exc: BaseException,
              what: str) -> None:
        logger.warning("%s failed for %d sequence(s): %r", what, len(reqs),
                       exc)
        with self._lock:
            self._errors += 1
            self._failed += len(reqs)
        for req in reqs:
            resolve_future(req.future, exc=exc)

    def _fault(self, exc: BaseException) -> None:
        """A failed dispatch fails only the sequences holding slots: blocks
        already in flight retire first (their finishers' outputs are
        valid), then every slot-holder gets the exception and the pool is
        rebuilt empty; queued sequences admit and complete after it."""
        for item in self._buffer.drain():
            self._complete(item)
        self._flush_readback(force=True)
        holders = [req for req in self._slot_req if req is not None]
        self._slot_req = [None] * self.max_slots
        self._slot_pos = [0] * self.max_slots
        self._free = list(range(self.max_slots))
        self._pending_reset.clear()
        self._fail(holders, exc, "step block")
        self._states = self.backend.init_states(self.max_slots)

    def _abort(self, exc: BaseException) -> None:
        """The dispatcher cannot go on (a fault escaped ``_fault`` itself,
        e.g. a sticky device error that also fails the pool's rebuild):
        close the engine, so ``submit`` raises, and fail every request it
        holds — queued, holding a slot, in flight or staged — with
        ``exc``, so no client waits on a future nothing will resolve."""
        logger.error("step dispatcher stopped: %r", exc)
        with self._cond:
            self._closed = True
            self._aborted = exc
            reqs = [entry[-1] for entry in self._q]
            self._q = []
        reqs += [req for req in self._slot_req if req is not None]
        reqs += [req for item in self._buffer.drain()
                 for _s, _b, req in item[0]]
        reqs += [req for e_reqs, _dl, _y in self._staged for req in e_reqs]
        self._staged = []
        self._staged_rows = 0
        self._slot_req = [None] * self.max_slots
        self._free = list(range(self.max_slots))
        self._fail(reqs, exc, "dispatcher")

    # -- introspection / lifecycle --------------------------------------
    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._q)

    def _profile_row(self) -> dict:
        """This scheduler's row of ``stats()["profiles"]``."""
        with self._lock:
            return {"requests": self._requests,
                    "completed": self._completed, "active": self._n_active,
                    "drift": self._drift.snapshot()}

    def stats(self) -> dict:
        """The JAX step scheduler's stats() keys, less the sections of the
        parts not ported yet (slo, trace, preempt, budget, paging, aot)."""
        queued = self.queue_depth
        with self._lock:
            lat = sorted(self._step_ms)
            n = self._steps
            out = {
                "scheduler": "continuous",
                "slots": self.max_slots,
                "step_block": self.step_block,
                "step_blocks": list(self.step_blocks),
                "block_hist": {str(k): c for k, c
                               in sorted(self._block_hist.items()) if c},
                "active": self._n_active,
                "queued": queued,
                "steps": n,
                "sequences": self._completed,
                "failed": self._failed,
                "errors": self._errors,
                "readbacks": self._readbacks,
                "classes": self._cls_stats.snapshot(),
                "precision": self._drift.snapshot(),
                "mean_occupancy": round(self._occupancy / n, 4) if n
                                  else 0.0,
                "uptime_s": round(time.monotonic() - self._t_start, 3),
            }
        out["p50_step_ms"] = round(percentile(lat, 0.50), 3)
        out["p99_step_ms"] = round(percentile(lat, 0.99), 3)
        if self._children:
            out["profiles"] = _profiles(self)
        return out

    def close(self) -> None:
        """Stop accepting requests, drain queued and in-flight work, join
        the dispatcher (children first)."""
        for child in self._children.values():
            child.close()
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self.start()  # a never-started scheduler still drains and exits
        self._thread.join()

    def __enter__(self) -> "StepScheduler":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


class WholeSequenceScheduler:
    """Request-granular sequence batching (``serve.scheduler="batch"``).

    One micro-batch is one ``padded_fn`` call at a (row bucket, time
    bucket) shape; rows past the batch and steps past each row's length
    are zero padding, and each row's output is read at its true last
    step. Cuts order by (class priority, deadline, arrival); ``profiles``
    adds a child scheduler per extra profile."""

    kind = "sequence"  # transport: a request is one ordered sequence

    def __init__(self, backend: RecurrentBackend, *,
                 row_buckets: Sequence[int] = (8, 32),
                 time_buckets: Sequence[int] = (8, 16, 32, 64),
                 max_wait_ms: float = 2.0, inflight: int = 2,
                 warmup: bool = False,
                 classes: Sequence[str] = ("interactive", "bulk"),
                 profiles: Sequence[str] = ()):
        self.backend = backend
        extra = _extra_profiles(backend, profiles)
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
        self._requests = self._batches = self._sequences = self._errors = 0
        self._row_fill = self._time_fill = 0.0
        self._t_start = time.monotonic()
        self._closed = False
        if warmup:
            self.warmup()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-seq-dispatch")
        self._thread.start()
        self._children: dict[str, WholeSequenceScheduler] = {
            p: WholeSequenceScheduler(
                backend.with_profile(p), row_buckets=row_buckets,
                time_buckets=time_buckets, max_wait_ms=max_wait_ms,
                inflight=inflight, warmup=warmup, classes=classes)
            for p in extra}

    @property
    def children(self) -> dict:
        """The child schedulers, by the extra profile each serves."""
        return dict(self._children)

    def warmup(self) -> None:
        """Run every (row bucket, time bucket) program once, so the first
        request pays for no kernel build, allocator growth or library
        initialisation."""
        for rb in self.row_buckets:
            for tb in self.time_buckets:
                x = np.zeros((rb, tb, self.backend.feat_dim), np.float32)
                self.backend.padded_fn(x, np.zeros((rb,), np.int64)).cpu()

    @property
    def slo_desc(self) -> dict:
        """/healthz: the admitted classes."""
        return {"classes": list(self.classes)}

    @property
    def load_desc(self) -> dict:
        """/healthz: constant-time load figures."""
        return {"queued": self._batcher.queue_depth}

    @property
    def precision_desc(self) -> dict:
        """/healthz and the banner: profile, envelope, params' size, and
        the served profiles where children serve more."""
        desc = self._drift.desc(self.backend.serving_params())
        if self._children:
            desc["profiles"] = [self.backend.precision, *self._children]
        return desc

    # -- request side ---------------------------------------------------
    def submit(self, x: np.ndarray, max_wait_s: float | None = None,
               cls: str | None = None, profile: str | None = None
               ) -> Future:
        """Enqueue one sequence ``(T, F)``; resolves to ``(out_dim,)``.
        ``max_wait_s`` shortens this request's flush deadline (clamped to
        the configured ceiling); ``cls`` names its SLO class; ``profile``
        routes it to that profile's child scheduler."""
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
        # (1, T, F): one request = one row
        req = Request(x=x[None], priority=prio, cls=cls)
        if max_wait_s is not None:
            req.deadline = req.t_submit + max(
                0.0, min(float(max_wait_s), self.max_wait_s))
        self._batcher.submit(req)
        with self._lock:
            self._requests += 1
        return req.future

    def predict(self, x: np.ndarray, max_wait_s: float | None = None,
                cls: str | None = None, profile: str | None = None
                ) -> np.ndarray:
        return self.submit(x, max_wait_s=max_wait_s, cls=cls,
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
            tb = pick_bucket(max(lens), self.time_buckets)
            rb = pick_bucket(len(batch), self.row_buckets)
            x = np.zeros((rb, tb, self.backend.feat_dim), np.float32)
            last = np.zeros((rb,), np.int64)
            for i, req in enumerate(batch):
                x[i, :lens[i]] = req.x[0]
                last[i] = lens[i] - 1
            y_dev = self.backend.padded_fn(x, last)
        except Exception as e:  # noqa: BLE001 — fail the batch, keep serving
            self._fail(batch, e)
            return
        done = self._buffer.push((batch, rb, tb, lens, t0, y_dev))
        if done is not None:
            self._complete(done)

    def _fail(self, batch: list[Request], exc: BaseException) -> None:
        logger.warning("sequence micro-batch of %d failed: %r",
                       len(batch), exc)
        with self._lock:
            self._errors += 1
        for req in batch:
            resolve_future(req.future, exc=exc)

    def _complete(self, item) -> None:
        batch, rb, tb, lens, t0, y_dev = item
        try:
            y = y_dev.cpu().numpy().astype(self.backend.out_dtype)
        except Exception as e:  # noqa: BLE001 — a device fault fails the batch
            self._fail(batch, e)
            return
        now = time.monotonic()
        # accounting BEFORE futures resolve: a returned predict() sees
        # itself in stats()
        with self._lock:
            for r in batch:
                self._latencies.append(now - r.t_submit)
                self._cls_stats.observe(r.cls, now - r.t_submit)
            self._batches += 1
            self._sequences += len(batch)
            self._row_fill += len(batch) / rb
            self._time_fill += sum(lens) / (len(batch) * tb)
        for i, req in enumerate(batch):
            resolve_future(req.future, y[i].copy())
        if self.backend.precision != "f32":
            # the oracle runs after the futures resolve: no client waits
            if self._drift_tick % DRIFT_EVERY == 0:
                self._drift.sample(
                    y[0], lambda: self.backend.predict(batch[0].x[0]),
                    self._lock)
            self._drift_tick += 1

    # -- introspection / lifecycle --------------------------------------
    def _profile_row(self) -> dict:
        """This scheduler's row of ``stats()["profiles"]``."""
        with self._lock:
            return {"requests": self._requests,
                    "completed": self._sequences,
                    "drift": self._drift.snapshot()}

    def stats(self) -> dict:
        """The JAX batch scheduler's stats() keys, less the sections of the
        parts not ported yet (slo, trace)."""
        with self._lock:
            lat = sorted(self._latencies)
            n = self._batches
            out = {
                "scheduler": "batch",
                "batches": n,
                "sequences": self._sequences,
                "errors": self._errors,
                "queued": self._batcher.queue_depth,
                "mean_row_fill": round(self._row_fill / n, 4) if n else 0.0,
                "mean_time_fill": round(self._time_fill / n, 4) if n else 0.0,
                "classes": self._cls_stats.snapshot(),
                "precision": self._drift.snapshot(),
                "uptime_s": round(time.monotonic() - self._t_start, 3),
            }
        out["p50_ms"] = round(percentile(lat, 0.50) * 1e3, 3)
        out["p99_ms"] = round(percentile(lat, 0.99) * 1e3, 3)
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

    def __enter__(self) -> "WholeSequenceScheduler":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


def make_sequence_engine(backend: RecurrentBackend, cfg):
    """``cfg.serve`` → the configured sequence scheduler ("batch" |
    "continuous")."""
    serve = cfg.serve
    if serve.scheduler == "continuous":
        return StepScheduler(
            backend, max_slots=serve.max_slots, step_block=serve.step_block,
            step_blocks=serve.step_blocks or None, classes=serve.classes,
            readback_interval_ms=serve.readback_interval_ms,
            inflight=serve.inflight, warmup=serve.warmup,
            profiles=serve.profiles)
    if serve.scheduler == "batch":
        return WholeSequenceScheduler(
            backend, row_buckets=serve.buckets,
            time_buckets=serve.seq_buckets, max_wait_ms=serve.max_wait_ms,
            inflight=serve.inflight, warmup=serve.warmup,
            classes=serve.classes, profiles=serve.profiles)
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

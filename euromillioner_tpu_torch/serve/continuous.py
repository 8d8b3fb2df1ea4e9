"""Whole-sequence serving for the lstm family (the JAX package's
``serve/continuous.py``, its ``serve.scheduler="batch"`` half).

:class:`RecurrentBackend` wraps a stacked-LSTM model with the program the
batch scheduler runs — ``padded_fn``, a time-padded whole-sequence apply
with a per-row gather at each true last step — and ``predict``, the
direct single-sequence path every profile is measured against.

:class:`WholeSequenceScheduler` coalesces ragged sequences into
micro-batches (count reaches the largest row bucket, or the oldest
request's deadline passes), pads time to the smallest fitting time bucket
and rows to the smallest row bucket, and runs ``padded_fn`` on a
dispatcher thread, keeping up to ``inflight`` batches enqueued on the
device while the oldest one's reply is read back.

Profiles, as the JAX package's: ``f32`` serves in the checkpoint's
compute dtype through the Python-loop scan (the oracle's arithmetic);
``bf16`` casts the params to bfloat16 once and scans in bfloat16;
``fused`` serves float32 through the fused CUDA sequence kernel
(ops/fused_lstm.py), one launch per LSTM layer per micro-batch; ``int8w``
keeps weight-only int8 params and their scales resident, dequantizes them
to float32 at each call and runs the same kernel. Each but ``f32`` serves
behind its pinned envelope of the oracle. The step scheduler, telemetry,
SLO classes, traces, the AOT store, drift sampling and fault points are
not ported yet: where the JAX package's ``serve.quant`` fault point falls
back to f32 when a cast or quantization fails, this port raises.
"""

from __future__ import annotations

import collections
import copy
import threading
import time
from typing import Sequence

import numpy as np
import torch

from euromillioner_tpu_torch.config import check_ported
from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.core.precision import (cast_floats,
                                                    dequantize_int8w,
                                                    fake_quant_int8,
                                                    quantize_int8w,
                                                    resolve_serve_precision,
                                                    serve_envelope)
from euromillioner_tpu_torch.core.prefetch import DoubleBuffer
from euromillioner_tpu_torch.models.lstm import padded_apply
from euromillioner_tpu_torch.serve.batcher import (LATENCY_WINDOW,
                                                   MicroBatcher, Request,
                                                   percentile, pick_bucket,
                                                   resolve_future,
                                                   validate_buckets)
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


class RecurrentBackend:
    """Serving backend for a stacked-LSTM model whose parameters already
    sit on the serving device.

    * ``padded_fn(x, last_idx)`` — ``x`` (rows, steps, F) float32 on the
      host, ``last_idx`` (rows,) → (rows, out) float32 on the device: the
      batch scheduler's program, at this backend's profile.
    * ``predict(x)`` — (T, F) → (out,) through the scan in the compute
      dtype on the checkpoint's params: the oracle, whatever the profile.

    ``serve_dtype`` is what the program computes in: the compute dtype
    under ``f32``, bfloat16 under ``bf16``, float32 under ``fused`` and
    ``int8w`` (the JAX package's ``sdt``). ``bf16`` and ``int8w`` run a
    private skeleton of the model (its own params on the meta device) on
    ``serve_params``: the bf16 cast, or the int8 values and scales."""

    family = "lstm"

    def __init__(self, model, feat_dim: int = 11, compute_dtype=None,
                 precision: str = "f32", act_quant: bool = False,
                 fused_unroll: int = 8):
        from euromillioner_tpu_torch.nn.recurrent import LSTM

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
        program = _PaddedProgram(
            model if self.serve_params is None
            else copy.deepcopy(model).to("meta"), fused)
        lock = threading.Lock()  # functional_call swaps the skeleton's params
        quantized = self.precision == "int8w"
        act_q = self._act_quant and quantized
        sdt = self.serve_dtype
        dev = self.device

        def padded(x, last_idx):
            with torch.inference_mode():
                h = torch.as_tensor(x, device=dev).to(sdt)
                if act_q:
                    h = fake_quant_int8(h)
                if self.serve_params is None:
                    y = program(h, last_idx)
                else:
                    params = self.serve_params
                    if quantized:
                        params = dequantize_int8w(params, torch.float32)
                    with lock:
                        y = torch.func.functional_call(
                            program, {f"model.{k}": v
                                      for k, v in params.items()},
                            (h, last_idx))
                return y.to(torch.float32)

        self.padded_fn = padded

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


class WholeSequenceScheduler:
    """Request-granular sequence batching (``serve.scheduler="batch"``).

    One micro-batch is one ``padded_fn`` call at a (row bucket, time
    bucket) shape; rows past the batch and steps past each row's length
    are zero padding, and each row's output is read at its true last
    step."""

    kind = "sequence"  # transport: a request is one ordered sequence

    def __init__(self, backend: RecurrentBackend, *,
                 row_buckets: Sequence[int] = (8, 32),
                 time_buckets: Sequence[int] = (8, 16, 32, 64),
                 max_wait_ms: float = 2.0, inflight: int = 2,
                 warmup: bool = False):
        self.backend = backend
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
        self._batches = self._sequences = self._errors = 0
        self._row_fill = self._time_fill = 0.0
        self._closed = False
        if warmup:
            self.warmup()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-seq-dispatch")
        self._thread.start()

    def warmup(self) -> None:
        """Run every (row bucket, time bucket) program once, so the first
        request pays for no kernel build, allocator growth or library
        initialisation."""
        for rb in self.row_buckets:
            for tb in self.time_buckets:
                x = np.zeros((rb, tb, self.backend.feat_dim), np.float32)
                self.backend.padded_fn(x, np.zeros((rb,), np.int64)).cpu()

    # -- request side ---------------------------------------------------
    def submit(self, x: np.ndarray, max_wait_s: float | None = None
               ) -> Future:
        """Enqueue one sequence ``(T, F)``; resolves to ``(out_dim,)``.
        ``max_wait_s`` shortens this request's flush deadline (clamped to
        the configured ceiling)."""
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.backend.feat_dim:
            raise ServeError(
                f"sequence must be (steps, {self.backend.feat_dim}), "
                f"got {x.shape}")
        if not 1 <= len(x) <= self.time_buckets[-1]:
            raise ServeError(
                f"sequence of {len(x)} steps outside [1, "
                f"{self.time_buckets[-1]}] (largest time bucket)")
        req = Request(x=x[None])  # (1, T, F): one request = one row
        if max_wait_s is not None:
            req.deadline = req.t_submit + max(
                0.0, min(float(max_wait_s), self.max_wait_s))
        self._batcher.submit(req)
        return req.future

    def predict(self, x: np.ndarray, max_wait_s: float | None = None
                ) -> np.ndarray:
        return self.submit(x, max_wait_s=max_wait_s).result()

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
            self._latencies.extend(now - r.t_submit for r in batch)
            self._batches += 1
            self._sequences += len(batch)
            self._row_fill += len(batch) / rb
            self._time_fill += sum(lens) / (len(batch) * tb)
        for i, req in enumerate(batch):
            resolve_future(req.future, y[i].copy())

    # -- introspection / lifecycle --------------------------------------
    def stats(self) -> dict:
        """The keys the JAX package's batch scheduler pins."""
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
            }
        out["p50_ms"] = round(percentile(lat, 0.50) * 1e3, 3)
        out["p99_ms"] = round(percentile(lat, 0.99) * 1e3, 3)
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._batcher.close()
        self._thread.join()

    def __enter__(self) -> "WholeSequenceScheduler":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


def make_sequence_engine(backend: RecurrentBackend, cfg
                         ) -> WholeSequenceScheduler:
    """``cfg.serve`` → the configured sequence scheduler."""
    check_ported(cfg)
    if cfg.serve.scheduler != "batch":
        raise ServeError(f"serve.scheduler must be batch|continuous, "
                         f"got {cfg.serve.scheduler!r}")
    return WholeSequenceScheduler(
        backend, row_buckets=cfg.serve.buckets,
        time_buckets=cfg.serve.seq_buckets,
        max_wait_ms=cfg.serve.max_wait_ms, inflight=cfg.serve.inflight,
        warmup=cfg.serve.warmup)


def load_recurrent_backend(cfg, checkpoint: str, num_features: int = 0,
                           device=None) -> RecurrentBackend:
    """A :class:`RecurrentBackend` from an LSTM checkpoint directory of
    either package, on ``device`` (the card when None). The profile and
    the scheduler are validated before the restore (ConfigError)."""
    from euromillioner_tpu_torch.models.registry import restore_for_inference

    profile = resolve_serve_precision(cfg.serve.precision)
    check_ported(cfg)
    if not checkpoint:
        raise ServeError("serve --model-type lstm needs --checkpoint")
    cfg.model.name = "lstm"
    model, compute_dtype, in_shape, _ck = restore_for_inference(
        cfg, checkpoint, num_features, device)
    return RecurrentBackend(model, feat_dim=in_shape[-1],
                            compute_dtype=compute_dtype, precision=profile,
                            act_quant=cfg.serve.act_quant,
                            fused_unroll=cfg.serve.fused_unroll)

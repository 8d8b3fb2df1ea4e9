"""Row micro-batching engine (the JAX package's ``serve/engine.py``
``InferenceEngine``, lean).

Requests of one or more feature rows queue in a :class:`MicroBatcher`; a
dispatcher thread cuts micro-batches (largest bucket reached, or the
oldest request's deadline passed), pads each to the smallest fitting
bucket of ``serve.buckets``, runs the backend's forward on the device and
keeps up to ``inflight`` batches enqueued while the oldest is read back.
Every bucket's program runs once at start (``warmup``).

Not ported yet: SLO classes, memory budgets, drift sampling, per-request
precision profiles, telemetry and traces, workload capture, the serving
mesh, the AOT store, and chunking of a request larger than the largest
bucket (refused with a ServeError).
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import numpy as np
import torch

from euromillioner_tpu_torch.core.prefetch import DoubleBuffer
from euromillioner_tpu_torch.serve.batcher import (LATENCY_WINDOW,
                                                   MicroBatcher, Request,
                                                   pad_rows, percentile,
                                                   pick_bucket,
                                                   resolve_future,
                                                   validate_buckets)
from euromillioner_tpu_torch.utils.errors import ServeError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("serve.engine")


class InferenceEngine:
    """Dynamic micro-batching over one row backend (``serve.session``'s
    ``NNBackend``, ``GBTBackend`` or ``RFBackend``): ``submit`` returns a
    future, ``predict`` blocks."""

    kind = "rows"  # transport: a request is a batch of independent rows

    def __init__(self, backend, *, buckets: Sequence[int] = (8, 32, 128),
                 max_wait_ms: float = 2.0, inflight: int = 2,
                 warmup: bool = True):
        self.backend = backend
        self.buckets = validate_buckets(buckets)
        self.max_batch = self.buckets[-1]
        if inflight < 1:
            raise ServeError(f"inflight must be >= 1, got {inflight}")
        self._feat_shape = tuple(backend.feat_shape)
        self._batcher = MicroBatcher(self.max_batch, max_wait_ms / 1000.0)
        self._buffer = DoubleBuffer(depth=inflight)
        self._lock = threading.Lock()
        self._latencies: collections.deque = collections.deque(
            maxlen=LATENCY_WINDOW)
        self._requests = self._rows = self._batches = self._errors = 0
        self._fill = 0.0
        self._closed = False
        if warmup:
            self.warmup()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-dispatch")
        self._thread.start()

    def _put(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.backend.device.type == "cuda":
            return t.pin_memory().to(self.backend.device, non_blocking=True)
        return t

    def warmup(self) -> None:
        """Run every bucket's program once, so the first request pays for
        no kernel build, allocator growth or library initialisation."""
        for b in self.buckets:
            x = np.zeros((b, *self._feat_shape), np.float32)
            self.backend.apply(self._put(self.backend.prepare(x))).cpu()

    # -- request side ---------------------------------------------------
    def submit(self, x: np.ndarray, max_wait_s: float | None = None
               ) -> Future:
        """Enqueue rows ``(n, *feat)`` (a single row ``feat`` is lifted to
        one); resolves to an ``(n, out)`` array. ``max_wait_s`` shortens
        this request's flush deadline (clamped to the engine's)."""
        x = np.asarray(x, np.float32)
        if x.shape == self._feat_shape:
            x = x[None]
        if x.shape[1:] != self._feat_shape:
            raise ServeError(
                f"request rows have feature shape {x.shape[1:]}, model "
                f"wants {self._feat_shape}")
        if len(x) == 0:
            f: Future = Future()
            f.set_result(np.empty((0,), self.backend.out_dtype))
            return f
        if len(x) > self.max_batch:
            raise ServeError(
                f"request of {len(x)} rows exceeds the largest bucket "
                f"{self.max_batch} (chunking is not ported yet)")
        req = Request(x=x)
        if max_wait_s is not None:
            req.deadline = req.t_submit + max(
                0.0, min(float(max_wait_s), self._batcher.max_wait_s))
        self._batcher.submit(req)
        return req.future

    def predict(self, x: np.ndarray, max_wait_s: float | None = None
                ) -> np.ndarray:
        return self.submit(x, max_wait_s=max_wait_s).result()

    # -- dispatcher thread ----------------------------------------------
    def _run(self) -> None:
        while True:
            # with device work in flight, poll instead of blocking so the
            # oldest batch's readback proceeds while requests trickle in
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
        rows = sum(r.rows for r in batch)
        try:
            bucket = pick_bucket(rows, self.buckets)
            x = (batch[0].x if len(batch) == 1
                 else np.concatenate([r.x for r in batch]))
            y_dev = self.backend.apply(
                self._put(self.backend.prepare(pad_rows(x, bucket))))
        except Exception as e:  # noqa: BLE001 — fail the batch, keep serving
            self._fail(batch, e)
            return
        done = self._buffer.push((batch, rows, bucket, t0, y_dev))
        if done is not None:
            self._complete(done)

    def _fail(self, batch: list[Request], exc: BaseException) -> None:
        logger.warning("micro-batch of %d request(s) failed: %r", len(batch),
                       exc)
        with self._lock:
            self._errors += 1
        for req in batch:
            resolve_future(req.future, exc=exc)

    def _complete(self, item) -> None:
        batch, rows, bucket, t0, y_dev = item
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
            self._requests += len(batch)
            self._rows += rows
            self._batches += 1
            self._fill += rows / bucket
        off = 0
        for req in batch:
            resolve_future(req.future, y[off:off + req.rows].copy())
            off += req.rows

    # -- introspection / lifecycle --------------------------------------
    def stats(self) -> dict:
        """Counters and p50/p99 request latency over the recent window,
        under the JAX row engine's key names."""
        with self._lock:
            lat = sorted(self._latencies)
            n = self._batches
            out = {
                "requests": self._requests,
                "rows": self._rows,
                "batches": n,
                "errors": self._errors,
                "queue_depth": self._batcher.queue_depth,
                "mean_fill_ratio": round(self._fill / n, 4) if n else 0.0,
            }
        out["p50_ms"] = round(percentile(lat, 0.50) * 1e3, 3)
        out["p99_ms"] = round(percentile(lat, 0.99) * 1e3, 3)
        return out

    def close(self) -> None:
        """Stop accepting requests, drain queued work, join the
        dispatcher."""
        if self._closed:
            return
        self._closed = True
        self._batcher.close()
        self._thread.join()

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


def make_row_engine(backend, cfg) -> InferenceEngine:
    """``cfg.serve`` → the row engine over ``backend``."""
    return InferenceEngine(backend, buckets=cfg.serve.buckets,
                           max_wait_ms=cfg.serve.max_wait_ms,
                           inflight=cfg.serve.inflight,
                           warmup=cfg.serve.warmup)

"""Dynamic micro-batching (the JAX package's ``serve/batcher.py``).

Requests queue on the host and flush as one micro-batch when EITHER the
queued row count reaches ``max_batch`` OR the oldest request's deadline
(its submit time plus ``max_wait_s``, or its own shorter ``deadline``)
passes. Every micro-batch pads up to the smallest bucket that fits
(:func:`pick_bucket`), so the device sees a few fixed shapes.

SLO classes (``serve.classes``): a request carries its class's priority
rank, the cut takes requests in (priority, deadline, arrival) order, and
a queue that mixes priorities flushes at once, so an urgent request never
waits out bulk coalescing. Classless traffic batches exactly as before.
The batcher stamps each request's cut time (``t_cut``, the ``batch_cut``
stage of its trace span, obs/trace.py).
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from euromillioner_tpu_torch.obs.metrics import percentile  # noqa: F401 — re-export
from euromillioner_tpu_torch.utils.errors import ServeError

# ring size for the latency percentile window
LATENCY_WINDOW = 4096


def resolve_future(future: Future, value=None,
                   exc: BaseException | None = None) -> None:
    """Resolve a request future; a client cancel() may have won the race."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(value)
    except InvalidStateError:
        pass  # client cancelled: it no longer wants the answer


def validate_buckets(buckets: Sequence[int]) -> tuple[int, ...]:
    """Sorted, deduplicated, all-positive bucket sizes."""
    out = tuple(sorted(set(int(b) for b in buckets)))
    if not out or out[0] < 1:
        raise ServeError(f"buckets must be positive ints, got {buckets!r}")
    return out


def pick_bucket(rows: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``rows`` (buckets sorted ascending)."""
    for b in buckets:
        if rows <= b:
            return b
    raise ServeError(
        f"batch of {rows} rows exceeds the largest bucket {buckets[-1]}")


def pad_rows(x: np.ndarray, bucket: int) -> np.ndarray:
    """Pad axis 0 with zero rows up to ``bucket``. Every row family is
    row-independent, so pad rows never change real rows' values; the
    engine drops them before replying."""
    n = len(x)
    if n == bucket:
        return x
    pad = np.zeros((bucket - n, *x.shape[1:]), x.dtype)
    return np.concatenate([x, pad])


@dataclass
class Request:
    """One queued request: ``x`` is (rows, *feat). ``deadline`` (absolute
    monotonic) shortens the batcher's flush deadline for this request;
    ``priority`` is its SLO class's rank (0 = most urgent) and ``cls`` the
    class name; ``seq`` is the arrival ordinal (the tie-break).

    ``span`` is the request's trace id (None: tracing off) and ``t_cut``
    the monotonic time the batcher cut it into a micro-batch.
    ``slo_deadline`` is the client's raw ``max_wait_s`` deadline, judged
    for SLO attainment unclamped (``deadline`` is clamped to the
    batcher's coalescing ceiling)."""

    x: np.ndarray
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.monotonic)
    deadline: float | None = None
    priority: int = 0
    cls: str = ""
    seq: int = 0
    span: int | None = None
    t_cut: float = 0.0
    slo_deadline: float | None = None

    @property
    def rows(self) -> int:
        return len(self.x)


class MicroBatcher:
    """Thread-safe request queue with the dual flush rule: ``submit``
    from any thread, ``next_batch`` from the one dispatcher thread."""

    def __init__(self, max_batch: int, max_wait_s: float):
        if max_batch < 1:
            raise ServeError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ServeError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._q: collections.deque[Request] = collections.deque()
        self._rows = 0
        self._n_submitted = 0
        self._cond = threading.Condition()
        self._closed = False

    def submit(self, req: Request) -> None:
        with self._cond:
            if self._closed:
                raise ServeError("engine is closed; request rejected")
            req.seq = self._n_submitted
            self._n_submitted += 1
            self._q.append(req)
            self._rows += req.rows
            self._cond.notify_all()

    @property
    def queue_depth(self) -> int:
        """Requests queued and not yet cut into a micro-batch."""
        with self._cond:
            return len(self._q)

    def close(self) -> None:
        """Stop accepting requests; queued work still drains."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def _deadline(self, req: Request) -> float:
        return (req.deadline if req.deadline is not None
                else req.t_submit + self.max_wait_s)

    def _earliest_deadline(self) -> float:
        return min(self._deadline(r) for r in self._q)

    def _mixed_priority(self) -> bool:
        # an urgent arrival next to accumulating bulk rows cuts now; a
        # homogeneous queue keeps the plain dual flush rule
        it = iter(self._q)
        p0 = next(it).priority
        return any(r.priority != p0 for r in it)

    def next_batch(self, timeout: float | None = None) -> list[Request] | None:
        """Block until a flush is due, then cut one micro-batch (whole
        requests, up to ``max_batch`` rows). ``None`` when closed and
        drained; ``[]`` when ``timeout`` elapses with no flush due."""
        give_up = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                now = time.monotonic()
                if self._q:
                    if (self._rows >= self.max_batch or self._closed
                            or now >= self._earliest_deadline()
                            or self._mixed_priority()):
                        break
                    wake = self._earliest_deadline()
                else:
                    if self._closed:
                        return None
                    wake = None
                if give_up is not None:
                    if now >= give_up:
                        return []
                    wake = give_up if wake is None else min(wake, give_up)
                self._cond.wait(None if wake is None else wake - now)
            # uniform classes with uniform waits sort back to FIFO
            order = sorted(self._q, key=lambda r: (r.priority,
                                                   self._deadline(r), r.seq))
            batch: list[Request] = []
            rows = 0
            for req in order:
                if rows + req.rows > self.max_batch:
                    break  # whole requests only
                batch.append(req)
                rows += req.rows
            picked = {id(r) for r in batch}
            self._q = collections.deque(
                r for r in self._q if id(r) not in picked)
            self._rows -= rows
            t_cut = time.monotonic()
            for req in batch:
                req.t_cut = t_cut
            return batch

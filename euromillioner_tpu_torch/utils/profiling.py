"""Tracing and step timing for the training loop (the JAX package's
``utils/profiling.py``): :func:`trace` writes a ``torch.profiler`` trace of
a block (host operators and, on the card, every kernel the process
launches, the hand-written ones included), and :class:`StepTimer` counts
step wall-clock and throughput.

The timer reads the host clock. CUDA work is asynchronous, so on the card
the trainer hands it ``sync=torch.cuda.synchronize``: each tick then waits
for the step's kernels, and ms/step is the device's step time (host
enqueue included), at the cost of the host no longer running ahead of the
device.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable

from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("utils.profiling")

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Write a ``torch.profiler`` trace of the block to
    ``log_dir/trace.json`` (Chrome trace format; a no-op when ``log_dir``
    is None). CUDA activity is recorded when a card is present."""
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    logger.info("profiler trace → %s", path)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)


@dataclass
class StepTimer:
    """Rolling step wall-clock + examples/sec counters.

    ``tick(n_examples)`` after each step; ``summary()`` gives aggregate
    stats. The first ``warmup`` steps are excluded (kernel builds, first
    launches)."""

    warmup: int = 1
    sync: Callable[[], None] | None = None
    _t_last: float | None = None
    _times: list[float] = field(default_factory=list)
    _examples: list[int] = field(default_factory=list)
    _seen: int = 0

    def reset(self) -> None:
        """Drop the running interval (call after non-step work such as
        evaluation or checkpointing, so it is not counted as a step)."""
        self._t_last = None

    def tick(self, n_examples: int = 0) -> float | None:
        if self.sync is not None:
            self.sync()
        now = time.perf_counter()
        dt = None
        if self._t_last is not None:
            dt = now - self._t_last
            self._seen += 1
            if self._seen > self.warmup:
                self._times.append(dt)
                self._examples.append(n_examples)
        self._t_last = now
        return dt

    def summary(self) -> dict[str, float]:
        if not self._times:
            return {"steps": 0}
        total = sum(self._times)
        return {
            "steps": len(self._times),
            "mean_step_ms": 1e3 * total / len(self._times),
            "examples_per_sec": sum(self._examples) / max(total, 1e-9),
        }

"""Failure detection + restart-from-checkpoint (the JAX package's
``dist/failure.py``, which imports no jax; this is the port's own copy).

File-based heartbeats (each process beats; anyone can detect a stale
peer) and a restart-from-latest-checkpoint supervisor for the training
loop. No elasticity — a restart resumes the same topology. The
``heartbeat.beat`` and ``supervisor.attempt`` fault points
(resilience/inject.py) sit in each beat and each supervised attempt.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, TypeVar

from euromillioner_tpu_torch.resilience import fault_point
from euromillioner_tpu_torch.utils.errors import TrainError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("dist.failure")

T = TypeVar("T")


class Heartbeat:
    """Background thread writing ``{dir}/heartbeat-{name}.json`` every
    ``interval_s``; peers read the directory to detect dead processes.

    Visibility assumption: all processes must see ``directory`` — true for
    same-host process groups; across hosts it requires a shared filesystem
    (NFS/GCS-fuse), the same assumption the checkpoint barrier makes. With
    no shared filesystem, run one Heartbeat per host on local disk and let
    a host-level supervisor aggregate, or rely on the process group's own
    timeout (a dead process fails the next collective)."""

    def __init__(self, directory: str, name: str, interval_s: float = 5.0):
        self.directory = directory
        self.path = os.path.join(directory, f"heartbeat-{name}.json")
        self.name = name
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.step = 0

    def beat(self) -> None:
        fault_point("heartbeat.beat", name=self.name, step=self.step)
        os.makedirs(self.directory, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"name": self.name, "ts": time.time(),
                       "step": self.step}, fh)
        os.replace(tmp, self.path)

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        # The initial beat is strict: a raise here surfaces a misconfigured
        # directory to the caller instead of a silently absent heartbeat.
        self.beat()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.beat()
                except OSError as e:
                    # A transient write failure (disk full, NFS blip) must
                    # not kill the loop — a dead loop makes peers declare
                    # this healthy process stale. Log and keep beating; the
                    # staleness timeout catches genuinely persistent
                    # failures.
                    logger.warning(
                        "heartbeat %s beat failed (%s); retrying next interval",
                        self.name, e)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"heartbeat-{self.name}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1)
            self._thread = None

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def stale_processes(directory: str, timeout_s: float) -> list[str]:
    """Names whose last beat is older than ``timeout_s`` (the detection
    side of the heartbeat protocol)."""
    if not os.path.isdir(directory):
        return []
    now = time.time()
    stale = []
    for fn in sorted(os.listdir(directory)):
        if not fn.startswith("heartbeat-") or not fn.endswith(".json"):
            continue
        try:
            with open(os.path.join(directory, fn), encoding="utf-8") as fh:
                beat = json.load(fh)
            if now - float(beat["ts"]) > timeout_s:
                stale.append(beat.get("name", fn))
        except (OSError, ValueError, KeyError):
            stale.append(fn)  # unreadable beat counts as dead
    return stale


def run_with_restart(
    fn: Callable[[int], T],
    max_restarts: int = 2,
    retry_on: tuple[type[Exception], ...] = (TrainError,),
    backoff_s: float = 1.0,
) -> T:
    """Supervise a training run: on a retryable failure, call ``fn`` again
    with the attempt number — the callee reloads its latest checkpoint
    (``train.checkpoint.latest_checkpoint``) and continues. Non-retryable
    errors propagate immediately."""
    attempt = 0
    while True:
        try:
            fault_point("supervisor.attempt", attempt=attempt)
            return fn(attempt)
        except retry_on as e:
            attempt += 1
            if attempt > max_restarts:
                raise
            logger.warning("attempt %d failed (%s: %s); restarting in %.1fs",
                           attempt, type(e).__name__, e, backoff_s)
            time.sleep(backoff_s)

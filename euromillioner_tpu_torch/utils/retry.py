"""Retry with exponential backoff + jitter.

Generalizes the reference's crude anti-bot mechanism — a single random
``Thread.sleep(rand * 1000 ms)`` before its one HTTP request
(reference Main.java:53-54) — into a proper retry policy with bounded
exponential backoff and full jitter, per the failure-detection plan in
SURVEY.md §5.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Type, TypeVar

from euromillioner_tpu_torch.utils.logging_utils import get_logger

T = TypeVar("T")
logger = get_logger("utils.retry")


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff policy. ``pre_jitter_s`` reproduces the reference's random
    pre-request sleep (uniform in [0, pre_jitter_s), Main.java:54)."""

    max_attempts: int = 3
    base_delay_s: float = 0.5
    max_delay_s: float = 8.0
    pre_jitter_s: float = 1.0

    def delay(self, attempt: int) -> float:
        """Full-jitter exponential backoff for retry number ``attempt`` (1-based)."""
        cap = min(self.max_delay_s, self.base_delay_s * (2 ** (attempt - 1)))
        return random.uniform(0.0, cap)


def retry_with_backoff(
    fn: Callable[[], T],
    *,
    policy: RetryPolicy = RetryPolicy(),
    retry_on: Iterable[Type[BaseException]] = (Exception,),
    retry_if: Callable[[BaseException], bool] | None = None,
    sleep: Callable[[float], None] = time.sleep,
    description: str = "operation",
) -> T:
    """Run ``fn`` with pre-jitter and retries; re-raise the last failure.

    A failure is retryable when it is an instance of a ``retry_on`` type
    OR when the ``retry_if`` predicate accepts it — the predicate lets
    callers retry on attributes (e.g. an HTTP status on ``FetchError``)
    without defining marker subclasses. Pass ``retry_on=()`` to decide by
    predicate alone. When attempts exhaust, a terminal give-up line is
    logged before the last failure is re-raised.
    """
    retry_on = tuple(retry_on)
    if policy.pre_jitter_s > 0:
        sleep(random.uniform(0.0, policy.pre_jitter_s))
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn()
        except BaseException as e:  # noqa: PERF203, BLE001
            # BaseException, not Exception: retry_on is typed
            # Type[BaseException] and the non-retryable branch re-raises
            # immediately, so KeyboardInterrupt/SystemExit pass straight
            # through unless a caller explicitly opted them in.
            retryable = isinstance(e, retry_on) or (
                retry_if is not None and retry_if(e))
            if not retryable:
                raise
            if attempt == policy.max_attempts:
                logger.error(
                    "%s failed after %d attempt(s) (%s: %s) — giving up",
                    description, attempt, type(e).__name__, e,
                )
                raise
            d = policy.delay(attempt)
            logger.warning(
                "%s failed (attempt %d/%d): %s — retrying in %.2fs",
                description, attempt, policy.max_attempts, e, d,
            )
            sleep(d)
    raise AssertionError("unreachable: max_attempts >= 1")

"""Bounded window of in-flight device work (the JAX package's
``core/prefetch.DoubleBuffer``).

The serving scheduler pushes each dispatched micro-batch — its upload and
kernel launches are asynchronous on a CUDA stream — and ``push`` hands back
the OLDEST item only once the window exceeds ``depth``, so the consumer
waits on batch N's device→host read while batch N+1 is already enqueued.
"""

from __future__ import annotations

import collections
from typing import Any, Iterator


class DoubleBuffer:
    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = depth
        self._q: collections.deque = collections.deque()

    def __len__(self) -> int:
        return len(self._q)

    @property
    def empty(self) -> bool:
        return not self._q

    def push(self, item: Any) -> Any | None:
        """Add in-flight work; returns the oldest item when the window
        would exceed ``depth`` (the caller must complete it), else None."""
        self._q.append(item)
        if len(self._q) > self.depth:
            return self._q.popleft()
        return None

    def pop(self) -> Any:
        """Oldest in-flight item (caller completes it); raises on empty."""
        return self._q.popleft()

    def drain(self) -> Iterator[Any]:
        """Yield and remove all in-flight items, oldest first."""
        while self._q:
            yield self._q.popleft()

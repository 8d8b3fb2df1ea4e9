"""Logging with the reference's log4j line shape, plus JSONL metrics.

``timestamp LEVEL shortname - message`` (log4j pattern
``%d{yyyy-MM-dd HH:mm:ss} %-5p %c{1} - %m%n``) on Python ``logging``, the
same shape the JAX package writes, so logs of the two packages diff line
for line. Loggers live under the ``euromillioner_tpu_torch`` namespace.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import IO, Any

_FORMAT = "%(asctime)s %(levelname)-5s %(shortname)s - %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"
_ROOT = "euromillioner_tpu_torch"


class _ShortNameFilter(logging.Filter):
    """log4j's %c{1}: only the last component of the logger name."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.shortname = record.name.rsplit(".", 1)[-1]
        return True


def configure(level: int = logging.INFO, stream: IO[str] | None = None) -> None:
    """Attach one stdout handler to the package root logger (idempotent)."""
    root = logging.getLogger(_ROOT)
    if any(getattr(h, "_emt_handler", False) for h in root.handlers):
        return
    root.setLevel(level)
    handler = logging.StreamHandler(stream or sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
    handler.addFilter(_ShortNameFilter())
    handler._emt_handler = True
    root.addHandler(handler)


def get_logger(name: str) -> logging.Logger:
    """A logger under the package namespace; configures the root once."""
    configure()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


class JsonlMetricsWriter:
    """Append-only JSONL metrics sink: one JSON object per line, each
    stamped with ``ts`` (the JAX package's writer, same records)."""

    def __init__(self, path: str):
        self.path = path
        self._fh: IO[str] | None = open(path, "a", encoding="utf-8")

    def write(self, record: dict[str, Any]) -> None:
        if self._fh is None:
            raise ValueError("writer is closed")
        self._fh.write(json.dumps({"ts": time.time(), **record}) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "JsonlMetricsWriter":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()

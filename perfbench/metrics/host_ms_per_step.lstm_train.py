"""The trainer layer's host time a step, ms: see
``yardstick/readers.host_ms_per_step``."""

from perfbench.yardstick.readers import host_ms_per_step as read  # noqa: F401

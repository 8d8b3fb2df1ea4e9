"""The device's idle share of the traced window, %."""

from perfbench.yardstick.readers import idle_pct as read  # noqa: F401

"""The model step's share of the card's f32 peak while serving, %: see
``yardstick/readers.mfu_serve_pct``."""

from perfbench.yardstick.readers import mfu_serve_pct as read  # noqa: F401

"""The training step's share of the card's peak in its compute dtype, %:
see ``yardstick/readers.mfu_train_pct``."""

from perfbench.yardstick.readers import mfu_train_pct as read  # noqa: F401

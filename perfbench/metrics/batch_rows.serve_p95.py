"""Mean real rows per micro-batch: see ``yardstick/readers.batch_rows``."""

from perfbench.yardstick.readers import batch_rows as read  # noqa: F401

"""Resilience layer: deterministic fault injection for chaos testing (the
JAX package's ``resilience/``).

See :mod:`euromillioner_tpu_torch.resilience.inject` for the model and the
registry of named injection points, and ``tests/test_torch_resilience.py``
for the end-to-end harness (faulted training runs must produce eval
metrics bit-identical to fault-free runs).
"""

from euromillioner_tpu_torch.resilience.inject import (  # noqa: F401
    FaultPlan,
    FaultSpec,
    active_plan,
    fault_point,
    inject,
)

"""Distributed layer on ``torch.distributed`` (the JAX package's
``dist/``): one process per device, NCCL on the card and gloo on the CPU.

Data parallelism only: the data-parallel trainer (an all-reduce of the
gradients each step), parameter averaging, collectives over the group,
the forest's row-sharded histograms (``trees/random_forest.py``),
bootstrap and failure detection. Tensor and sequence parallelism
(``tp_rules_for``, ``seq_parallel_forward``) come in a later slice.
"""

from euromillioner_tpu_torch.dist.bootstrap import (initialize, is_primary,
                                                    runtime_info)
from euromillioner_tpu_torch.dist.collectives import (pmean_stacked,
                                                      psum_stacked,
                                                      tree_aggregate)
from euromillioner_tpu_torch.dist.param_avg import fit_parameter_averaging
from euromillioner_tpu_torch.dist.sharded import (DistributedTrainer,
                                                  place_batch)

__all__ = [
    "initialize",
    "is_primary",
    "runtime_info",
    "psum_stacked",
    "pmean_stacked",
    "tree_aggregate",
    "DistributedTrainer",
    "place_batch",
    "fit_parameter_averaging",
]

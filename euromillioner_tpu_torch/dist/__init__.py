"""Distributed layer on ``torch.distributed`` (the JAX package's
``dist/``): one process per device, NCCL on the card and gloo on the CPU.

The distributed trainer over a (data, model, seq) mesh: data
parallelism (an all-reduce of the gradients each step), tensor
parallelism per the models' sharding rules (``tp_rules_for``), sequence
parallelism through the pipelined chunk scan (``seq_parallel_forward``);
parameter averaging, collectives over the groups, the forest's
row-sharded histograms (``trees/random_forest.py``), bootstrap and
failure detection.
"""

from euromillioner_tpu_torch.dist.bootstrap import (initialize, is_primary,
                                                    runtime_info)
from euromillioner_tpu_torch.dist.collectives import (pmean_stacked,
                                                      psum_stacked,
                                                      tree_aggregate)
from euromillioner_tpu_torch.dist.param_avg import fit_parameter_averaging
from euromillioner_tpu_torch.dist.seq_parallel import seq_parallel_forward
from euromillioner_tpu_torch.dist.sharded import (GENERIC_TP_RULES,
                                                  DistributedTrainer,
                                                  place_batch, tp_rules_for)

__all__ = [
    "initialize",
    "is_primary",
    "runtime_info",
    "psum_stacked",
    "pmean_stacked",
    "tree_aggregate",
    "DistributedTrainer",
    "place_batch",
    "GENERIC_TP_RULES",
    "tp_rules_for",
    "seq_parallel_forward",
    "fit_parameter_averaging",
]

"""Serving: micro-batcher, the row engine, the step and whole-sequence
schedulers with the step scheduler's governance policies, their backends,
the memory ledger, the HTTP transport."""

from euromillioner_tpu_torch.serve.continuous import (
    MIGRATE_VERSION, PagingPolicy, PreemptPolicy, RecurrentBackend,
    StepScheduler, WholeSequenceScheduler, load_recurrent_backend,
    make_sequence_engine, unpack_migration)
from euromillioner_tpu_torch.serve.engine import (InferenceEngine,
                                                  make_row_engine)
from euromillioner_tpu_torch.serve.session import (BudgetPolicy,
                                                   MemoryLedger, NNBackend,
                                                   load_backend)

__all__ = ["BudgetPolicy", "InferenceEngine", "MIGRATE_VERSION",
           "MemoryLedger", "NNBackend", "PagingPolicy", "PreemptPolicy",
           "RecurrentBackend", "StepScheduler", "WholeSequenceScheduler",
           "load_backend", "load_recurrent_backend", "make_row_engine",
           "make_sequence_engine", "unpack_migration"]

"""Sequence serving: micro-batcher, whole-sequence scheduler, transport."""

from euromillioner_tpu_torch.serve.continuous import (
    RecurrentBackend, WholeSequenceScheduler, load_recurrent_backend,
    make_sequence_engine)

__all__ = ["RecurrentBackend", "WholeSequenceScheduler",
           "load_recurrent_backend", "make_sequence_engine"]

"""Serving: micro-batcher, the row engine and the whole-sequence
scheduler, their backends, transport."""

from euromillioner_tpu_torch.serve.continuous import (
    RecurrentBackend, WholeSequenceScheduler, load_recurrent_backend,
    make_sequence_engine)
from euromillioner_tpu_torch.serve.engine import (InferenceEngine,
                                                  make_row_engine)
from euromillioner_tpu_torch.serve.session import NNBackend, load_backend

__all__ = ["InferenceEngine", "NNBackend", "RecurrentBackend",
           "WholeSequenceScheduler", "load_backend", "load_recurrent_backend",
           "make_row_engine", "make_sequence_engine"]

"""Serving: micro-batcher, the row engine, the step and whole-sequence
schedulers, their backends, the HTTP transport."""

from euromillioner_tpu_torch.serve.continuous import (
    RecurrentBackend, StepScheduler, WholeSequenceScheduler,
    load_recurrent_backend, make_sequence_engine)
from euromillioner_tpu_torch.serve.engine import (InferenceEngine,
                                                  make_row_engine)
from euromillioner_tpu_torch.serve.session import NNBackend, load_backend

__all__ = ["InferenceEngine", "NNBackend", "RecurrentBackend",
           "StepScheduler", "WholeSequenceScheduler", "load_backend",
           "load_recurrent_backend", "make_row_engine",
           "make_sequence_engine"]

"""Serving: micro-batcher, the row engine, the step and whole-sequence
schedulers with the step scheduler's governance policies, their backends,
the serving mesh (``build_serving_mesh``, ``ModelSession``), the memory
ledger, the HTTP transport, and the fleet above them (hosts with health
probing, the router, versioned rollout, the supervisor)."""

from euromillioner_tpu_torch.serve.continuous import (
    MIGRATE_VERSION, PagingPolicy, PreemptPolicy, RecurrentBackend,
    StepScheduler, WholeSequenceScheduler, load_recurrent_backend,
    make_sequence_engine, unpack_migration)
from euromillioner_tpu_torch.serve.engine import (InferenceEngine,
                                                  make_row_engine)
from euromillioner_tpu_torch.serve.fleet import (FleetHost, HttpServeHost,
                                                 ProbePolicy, parse_probe)
from euromillioner_tpu_torch.serve.rollout import (RolloutEngine,
                                                   RolloutGates)
from euromillioner_tpu_torch.serve.router import FleetRouter
from euromillioner_tpu_torch.serve.session import (BudgetPolicy,
                                                   MemoryLedger, ModelSession,
                                                   NNBackend,
                                                   build_serving_mesh,
                                                   load_backend)
from euromillioner_tpu_torch.serve.supervisor import (FleetSupervisor,
                                                      SupervisorPolicy,
                                                      policy_from_config)

__all__ = ["BudgetPolicy", "FleetHost", "FleetRouter", "FleetSupervisor",
           "HttpServeHost", "InferenceEngine", "MIGRATE_VERSION",
           "MemoryLedger", "ModelSession", "NNBackend", "PagingPolicy", "PreemptPolicy",
           "ProbePolicy", "RecurrentBackend", "RolloutEngine",
           "RolloutGates", "StepScheduler", "SupervisorPolicy",
           "WholeSequenceScheduler", "build_serving_mesh", "load_backend",
           "load_recurrent_backend", "make_row_engine",
           "make_sequence_engine", "parse_probe", "policy_from_config",
           "unpack_migration"]

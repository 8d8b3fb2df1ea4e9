"""Shared by the benchmark's tests: every cell at a size the CPU runs in
seconds, through the same paths (the kernels' plain versions)."""

import time

TINY = {
    "lstm.train.b2048": {"config": {"hidden": 16, "seq_len": 8},
                         "traffic": {"batch": 16}},
    "widedeep.train.b8192": {"config": {"wide_embed_dim": 8, "embed_dim": 8,
                                        "hidden_sizes": [16]},
                             "traffic": {"batch": 64}},
    "lstm.serve.p95": {"config": {"hidden": 16},
                       "traffic": {"rate_per_s": 100, "lengths": [3, 20]}},
}


def tiny_run(workload: str, seed: int = 12345678901, seconds: float = 0.5,
             trace: bool = False) -> dict:
    """One run of a cell at its tiny size on the CPU."""
    from perfbench import harness

    ctx = harness.make_context(workload, seed, seconds, trace, device="cpu",
                               overrides=TINY[workload], pending=True)
    return harness.run_cell(ctx, time.perf_counter())

"""Parameter-averaging training (the JAX package's ``dist/param_avg.py``):
DL4J-Spark's default ``ParameterAveragingTrainingMaster``.

Each worker fits locally for ``sync_every`` minibatches, then the float
leaves of the parameters and of the optimizer state are averaged over the
workers; integer leaves (step counters) advance alike on every worker and
pass through. There the whole round is one compiled program over the
mesh; here each worker is a rank of the data-parallel group, runs its
local steps through a plain ``Trainer`` (no per-step all-reduce), and one
all-reduce averages the state.

Worker ``w`` takes batches ``[w·K, (w+1)·K)`` of each round of ``W·K``
batches, and the epoch's batch list is cycled to a whole number of
rounds, as there. The epoch's shuffle seed comes from the port's
``epoch_seeds(seed, epoch)`` (``jax.random`` draws cannot be matched), so
a parity run against the JAX package uses ``shuffle=False``.
"""

from __future__ import annotations

from itertools import cycle, islice

import numpy as np
import torch

from euromillioner_tpu_torch.core.mesh import Mesh
from euromillioner_tpu_torch.data.dataset import Dataset
from euromillioner_tpu_torch.dist.collectives import (leaves, pmean_stacked,
                                                      rebuild)
from euromillioner_tpu_torch.train.trainer import (Trainer, TrainState,
                                                   epoch_seeds)
from euromillioner_tpu_torch.utils.errors import DistributedError, TrainError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("dist.param_avg")


def _pmean_floats(tree, mesh: Mesh):
    """Float leaves averaged over the workers (``pmean_stacked``); integer
    leaves pass through."""
    ts = leaves(tree)
    means = iter(pmean_stacked([t for t in ts if t.is_floating_point()],
                               mesh))
    return rebuild(tree, iter(next(means) if t.is_floating_point() else t
                              for t in ts))


def fit_parameter_averaging(trainer: Trainer, state: TrainState,
                            train_ds: Dataset, *, mesh: Mesh, epochs: int,
                            batch_size: int, sync_every: int = 4,
                            seed: int = 0, shuffle: bool = True
                            ) -> TrainState:
    """Train with per-worker local steps + periodic parameter averaging.

    ``batch_size`` is per worker. Each sync round consumes ``W *
    sync_every`` batches (the dataset is cycled to fill the final round).
    Every rank returns the same averaged state."""
    n_workers = mesh.data
    if n_workers < 1:
        raise DistributedError("mesh has no data axis")
    if len(train_ds) == 0:
        raise TrainError("training dataset is empty")
    per_round = n_workers * sync_every
    loss = torch.zeros(())
    for epoch in range(epochs):
        shuffle_seed, dropout_seed = epoch_seeds(seed, epoch)
        generator = torch.Generator(device=trainer.device).manual_seed(
            int(np.random.SeedSequence([dropout_seed, mesh.rank])
                .generate_state(1)[0]))
        batches = list(train_ds.batches(batch_size, shuffle=shuffle,
                                        seed=shuffle_seed))
        n_rounds = -(-len(batches) // per_round)
        batches = list(islice(cycle(batches), n_rounds * per_round))
        for r in range(n_rounds):
            start = r * per_round + mesh.rank * sync_every
            losses = []
            for batch in batches[start:start + sync_every]:
                state, step_loss = trainer.train_step(
                    state, trainer._place(batch), generator)
                losses.append(step_loss)
            # one all-reduce averages the state and the round's loss
            params, opt_state, loss = _pmean_floats(
                (state.params, state.opt_state, torch.stack(losses).mean()),
                mesh)
            state = TrainState(params=params, opt_state=opt_state,
                               step=state.step)
        if mesh.rank == 0:
            logger.info("param-avg epoch %d: loss=%.6f", epoch, float(loss))
    return state

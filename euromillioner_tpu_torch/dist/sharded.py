"""Data-parallel trainer (the JAX package's ``dist/sharded.py``; its data
axis only).

The replacement for DL4J-Spark's ``SharedTrainingMaster`` (BASELINE.json
config 4). There one ``jax.jit`` of the ordinary step over a batch
sharded on the mesh's ``data`` axis lets XLA insert the gradient
all-reduce. Here each rank is a process with its own device: rank ``r``
of ``W`` takes rows ``[r·B/W, (r+1)·B/W)`` of every global batch (the
layout ``P(data)`` gives, which parameter averaging relies on), computes
its share of the loss and its gradients, and one all-reduce of a flat
float32 bucket sums the gradients and the loss. Every rank then applies
the same optimizer update, so the parameters stay bit-identical across
ranks.

The loss is the masked sum over the global batch over the global count
of real rows: the last batch's mask-0 padding all lands on the last rank,
so a mean of the ranks' means would weigh it wrongly. Each rank divides
its masked sum by the global count (known on the host from the batch's
mask), and the all-reduce adds the shares. Gradients stay in the
parameters' dtype (float32) while they are reduced, whatever the compute
dtype.

Evaluation is sharded the same way (the JAX ``_place_eval`` layout): each
rank predicts its rows of every chunk and the metric's shares are
all-reduced, so every rank logs the same watch values. Only rank 0 logs
and writes ``metrics_jsonl``. The SIGTERM stop flag is all-reduced at
each epoch boundary so every rank stops together; checkpoints are saved
by every rank of the mesh's group (``train/checkpoint.py``'s
multi-process layout).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from euromillioner_tpu_torch.core.device import upload
from euromillioner_tpu_torch.core.mesh import AXIS_DATA, Mesh
from euromillioner_tpu_torch.data.dataset import Batch, Dataset
from euromillioner_tpu_torch.dist.collectives import (all_reduce_grads,
                                                      broadcast_tree,
                                                      gather_rows)
from euromillioner_tpu_torch.train.metrics import METRICS
from euromillioner_tpu_torch.train.trainer import Trainer, TrainState
from euromillioner_tpu_torch.utils.errors import DistributedError


@dataclass
class ShardBatch(Batch):
    """One rank's rows of a global batch, and the global batch's count of
    real rows (the loss normaliser), a float32 scalar on the device."""

    mask_total: Any = None


def _check_divisible(batch_size: int, mesh: Mesh, what: str) -> None:
    if batch_size % mesh.data:
        raise DistributedError(
            f"{what} {batch_size} not divisible by {AXIS_DATA}-axis size "
            f"{mesh.data}")


def place_batch(batch: Batch, mesh: Mesh) -> ShardBatch:
    """This rank's rows of a host batch on ``mesh.device`` (pinned and
    non-blocking on the card), with the whole batch's row count."""
    b = batch.x.shape[0]
    _check_divisible(b, mesh, "batch size")
    share = b // mesh.data
    rows = slice(mesh.rank * share, (mesh.rank + 1) * share)
    total = np.float32(np.asarray(batch.mask, np.float32).sum())
    return ShardBatch(
        x=upload(batch.x[rows], mesh.device),
        y=upload(batch.y[rows], mesh.device),
        mask=upload(batch.mask[rows], mesh.device),
        mask_total=torch.tensor(total, device=mesh.device))


class _Quiet:
    """A logger for ranks > 0: fit() says nothing there."""

    def info(self, *args, **kw) -> None:
        pass

    warning = info


# metrics that are a function of a masked mean: (the mean, the function)
_OF_MEAN = {"rmse": ("mse", torch.sqrt)}


class DistributedTrainer(Trainer):
    """Trainer over a data-parallel mesh: the same public API as
    ``Trainer``, the model on ``mesh.device``."""

    def __init__(self, *args, mesh: Mesh, **kw):
        if mesh.rank != 0:
            kw["metrics_jsonl"] = None
        super().__init__(*args, **kw)
        if self.device.type != mesh.device.type:
            raise DistributedError(
                f"the model is on {self.device}, the mesh on {mesh.device}")
        self.mesh = mesh
        self._group = mesh.group
        if mesh.rank != 0:
            self._logger = _Quiet()

    def init_state(self, params=None) -> TrainState:
        """The state as rank 0 initialises it, on every rank."""
        state = super().init_state(params)
        return TrainState(params=broadcast_tree(state.params, self.mesh),
                          opt_state=state.opt_state, step=state.step)

    # -- hooks ------------------------------------------------------------
    def _place(self, batch: Batch) -> ShardBatch:
        return place_batch(batch, self.mesh)

    def _mask_total(self, batch: ShardBatch):
        return batch.mask_total

    def _reduce(self, grads, loss):
        grads, (loss,) = all_reduce_grads(grads, self.mesh, loss)
        return grads, loss

    def _agree(self, flag: bool) -> bool:
        t = torch.tensor([int(flag)], dtype=torch.int32,
                         device=self.mesh.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return bool(t.item())

    def _metric(self, metric: str, pred, y, mask, n_rows: int):
        mean, then = _OF_MEAN.get(metric, (metric, None))
        total = torch.tensor(float(n_rows), device=self.mesh.device)
        share = METRICS[mean](pred, y, mask, mask_total=total)
        dist.all_reduce(share, group=self.mesh.group)
        return then(share) if then is not None else share

    # -- public API ---------------------------------------------------------
    def fit(self, state, train_ds: Dataset, *, batch_size: int, **kw):
        _check_divisible(batch_size, self.mesh, "global batch_size")
        return super().fit(state, train_ds, batch_size=batch_size, **kw)

    def evaluate(self, params, ds: Dataset, batch_size: int = 512,
                 metric: str | None = None) -> dict[str, float]:
        _check_divisible(batch_size, self.mesh, "evaluate batch_size")
        return super().evaluate(params, ds, batch_size, metric)

    def predict(self, params, ds: Dataset, batch_size: int = 512
                ) -> np.ndarray:
        """Predictions for every row, on every rank: each rank predicts its
        rows of each batch, and the rows are gathered in rank order."""
        _check_divisible(batch_size, self.mesh, "predict batch_size")
        outs = []
        for batch in ds.batches(batch_size):
            local = self._place(batch)
            pred = self._predict(params, local.x)
            pred = gather_rows(pred.reshape(pred.shape[0], -1), self.mesh)
            pred = pred.reshape(batch_size, -1).cpu().numpy()
            outs.append(pred[batch.mask.astype(bool)])
        return np.concatenate(outs, axis=0)

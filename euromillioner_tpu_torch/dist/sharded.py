"""Distributed trainer: data, tensor and sequence parallelism (the JAX
package's ``dist/sharded.py``).

The replacement for DL4J-Spark's ``SharedTrainingMaster`` (BASELINE.json
config 4). There one ``jax.jit`` of the ordinary step over a mesh lets
XLA insert the collectives from sharding annotations. Here each rank is a
process with its own device (``core/mesh.py``), and the collectives are
explicit:

* **data**: rank ``r`` of the data axis takes rows ``[r·B/D, (r+1)·B/D)``
  of every global batch (the layout ``P(data)`` gives, which parameter
  averaging relies on), and one all-reduce of a flat float32 bucket sums
  the gradients and the loss. Every rank then applies the same optimizer
  update.
* **model** (tensor parallelism): parameters and the optimizer state are
  placed per rule (:data:`GENERIC_TP_RULES`, or the model's own
  ``sharding_rules``; ``core.mesh.shard_params``): each rank holds its
  shard. A model with its own ``tp_apply`` (Wide&Deep) runs its layers on
  the shards with partial products and all-reduces; any other gathers a
  layer's shards once per forward and computes the rest alike on every
  rank of the model group (the LSTM: K1 and K2 on the whole weights).
  Either way each rank keeps only its shard's gradient, and gradients are
  summed over the data axis only.
* **seq** (sequence parallelism, ``shard_sequence``): rank ``k`` of the
  seq axis takes the ``k``-th time chunk, and the LSTM layers run the
  pipelined chunk scan of ``dist/seq_parallel.py`` over the seq group.
  The flagship's last LSTM returns only its final step, which lives on
  the last seq rank: that rank broadcasts it within the seq group before
  the head. Every seq rank computes the head and ``1/seq`` of the loss,
  and gradients are summed over the data and seq axes.

The loss is the masked sum over the global batch over the global count
of real rows: the last batch's mask-0 padding all lands on the last data
rank, so a mean of the ranks' means would weigh it wrongly. Each rank
divides its masked sum by the global count (known on the host from the
batch's mask), and the all-reduce adds the shares. Gradients stay in the
parameters' dtype (float32) while they are reduced, whatever the compute
dtype.

Evaluation is sharded the same way (the JAX ``_place_eval`` layout): each
rank predicts its rows of every chunk and the metric's shares are
all-reduced over the data axis, so every rank logs the same watch values.
Only rank 0 logs and writes ``metrics_jsonl``. The SIGTERM stop flag is
all-reduced at each epoch boundary so every rank stops together.
Checkpoints hold the global leaves under the JAX leaf names and shapes
(:meth:`DistributedTrainer.global_state`), written by every rank of the
mesh's group (``train/checkpoint.py``'s multi-process layout);
:meth:`DistributedTrainer.restore_state` reads one back onto the mesh,
each rank taking its shard.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from euromillioner_tpu_torch.core.device import upload
from euromillioner_tpu_torch.core.mesh import (AXIS_DATA, AXIS_MODEL, Mesh,
                                               P, model_dims, shard_params,
                                               shard_specs)
from euromillioner_tpu_torch.data.dataset import Batch, Dataset
from euromillioner_tpu_torch.dist.collectives import (RankComm,
                                                      all_reduce_grads,
                                                      broadcast_from,
                                                      broadcast_tree,
                                                      gather_rows,
                                                      model_gather)
from euromillioner_tpu_torch.train.metrics import METRICS
from euromillioner_tpu_torch.train.trainer import Trainer, TrainState
from euromillioner_tpu_torch.utils.errors import DistributedError

# Generic tensor-parallel rules (core.mesh.shard_params semantics: substring
# of the param path → candidate PartitionSpecs, first that divides wins;
# non-divisible leaves fall back to replicated). Dense kernels try
# column-parallel first, then row-parallel. Models with their own layout
# override via ``sharding_rules()``.
GENERIC_TP_RULES: tuple[tuple[str, Any], ...] = (
    ("wx", P(None, AXIS_MODEL)),       # LSTM input projection (F, 4H)
    ("wh", P(None, AXIS_MODEL)),       # LSTM recurrent weights (H, 4H)
    ("kernel", (P(None, AXIS_MODEL),   # Dense (in, units): column-parallel,
                P(AXIS_MODEL, None))),  # row-parallel fallback
    ("table", P(AXIS_MODEL, None)),    # Embedding vocab dim
)


def tp_rules_for(model) -> Sequence[tuple[str, Any]]:
    """Model's own sharding rules when it defines them, generic otherwise."""
    rules = getattr(model, "sharding_rules", None)
    return rules() if callable(rules) else GENERIC_TP_RULES


@dataclass
class ShardBatch(Batch):
    """One rank's rows (and time chunk) of a global batch, and the global
    batch's count of real rows (the loss normaliser), a float32 scalar on
    the device."""

    mask_total: Any = None


def _check_divisible(batch_size: int, mesh: Mesh, what: str) -> None:
    if batch_size % mesh.data:
        raise DistributedError(
            f"{what} {batch_size} not divisible by {AXIS_DATA}-axis size "
            f"{mesh.data}")


def place_batch(batch: Batch, mesh: Mesh, seq_axis: int | None = None
                ) -> ShardBatch:
    """This rank's rows of a host batch on ``mesh.device`` (pinned and
    non-blocking on the card), with the whole batch's row count; with
    ``seq_axis``, x's time dim is cut too and this rank keeps its seq
    chunk (only x has a time dim)."""
    b = batch.x.shape[0]
    _check_divisible(b, mesh, "batch size")
    share = b // mesh.data
    rows = slice(mesh.rank * share, (mesh.rank + 1) * share)
    x = batch.x[rows]
    if seq_axis is not None and batch.x.ndim >= seq_axis + 2:
        t = x.shape[seq_axis]
        if t % mesh.seq:
            raise DistributedError(
                f"sequence length {t} not divisible by seq axis {mesh.seq}")
        width = t // mesh.seq
        x = np.take(x, np.arange(mesh.seq_rank * width,
                                 (mesh.seq_rank + 1) * width), axis=seq_axis)
    total = np.float32(np.asarray(batch.mask, np.float32).sum())
    return ShardBatch(
        x=upload(x, mesh.device),
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
    """Trainer over a mesh: the same public API as ``Trainer``, the model
    on ``mesh.device``. ``tp_rules`` places the parameters over ``model``
    (default: :func:`tp_rules_for`); ``shard_sequence`` cuts x's time dim
    over ``seq`` and runs the LSTM layers through the pipelined chunk
    scan, in ``n_micro`` microbatches (default: the seq axis size)."""

    def __init__(self, *args, mesh: Mesh,
                 tp_rules: Sequence[tuple[str, Any]] | None = None,
                 shard_sequence: bool = False, n_micro: int = 0, **kw):
        if mesh.rank != 0 or mesh.model_rank != 0 or mesh.seq_rank != 0:
            kw["metrics_jsonl"] = None
        super().__init__(*args, **kw)
        if self.device.type != mesh.device.type:
            raise DistributedError(
                f"the model is on {self.device}, the mesh on {mesh.device}")
        self.mesh = mesh
        self.tp_rules = tuple(tp_rules if tp_rules is not None
                              else tp_rules_for(self.model))
        # Sequence-parallel: shard the time dim of [B, T, F] inputs over
        # ``seq``. Only x has a time dim.
        self.seq_axis = 1 if shard_sequence else None
        self._sp = bool(shard_sequence) and mesh.seq > 1
        self._tp = mesh.model > 1
        self.n_micro = int(n_micro) or mesh.seq
        if self._sp:
            from euromillioner_tpu_torch.dist.seq_parallel import \
                check_sequence_model

            check_sequence_model(mesh, self.model, last_step=True)
        # gradients sum over the ranks that hold the same model shard and
        # saw different data: the data axis, and the seq axis under SP
        self._grad_mesh = dataclasses.replace(
            mesh, group=mesh.replica_group if self._sp else mesh.group)
        whole_mesh = self._tp or mesh.seq > 1
        self._group = None if whole_mesh else mesh.group
        self._agree_group = None if whole_mesh else mesh.group
        # the placement of the params and the optimizer state, from the
        # global shapes (shard_state)
        self._specs: tuple = ({}, {})
        self._dims: dict[str, int | None] = {}
        if mesh.rank != 0 or mesh.model_rank != 0 or mesh.seq_rank != 0:
            self._logger = _Quiet()

    # -- state ------------------------------------------------------------
    def init_state(self, params=None) -> TrainState:
        """The state as global rank 0 initialises it, each rank holding
        its shard of every leaf the rules split (the optimizer state
        mirrors the params, so the same rules place it)."""
        state = super().init_state(params)
        world = dataclasses.replace(self.mesh, group=None)
        full = broadcast_tree(state.params, world)
        return self.shard_state(TrainState(
            params=full, opt_state=self.optimizer.init(full),
            step=state.step))

    def shard_state(self, state: TrainState) -> TrainState:
        """A state of global leaves → this rank's shards of it."""
        if not self._tp:
            return state
        self._specs = (shard_specs(state.params, self.mesh, self.tp_rules),
                       shard_specs(state.opt_state, self.mesh,
                                   self.tp_rules))
        self._dims = model_dims(self._specs[0])
        return TrainState(
            params=shard_params(state.params, self.mesh, self.tp_rules),
            opt_state=shard_params(state.opt_state, self.mesh,
                                   self.tp_rules),
            step=state.step)

    def global_state(self, state: TrainState) -> TrainState:
        """Every sharded leaf of ``state`` joined whole (a collective over
        the model group: every rank calls it); the state itself when
        nothing is sharded."""
        if not self._tp:
            return state

        def join(tree, specs):
            return _map2(tree, specs, lambda leaf, spec: (
                model_gather(leaf, self.mesh, _split_dim(spec))
                if _split_dim(spec) is not None else leaf))

        with torch.no_grad():
            return TrainState(params=join(state.params, self._specs[0]),
                              opt_state=join(state.opt_state,
                                             self._specs[1]),
                              step=state.step)

    def restore_state(self, path: str, like: TrainState) -> TrainState:
        """The TrainState of the checkpoint at ``path`` (global leaves, of
        either package) onto this mesh, each rank holding its shard;
        ``like`` is a state of this trainer (``init_state``)."""
        from euromillioner_tpu_torch.train.checkpoint import load_train_state

        full = load_train_state(path, self.global_state(like),
                                group=self._group)
        return self.shard_state(full)

    def _saved_state(self, state: TrainState) -> TrainState:
        return self.global_state(state)

    # -- hooks ------------------------------------------------------------
    def _place(self, batch: Batch) -> ShardBatch:
        placed = place_batch(batch, self.mesh,
                             self.seq_axis if self._sp else None)
        if self._sp and placed.x.shape[0] % self.n_micro:
            raise DistributedError(
                f"batch {batch.x.shape[0]} must divide by data axis x "
                f"microbatches ({self.mesh.data} x {self.n_micro})")
        return placed

    def _mask_total(self, batch: ShardBatch):
        # under SP every seq rank computes the loss: each takes 1/seq of it
        if self._sp:
            return batch.mask_total * self.mesh.seq
        return batch.mask_total

    def _apply(self, params, x, *, train: bool, generator=None):
        if self._sp:
            return self._seq_apply(params, x, train, generator)
        if not self._tp:
            return super()._apply(params, x, train=train,
                                  generator=generator)
        tp = getattr(self.model, "tp_apply", None)
        if tp is not None:
            return tp([params], [x], RankComm(self.mesh), self._dims,
                      train=train, generator=generator)[0]
        return functional_call(self.model, self._whole(params), (x,),
                               {"train": train, "generator": generator})

    def _whole(self, params: dict) -> dict:
        """Each split leaf joined whole (its gradient back to the
        shard)."""
        if not self._tp:
            return params
        return {k: (v if self._dims.get(k) is None
                    else model_gather(v, self.mesh, self._dims[k]))
                for k, v in params.items()}

    def _seq_apply(self, params, x, train, generator):
        """The flagship on this rank's time chunk: each LSTM through the
        pipelined chunk scan, the last one's final step broadcast from the
        last seq rank, the head on it."""
        from euromillioner_tpu_torch.dist.seq_parallel import \
            pipelined_layer
        from euromillioner_tpu_torch.nn.recurrent import LSTM

        full = self._whole(params)
        h = x
        for name, layer in self.model.named_layers():
            sub = {k[len(name) + 1:]: v for k, v in full.items()
                   if k.startswith(name + ".")}
            if isinstance(layer, LSTM):
                h = pipelined_layer(layer, sub, h, self.mesh, self.n_micro)
                if not layer.return_sequences:
                    h = broadcast_from(h[:, -1], self.mesh,
                                       src=self.mesh.seq - 1)
            else:
                h = functional_call(layer, sub, (h,),
                                    {"train": train, "generator": generator})
        return h

    def _reduce(self, grads, loss):
        m = self._grad_mesh
        if m.data == 1 and not self._sp and (self._tp or m.seq > 1):
            return grads, loss  # a group of one: nothing to add
        grads, (loss,) = all_reduce_grads(grads, m, loss)
        return grads, loss

    def _agree(self, flag: bool) -> bool:
        t = torch.tensor([int(flag)], dtype=torch.int32,
                         device=self.mesh.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._agree_group)
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


def _split_dim(spec) -> int | None:
    for dim, entry in enumerate(spec):
        if entry:
            return dim
    return None


def _map2(tree, specs, fn):
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _map2(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(v, s, fn) for v, s in zip(tree, specs))
    return fn(tree, specs)

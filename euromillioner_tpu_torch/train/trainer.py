"""Trainer: the train step and the epoch loop with named watch lists (the
JAX package's ``train/trainer.py``).

The model supplies the architecture; a :class:`TrainState` holds the
parameters (``{name: tensor}`` under the ``state_dict`` names), the
optimizer state and the step count, and every step returns a new one.
The step runs the model through ``torch.func.functional_call`` on the
state's parameters, so the LSTM layers' ``fused`` setting decides whether
the recurrence runs the K1+K2 autograd Function or the scan. After each
epoch one xgboost-style line is logged for all watches
(``[epoch]\ttrain-rmse:...\ttest-rmse:...``).

Per-epoch randomness: the JAX package derives it from
``jax.random.fold_in(rng, epoch)``, which torch cannot reproduce. Here
epoch ``e`` of a fit with seed ``s`` draws its shuffle seed and its dropout
generator's seed from ``np.random.SeedSequence([s, e])`` (:func:`epoch_seeds`)
— so, as there, epoch ``e`` replays identically whether it is reached in
one run or after a restore at an earlier epoch boundary. With
``shuffle=False`` and no dropout (the flagship) a fit is deterministic and
the two packages train on the same batches in the same order.
"""

from __future__ import annotations

import signal
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch.func import functional_call

from euromillioner_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from euromillioner_tpu_torch.core.prefetch import DoubleBuffer
from euromillioner_tpu_torch.data.dataset import Batch, Dataset
from euromillioner_tpu_torch.nn import losses as L
from euromillioner_tpu_torch.nn.module import Module
from euromillioner_tpu_torch.resilience import fault_point
from euromillioner_tpu_torch.train.metrics import METRICS, eval_line
from euromillioner_tpu_torch.train.optim import Optimizer, apply_updates
from euromillioner_tpu_torch.utils.errors import TrainError
from euromillioner_tpu_torch.utils.logging_utils import (JsonlMetricsWriter,
                                                         get_logger)
from euromillioner_tpu_torch.utils.profiling import StepTimer, trace

logger = get_logger("train.trainer")

# training losses (logit/raw inputs) and the matching default watch metric
# and prediction transform (xgboost's objective → eval default analog)
_LOSSES: dict[str, tuple[Callable, str, Callable]] = {
    "mse": (L.mse, "rmse", lambda z: z),
    "bce": (L.sigmoid_binary_cross_entropy, "logloss", torch.sigmoid),
}


def epoch_seeds(seed: int, epoch: int) -> tuple[int, int]:
    """(shuffle seed, dropout generator seed) of one epoch — a function of
    ``(seed, epoch)`` alone."""
    a, b = np.random.SeedSequence([seed, epoch]).generate_state(2)
    return int(a) & 0x7FFFFFFF, int(b)


@dataclass
class TrainState:
    params: dict[str, torch.Tensor]
    opt_state: Any
    step: torch.Tensor  # int32 scalar: optimizer updates so far


class Trainer:
    def __init__(self, model: Module, optimizer: Optimizer, loss: str = "mse",
                 precision: Precision = DEFAULT_PRECISION,
                 eval_metric: str | None = None,
                 metrics_jsonl: str | None = None):
        if loss not in _LOSSES:
            raise TrainError(f"unknown loss {loss!r} ({sorted(_LOSSES)})")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn, default_metric, self.pred_transform = _LOSSES[loss]
        self.eval_metric = eval_metric or default_metric
        if self.eval_metric not in METRICS:
            raise TrainError(f"unknown eval_metric {self.eval_metric!r}")
        self.precision = precision
        self.device = next(model.parameters()).device
        self._jsonl = JsonlMetricsWriter(metrics_jsonl) if metrics_jsonl else None
        # where fit() logs (the data-parallel trainer silences ranks > 0)
        self._logger = logger
        # the process group fit()'s checkpoints are saved over (None: the
        # default group; the data-parallel trainer's is its mesh's)
        self._group = None
        # SIGTERM protocol: the handler only sets this flag; the epoch loop
        # checkpoints and stops at the next epoch boundary. `preempted`
        # reports whether the last fit() ended early.
        self._preempt_requested = False
        self.preempted = False

    # -- hooks the data-parallel trainer (dist/sharded.py) overrides -----
    def _place(self, batch: Batch) -> Batch:
        """Host batch → device tensors (pinned and non-blocking on CUDA, so
        the copy overlaps the step in flight)."""
        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)
        return Batch(x=put(batch.x), y=put(batch.y), mask=put(batch.mask))

    def _mask_total(self, batch: Batch):
        """The loss normaliser's row count: None, the placed batch's own
        ``sum(mask)``."""
        return None

    def _reduce(self, grads, loss):
        """The step's gradients and loss as the update sees them."""
        return grads, loss

    def _agree(self, flag: bool) -> bool:
        """A host decision every process takes alike (the epoch
        boundary's stop flag)."""
        return flag

    def _metric(self, metric: str, pred, y, mask, n_rows: int):
        """A watch metric over the placed predictions of all
        ``n_rows`` rows."""
        return METRICS[metric](pred, y, mask)

    def _saved_state(self, state: TrainState) -> TrainState:
        """The state a checkpoint holds (a sharded trainer's joins its
        leaves whole)."""
        return state

    def save_checkpoint(self, directory: str, state: TrainState, *,
                        step: int) -> str:
        """Write ``state`` as ``directory/step_{step:08d}/`` (every process
        of this trainer's group calls it); returns the path."""
        from euromillioner_tpu_torch.train.checkpoint import save_checkpoint

        return save_checkpoint(directory, self._saved_state(state),
                               step=step, group=self._group)

    # -- state ----------------------------------------------------------
    def init_state(self, params: Mapping[str, torch.Tensor] | None = None
                   ) -> TrainState:
        """A fresh state from ``params`` (a ``state_dict``; default: the
        model's own, as its generator drew them), cast to the param dtype,
        on the model's device."""
        own = dict(self.model.named_parameters())
        src = dict(params) if params is not None else own
        if set(src) != set(own):
            raise TrainError(
                f"params {sorted(set(src) ^ set(own))} do not match the "
                f"model's parameters")
        placed = {k: v.detach().to(device=self.device,
                                   dtype=self.precision.param_dtype).clone()
                  for k, v in src.items()}
        return TrainState(params=placed, opt_state=self.optimizer.init(placed),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=self.device))

    # -- step -----------------------------------------------------------
    def _apply(self, params, x, *, train: bool, generator=None):
        return functional_call(self.model, params, (x,),
                               {"train": train, "generator": generator})

    def _cast_x(self, x):
        # Models reading categorical ids from float inputs opt out of the
        # input cast (WideDeep.cast_inputs) and cast after the lookup.
        if getattr(self.model, "cast_inputs", True):
            return x.to(self.precision.compute_dtype)
        return x

    def _loss(self, params, batch: Batch, generator):
        x = self._cast_x(batch.x)
        pred = self._apply(params, x, train=True, generator=generator)
        pred = pred.to(torch.float32)
        y = batch.y
        if pred.dim() == y.dim() + 1 and pred.shape[-1] == 1:
            pred = pred[..., 0]
        return self.loss_fn(pred, y, batch.mask,
                            mask_total=self._mask_total(batch))

    def train_step(self, state: TrainState, batch: Batch,
                   generator: torch.Generator | None = None
                   ) -> tuple[TrainState, torch.Tensor]:
        """One update on a placed batch (the JAX package's ``_step``):
        loss and gradients, optimizer update, step + 1. Returns the new
        state and the loss (a device scalar)."""
        params = {k: v.detach().requires_grad_()
                  for k, v in state.params.items()}
        loss = self._loss(params, batch, generator)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        grads, loss = self._reduce(grads, loss.detach())
        with torch.no_grad():
            params = {k: v.detach() for k, v in params.items()}
            updates, opt_state = self.optimizer.update(grads, state.opt_state,
                                                       params)
            params = apply_updates(params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    def _predict(self, params, x):
        """Transformed float32 predictions (the JAX package's ``_eval``):
        sigmoid probabilities under ``bce``, raw outputs under ``mse``."""
        with torch.no_grad():
            return self.pred_transform(self._apply(
                params, self._cast_x(x), train=False).to(torch.float32))

    # -- public API ------------------------------------------------------
    def fit(self, state: TrainState, train_ds: Dataset, *, epochs: int,
            batch_size: int, watches: Mapping[str, Dataset] | None = None,
            seed: int = 0, shuffle: bool = True, log_every: int = 1,
            checkpoint_dir: str | None = None, checkpoint_every: int = 0,
            start_epoch: int = 0, profile_dir: str | None = None
            ) -> TrainState:
        """Run epochs ``start_epoch..epochs-1``; after each, log one
        xgboost-style line over all ``watches``. ``profile_dir`` writes a
        ``torch.profiler`` trace of the whole fit there (host and device
        activity; utils/profiling.py ``trace``). A SIGTERM during fit()
        (main thread only) checkpoints at the next epoch boundary (when
        ``checkpoint_dir`` is set) and returns early with
        ``self.preempted = True``; a non-finite epoch loss raises
        ``TrainError`` before that epoch is checkpointed or evaluated.
        ``checkpoint_every`` saves every that many epochs."""
        if len(train_ds) == 0:
            raise TrainError("training dataset is empty")
        t0 = time.perf_counter()
        sync = torch.cuda.synchronize if self.device.type == "cuda" else None
        timer = StepTimer(sync=sync)
        timer.tick()
        self.preempted = False
        self._preempt_requested = False
        handler_installed = False
        prev_handler: Any = None
        if threading.current_thread() is threading.main_thread():
            def _on_sigterm(signum, frame):
                self._logger.warning(
                    "SIGTERM received: checkpoint-and-exit at next epoch boundary")
                self._preempt_requested = True

            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
            handler_installed = True
        try:
            with trace(profile_dir):
                state, seen = self._run_epochs(
                    state, train_ds, epochs, batch_size, watches, seed,
                    shuffle, log_every, checkpoint_dir, checkpoint_every,
                    start_epoch, timer)
        finally:
            if handler_installed:
                # None means a C-level handler was installed, which Python
                # cannot re-install: fall back to the default
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None
                              else signal.SIG_DFL)
        dt = time.perf_counter() - t0
        stats = timer.summary()
        self._logger.info(
            "fit done: %d epochs, %d examples, %.2fs (%.0f ex/s; "
            "steady-state %.2f ms/step)",
            epochs, seen, dt, seen / max(dt, 1e-9),
            stats.get("mean_step_ms", float("nan")))
        if self._jsonl and stats.get("steps"):
            self._jsonl.write({"event": "fit_summary", **stats})
        return state

    def _staged(self, batches):
        """``(real rows, placed batch)`` pairs, each next batch's copy
        enqueued before the current one is handed out."""
        window = DoubleBuffer(depth=1)
        for batch in batches:
            ready = window.push((int(batch.mask.sum()), self._place(batch)))
            if ready is not None:
                yield ready
        yield from window.drain()

    def _run_epochs(self, state, train_ds, epochs, batch_size, watches, seed,
                    shuffle, log_every, checkpoint_dir, checkpoint_every,
                    start_epoch, timer):
        seen = 0
        for epoch in range(start_epoch, epochs):
            shuffle_seed, dropout_seed = epoch_seeds(seed, epoch)
            generator = torch.Generator(device=self.device).manual_seed(dropout_seed)
            batches = train_ds.batches(batch_size, shuffle=shuffle,
                                       seed=shuffle_seed)
            loss = torch.zeros(())
            for i, (n, batch) in enumerate(self._staged(batches)):
                fault_point("train.step", epoch=epoch, batch=i)
                state, loss = self.train_step(state, batch, generator)
                seen += n
                timer.tick(n)
            fault_point("train.epoch_end", epoch=epoch)
            if not np.isfinite(float(loss)):
                raise TrainError(f"non-finite training loss at epoch {epoch}")
            if watches and (epoch % log_every == 0 or epoch == epochs - 1):
                results = {name: self.evaluate(state.params, ds, batch_size)
                           for name, ds in watches.items()}
                self._logger.info(eval_line(epoch, results))
                if self._jsonl:
                    self._jsonl.write({"round": epoch, **{
                        f"{w}-{m}": v for w, ms in results.items()
                        for m, v in ms.items()}})
            # read the flag once per boundary, so the save and the stop
            # agree on it (and every process of a group with them)
            preempt = self._agree(self._preempt_requested)
            periodic = (checkpoint_dir and checkpoint_every
                        and (epoch + 1) % checkpoint_every == 0)
            if periodic or (checkpoint_dir and preempt):
                self.save_checkpoint(checkpoint_dir, state, step=epoch + 1)
            if preempt:
                self.preempted = True
                self._logger.warning(
                    "preempted: stopping after epoch %d (%s)", epoch,
                    "checkpoint saved" if checkpoint_dir
                    else "no checkpoint_dir — state returned unsaved")
                break
            # eval/checkpoint time is not step time
            timer.reset()
        return state, seen

    def _chunks(self, ds: Dataset, batch_size: int):
        """The dataset in ``batch_size``-row chunks, the last zero-padded
        under mask 0 (the JAX package's fused-evaluate layout)."""
        n = len(ds)
        for start in range(0, n, batch_size):
            take = min(batch_size, n - start)
            x = np.zeros((batch_size, *ds.x.shape[1:]), np.float32)
            y = np.zeros((batch_size, *ds.y.shape[1:]), np.float32)
            mask = np.zeros(batch_size, np.float32)
            x[:take] = ds.x[start:start + take]
            y[:take] = ds.y[start:start + take]
            mask[:take] = 1.0
            yield Batch(x=x, y=y, mask=mask)

    def evaluate(self, params, ds: Dataset, batch_size: int = 512,
                 metric: str | None = None) -> dict[str, float]:
        """The metric over the whole dataset (xgboost evaluates watches on
        the whole set), one forward per ``batch_size`` chunk and one host
        read per call."""
        metric = metric or self.eval_metric
        if metric not in METRICS:
            raise TrainError(f"unknown eval_metric {metric!r}")
        if len(ds) == 0:
            raise TrainError("cannot evaluate an empty dataset")
        preds, ys, masks = [], [], []
        for _, batch in self._staged(self._chunks(ds, batch_size)):
            pred = self._predict(params, batch.x)
            preds.append(pred.reshape(pred.shape[0], -1))
            ys.append(batch.y.reshape(batch.y.shape[0], -1))
            masks.append(batch.mask)
        value = self._metric(metric, torch.cat(preds), torch.cat(ys),
                             torch.cat(masks), len(ds))
        return {metric: float(value)}

    def predict(self, params, ds: Dataset, batch_size: int = 512) -> np.ndarray:
        """Predictions for every row (``Booster.predict``), (N, out)."""
        outs = []
        for _, batch in self._staged(ds.batches(batch_size)):
            pred = self._predict(params, batch.x)
            pred = pred.reshape(pred.shape[0], -1).cpu().numpy()
            outs.append(pred[batch.mask.cpu().numpy().astype(bool)])
        return np.concatenate(outs, axis=0)


def check_predicts(first: np.ndarray, second: np.ndarray,
                   *, atol: float | None = None) -> bool:
    """``Main.checkPredicts``: shape check + row-wise equality;
    ``atol=None`` compares exactly, a float allows that tolerance."""
    first = np.asarray(first)
    second = np.asarray(second)
    if first.shape != second.shape:
        return False
    if atol is None:
        return bool(np.all(first == second))
    return bool(np.allclose(first, second, atol=atol))

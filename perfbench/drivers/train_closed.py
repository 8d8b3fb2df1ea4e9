"""Closed-loop training: one ``Trainer.train_step`` after another, each on
a fresh batch of the seeded pool placed on the card inside the window.

Set-up builds the step object once (model, trainer, Adam state) on the
benchmark's weights and drives it through its first three steps with the
window's own call and feed, on three different batches; the window goes
on from the state they leave. Those three steps are what the reference
follows: their losses, the first gradient as Adam's state holds it after
step one, and the parameters after step three.

End to end: the examples a second (the metric the traffic file names in
``rate_metric``): every example of every step the window enqueued, over
the time from its first enqueue to the card's finish of its last.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench.harness import load_part
from perfbench.yardstick import compare
from perfbench.yardstick.lowp import ROUNDINGS

FIRST_STEPS = 3


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


class Driver:
    def __init__(self, ctx):
        from euromillioner_tpu_torch.core.precision import Precision
        from euromillioner_tpu_torch.data.dataset import Batch
        from euromillioner_tpu_torch.train.optim import adam
        from euromillioner_tpu_torch.train.trainer import Trainer

        self.ctx = ctx
        cfg, tr = ctx.config, ctx.config["train"]
        t0 = time.perf_counter()
        self.fam = load_part("families", cfg["family"])
        if ctx.device == "cuda":
            self.fam.kernels(cfg, "train")
        t1 = time.perf_counter()
        model = self.fam.build_model(cfg, ctx.device)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        self.params0 = self.fam.weights(cfg, shapes, ctx.seed, ctx.device)
        self.trainer = Trainer(
            model, adam(tr["learning_rate"]), loss=tr["loss"],
            precision=Precision(
                compute_dtype=self.fam.DTYPES[tr["compute_dtype"]]))
        self.pool = self.fam.batches(cfg, ctx.traffic, ctx.seed)
        self.mask = np.ones(ctx.traffic["batch"], np.float32)
        self._batch = Batch
        t2 = time.perf_counter()
        state = self.trainer.init_state(self.params0)
        losses = []
        for i in range(FIRST_STEPS):
            state, loss = self.step(state, i)
            losses.append(loss)
            if i == 0:
                self.mu1 = state.opt_state["mu"]
        self.losses = [float(v) for v in losses]
        self.params3 = state.params
        self.state = state
        self.next = FIRST_STEPS
        _sync(ctx.device)
        self.setup_parts = {"kernels": t1 - t0, "model_weights_pool": t2 - t1,
                            "first_steps": time.perf_counter() - t2}

    def step(self, state, i: int):
        """The window's unit: place pool batch ``i`` and train on it."""
        x, y = self.pool[i % len(self.pool)]
        placed = self.trainer._place(self._batch(x=x, y=y, mask=self.mask))
        return self.trainer.train_step(state, placed)

    def window(self, seconds: float) -> dict:
        ctx = self.ctx
        steps, host_s, used, stamps = 0, 0.0, [], []
        _sync(ctx.device)
        with ctx.window_span():
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while True:
                a = time.perf_counter()
                self.state, _ = self.step(self.state, self.next)
                b = time.perf_counter()
                host_s += b - a
                stamps.append(b - t0)
                used.append(self.next % len(self.pool))
                steps += 1
                self.next += 1
                if b >= deadline:
                    break
            _sync(ctx.device)
            t1 = time.perf_counter()
        samples = steps * ctx.traffic["batch"]
        per_second = np.bincount(np.array(stamps, int)).tolist()
        return {"notes": {"setup_parts_s": self.setup_parts,
                          "enqueued_per_second": per_second},
                "t_window": t0, "window_s": t1 - t0, "attempted": steps,
                "failed": 0, "steps": steps, "samples": samples,
                "host_s": host_s, "pool_used": used,
                "end_to_end": {
                    ctx.traffic["rate_metric"]: samples / (t1 - t0)}}

    def readings(self) -> dict:
        """The program's readings of its first three steps."""
        return {"losses": self.losses, "mu": self.mu1,
                "params0": self.params0, "params3": self.params3}

    def reference(self, rounding: str | None = None) -> dict:
        """The reference's three steps from the same weights and batches
        (under a control's rounding when given)."""
        from perfbench.reference.train import train_steps

        ctx = self.ctx
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        q = ROUNDINGS[rounding] if rounding else (lambda t: t)
        fwd = self.fam.reference(ctx.config, q)
        dev = ctx.device
        feed = [(torch.as_tensor(x, device=dev),
                 torch.as_tensor(y, device=dev))
                for x, y in self.pool[:FIRST_STEPS]]
        losses, grads, params3 = train_steps(
            fwd, self.params0, feed, ctx.config["train"]["learning_rate"])
        return {"losses": losses, "grads": grads, "params3": params3}

    def release(self) -> None:
        """Free the program's state; keep what it produced."""
        self.state = self.trainer = None
        gc.collect()
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        self.release()
        got = compare.training(self.readings(), self.reference())
        self.leaves = got.pop("_leaves")
        return got

    def control(self, rounding: str) -> dict:
        """The control's numbers: the reference under ``rounding`` put in
        the program's place."""
        self.release()
        low = self.reference(rounding)
        prog = {"losses": low["losses"], "params0": self.params0,
                "params3": low["params3"],
                "mu": {k: (1 - compare.B1) * g
                       for k, g in low["grads"].items()}}
        got = compare.training(prog, self.reference())
        self.leaves = got.pop("_leaves")
        return got

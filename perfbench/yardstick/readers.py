"""What the per-layer metric readers under ``metrics/`` share. Each
returns None where the run holds nothing to read, never 0 for a share."""

from __future__ import annotations

from perfbench.harness import load_part
from perfbench.yardstick import counts
from perfbench.yardstick.peaks import peak_flops


def host_ms_per_step(ctx):
    """The trainer layer's host time for ``Trainer.train_step`` to return
    (its enqueue), ms a step, averaged over the window. Near the step
    time, the card sets the pace; well under it, the host runs ahead."""
    w = ctx.work
    return 1e3 * w["host_s"] / w["steps"] if w.get("steps") else None


def batch_rows(ctx):
    """The batch scheduler's mean real rows per dispatched micro-batch
    over the window, from its own ``stats()`` counters (sequences /
    batches)."""
    w = ctx.work
    if not w.get("window_batches"):
        return None
    return w["window_sequences"] / w["window_batches"]


def idle_pct(ctx):
    """The share of the traced window with nothing on the device, %."""
    dt = ctx.device_trace
    if dt is None or dt.window_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s / dt.window_s)


def mfu_train_pct(ctx):
    """The model operations of every example the window trained, over
    the window, over the compute dtype's peak, %."""
    w = ctx.work
    if not w.get("samples"):
        return None
    fam = load_part("families", ctx.config["family"])
    flops = w["samples"] * fam.train_flops_per_sample(ctx.config)
    dtype = ctx.config["train"]["compute_dtype"]
    return 100.0 * flops / w["window_s"] / peak_flops(dtype)


def mfu_serve_pct(ctx):
    """The model operations of the window's batches, counted over the
    padded rows and timesteps K1 ran (rows bucket x time bucket), over
    the window, over the f32 peak outside the tensor cores, %."""
    recs = ctx.work.get("batch_records")
    if not recs:
        return None
    cfg = ctx.config
    flops = sum(r["rows_bucket"]
                * counts.lstm_flops_per_example(cfg, r["time_bucket"])
                for r in recs)
    return 100.0 * flops / ctx.work["window_s"] / peak_flops("float32")


def roofline_pct(ctx, patterns, calls_pattern, least_s):
    """A kernel's least possible time over its measured device time in
    the traced window, %. ``least_s(calls)`` is the least time of the
    ``calls`` launches the trace shows (events holding
    ``calls_pattern``)."""
    dt = ctx.device_trace
    if dt is None:
        return None
    seconds, _ = dt.device_seconds(patterns)
    _, calls = dt.device_seconds([calls_pattern])
    if seconds <= 0 or calls == 0:
        return None
    least = least_s(calls)
    return None if least is None else 100.0 * least / seconds

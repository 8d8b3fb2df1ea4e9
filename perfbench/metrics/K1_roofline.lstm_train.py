"""K1 (``lstm_fwd_kernel``, with its residuals) in training: its least
possible time over its device time in the traced window, %."""

from perfbench.yardstick import counts
from perfbench.yardstick.readers import roofline_pct


def read(ctx):
    cfg, b = ctx.config, ctx.traffic["batch"]
    dtype = cfg["train"]["compute_dtype"]
    one = counts.least_seconds(*counts.k1_call(
        dtype, b, cfg["seq_len"], cfg["hidden"], residuals=True), dtype)
    return roofline_pct(ctx, ["lstm_fwd_kernel"], "lstm_fwd_kernel",
                        lambda calls: calls * one)

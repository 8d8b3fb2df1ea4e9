"""K2 (``lstm_bwd_kernel`` with its ``dwh`` product, reduction and
dpeep kernels) in training: its least possible time over its device time
in the traced window, %."""

from perfbench.yardstick import counts
from perfbench.yardstick.readers import roofline_pct

KERNELS = ["lstm_bwd_kernel", "dwh_wgmma_kernel", "dwh_simt_kernel",
           "dwh_reduce_kernel", "dpeep_kernel"]


def read(ctx):
    cfg, b = ctx.config, ctx.traffic["batch"]
    dtype = cfg["train"]["compute_dtype"]
    one = counts.least_seconds(*counts.k2_call(
        dtype, b, cfg["seq_len"], cfg["hidden"]), dtype)
    return roofline_pct(ctx, KERNELS, "lstm_bwd_kernel",
                        lambda calls: calls * one)

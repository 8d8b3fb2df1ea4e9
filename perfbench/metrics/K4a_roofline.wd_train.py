"""K4a (``wide_fwd_kernel``) in training: its least possible time over
its device time in the traced window, %. The least time depends on the
distinct table rows each batch names, so it is summed over the window's
batches."""

from perfbench.yardstick.readers import roofline_pct
from perfbench.yardstick.wide_bounds import k4_least_s


def read(ctx):
    return roofline_pct(ctx, ["wide_fwd_kernel"], "wide_fwd_kernel",
                        lambda calls: k4_least_s(ctx, calls, 0))

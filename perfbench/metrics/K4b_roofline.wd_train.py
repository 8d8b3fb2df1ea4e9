"""K4b (the counting sort's ``wide_dw_count_kernel`` and
``wide_dw_place_kernel`` and the row writer ``wide_dw_write_kernel``) in
training: its least possible time over its device time in the traced
window, %, summed over the window's batches."""

from perfbench.yardstick.readers import roofline_pct
from perfbench.yardstick.wide_bounds import k4_least_s

KERNELS = ["wide_dw_count_kernel", "wide_dw_place_kernel",
           "wide_dw_write_kernel"]


def read(ctx):
    return roofline_pct(ctx, KERNELS, "wide_dw_write_kernel",
                        lambda calls: k4_least_s(ctx, calls, 1))

"""K1 (``lstm_fwd_kernel``, f32, no residuals) while serving: its least
possible time over its device time in the traced window, %, summed over
the window's batches at each batch's (rows bucket, time bucket): the
mean least time of a launch over the window's batches, times the
launches the trace shows (a batch in flight at either edge of the window
counts by its launches)."""

from perfbench.yardstick import counts
from perfbench.yardstick.readers import roofline_pct


def read(ctx):
    cfg = ctx.config
    recs = ctx.work.get("batch_records") or []

    def least(calls):
        if not recs:
            return None
        per_launch = [counts.least_seconds(*counts.k1_call(
            "float32", r["rows_bucket"], r["time_bucket"], cfg["hidden"],
            residuals=False), "float32") for r in recs]
        return calls * sum(per_launch) / len(per_launch)
    return roofline_pct(ctx, ["lstm_fwd_kernel"], "lstm_fwd_kernel", least)

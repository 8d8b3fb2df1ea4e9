"""K4a's and K4b's least possible times over a training window's
batches: each batch's from its own pair ids (``counts.k4_calls``)."""

from __future__ import annotations

from perfbench.harness import load_part
from perfbench.yardstick import counts


def k4_least_s(ctx, calls: int, which: int):
    """The least time of ``calls`` launches of K4a (``which`` 0) or K4b
    (1): the mean over the window's batches, times the launches."""
    used = ctx.work.get("pool_used")
    if not used:
        return None
    cfg = ctx.config
    fam = load_part("families", cfg["family"])
    pool = fam.batches(cfg, ctx.traffic, ctx.seed)
    least = {}
    for i in set(used):
        ids = fam.pair_ids(pool[i][0], cfg["ball_vocab"])
        nbytes, adds = counts.k4_calls(ids, cfg["ball_vocab"] ** 2,
                                       cfg["wide_embed_dim"],
                                       cfg["train"]["compute_dtype"])[which]
        least[i] = counts.least_seconds(nbytes, adds, "float32")
    return calls * sum(least[i] for i in used) / len(used)

"""The numbers that decide ``correct``.

Training (the first three steps of the timed step object against the
reference's three steps from the same weights and batches):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: over the leaves, the largest gap between the program's
  and the reference's norm of the first gradient, over the larger of the
  reference leaf's norm and the median leaf's. The program's gradient is
  read from Adam's state after one step (``mu / (1 - b1)``);
- ``change_gap``: the same measure of each leaf's change after three
  steps. Leaves whose reference gradient is under a thousandth of the
  median leaf's are left out: Adam moves them by round-off alone;
- ``grad_gap_median``: the median leaf's gap of first-gradient norms,
  steadier from seed to seed than the worst leaf's.

A cell compares the numbers its limits file lists.

Serving: ``reply_gap``, the largest gap between a reply and the
reference's output for the same history, over the largest reference
output of the sample.
"""

from __future__ import annotations

import statistics

import torch

B1 = 0.9
QUIET_GRAD = 1e-3


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def norm_gaps(got: dict, want: dict, keep=None) -> dict:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's, over the leaves in ``keep`` (all when None)."""
    g, w = _norms(got), _norms(want)
    keys = [k for k in w if keep is None or k in keep]
    median = statistics.median(w[k] for k in keys)
    return {k: abs(g[k] - w[k]) / max(w[k], median, 1e-30) for k in keys}


def training(prog: dict, ref: dict) -> dict:
    """The three numbers from the program's readings ``prog`` (losses,
    first-step ``mu``, ``params0``, ``params3``) and the reference's
    (losses, first gradients ``grads``, ``params3``)."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    grads = {k: (m.double() / (1 - B1)) for k, m in prog["mu"].items()}
    grad_gaps = norm_gaps(grads, ref["grads"])
    ref_norms = _norms(ref["grads"])
    median = statistics.median(ref_norms.values())
    moved = {k for k, n in ref_norms.items() if n >= QUIET_GRAD * median}
    p0 = prog["params0"]
    change = {k: prog["params3"][k].double() - p0[k].double() for k in p0}
    want = {k: ref["params3"][k].double() - p0[k].double() for k in p0}
    change_gaps = norm_gaps(change, want, keep=moved)
    return {"loss_gap": loss_gap, "grad_gap": max(grad_gaps.values()),
            "change_gap": max(change_gaps.values()),
            "grad_gap_median": statistics.median(grad_gaps.values()),
            "_leaves": {"grad_gap": grad_gaps, "change_gap": change_gaps,
                        "left_out": sorted(set(p0) - moved)}}


def replies(got, want) -> float:
    """``reply_gap`` of replies ``got`` against reference outputs
    ``want``, both (N, out)."""
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))

"""Tree growth on the device: histogram build, split finding, row routing
(the JAX package's ``trees/growth.py``, its exact CPU forms).

Level-wise growth: each level is a fixed sequence of tensor ops — the
per-level histogram (K3, ``ops/fused_histogram``), the cumulative split
scan, argmax and row re-routing — so the host loop never branches on
device data and nothing syncs mid-tree.

Trees live in complete-binary-tree array form (node i's children are
2i+1, 2i+2): ``feature``/``split_bin``/``is_leaf``/``leaf_value`` arrays of
length 2^(max_depth+1) - 1.

Summation order. The JAX package's CPU programs sum a histogram row and
scan it in XLA's order, not left to right: a sum over more than 32 values
pads them evenly on both sides to a multiple of 32, sums each block of 32
in order and then sums the block sums the same way; a cumulative sum scans
blocks of 16 in order and adds each block's exclusive prefix of block
totals (itself scanned the same way). :func:`ordered_sum` and
:func:`ordered_cumsum` repeat those orders, so trees grown here from the
same gradients are bit-equal to the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from euromillioner_tpu_torch.ops.fused_histogram import fused_histogram

_SUM_BLOCK = 32
_SCAN_BLOCK = 16


class LevelResult(NamedTuple):
    feature: torch.Tensor     # (n_nodes,) int32 — split feature (valid if !leaf)
    split_bin: torch.Tensor   # (n_nodes,) int32 — go right when bin > split_bin
    is_leaf: torch.Tensor     # (n_nodes,) bool
    leaf_value: torch.Tensor  # (n_nodes,) f32 — already eta-scaled
    node_id: torch.Tensor     # (N,) int32 — updated assignment
    grad_sum: torch.Tensor    # (n_nodes,) f32 — diagnostics
    hess_sum: torch.Tensor    # (n_nodes,) f32


def _sequential(x, running: bool):
    """Left-to-right sum (or running sums) over the last dim."""
    acc = torch.zeros_like(x[..., 0])
    out = []
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        out.append(acc)
    return torch.stack(out, dim=-1) if running else acc


def ordered_sum(x):
    """Sum over the last dim in the order of the JAX package's CPU
    reductions (see the module note)."""
    n = x.shape[-1]
    if n <= _SUM_BLOCK:
        return _sequential(x, running=False)
    pad = -n % _SUM_BLOCK
    x = F.pad(x, (pad // 2, pad - pad // 2))
    blocks = x.reshape(*x.shape[:-1], -1, _SUM_BLOCK)
    return ordered_sum(_sequential(blocks, running=False))


def ordered_cumsum(x):
    """Cumulative sum over the last dim in the order of the JAX package's
    CPU scans (see the module note)."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _sequential(x, running=True)
    pad = -n % _SCAN_BLOCK
    blocks = F.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, _SCAN_BLOCK)
    inner = _sequential(blocks, running=True)
    outer = ordered_cumsum(inner[..., -1])
    before = F.pad(outer[..., :-1], (1, 0))
    return (inner + before[..., None]).reshape(*x.shape[:-1], -1)[..., :n]


def node_histograms(binned, local, gw, hw, n_nodes: int, n_bins: int):
    """Per-(node, feature, bin) sums of ``gw`` and ``hw`` — each (n_nodes,
    F, n_bins) — through K3 (its plain version, the scatter, on the
    CPU)."""
    n, f = binned.shape
    hist = fused_histogram(binned, local, gw, hw, n_bins, n_nodes)
    hist = hist.view(f, n_nodes, 2, n_bins).permute(1, 0, 2, 3)
    return hist[:, :, 0], hist[:, :, 1]


def node_sums(local, gw, hw, n_nodes: int):
    """Per-node Σ gw and Σ hw without the per-(feature, bin) histogram —
    all a final level needs for leaf values. Exact f32 sums of masked
    values, in a fixed order on every device. ``local``, ``gw``, ``hw``:
    (..., N) → two (..., n_nodes)."""
    mask = local[..., None] == torch.arange(n_nodes, dtype=local.dtype,
                                            device=local.device)
    zero = torch.zeros((), dtype=gw.dtype, device=gw.device)
    return (torch.where(mask, gw[..., None], zero).sum(-2),
            torch.where(mask, hw[..., None], zero).sum(-2))


def split_gains(hist_g, hist_h, reg_lambda, gamma):
    """xgboost's exact gain of every (feature, bin) split candidate of
    each node, unmasked: ``(gain, hl, hr)``, each (n_nodes, F, bins).
    Split at bin b sends bins ≤ b left; gain = ½(GL²/(HL+λ) + GR²/(HR+λ)
    − G²/(H+λ)) − γ."""
    gl, hl = ordered_cumsum(torch.stack([hist_g, hist_h]))  # one scan
    g_tot = gl[..., -1:]
    h_tot = hl[..., -1:]
    gr = g_tot - gl
    hr = h_tot - hl
    parent = g_tot * g_tot / (h_tot + reg_lambda)
    gain = 0.5 * (gl * gl / (hl + reg_lambda) + gr * gr / (hr + reg_lambda)
                  - parent) - gamma
    return gain, hl, hr


def best_splits(hist_g, hist_h, reg_lambda, gamma, min_child_weight,
                feature_mask=None):
    """The best split of each node: ``(gain, feature, bin)``. Candidates
    failing min_child_weight are masked, and ties go to the first
    (feature, bin). ``feature_mask`` (F,) zeroes out features not in this
    tree's column sample (colsample_bytree)."""
    gain, hl, hr = split_gains(hist_g, hist_h, reg_lambda, gamma)
    # empty children are never valid splits (and with λ=0 their 0/0 gain
    # is NaN, which would win the argmax) — require mass on both sides
    ok = ((hl >= min_child_weight) & (hr >= min_child_weight)
          & (hl > 0) & (hr > 0))
    # last bin has an empty right child — never a valid split point
    ok[..., -1] = False
    if feature_mask is not None:
        ok = ok & (feature_mask[None, :, None] > 0)
    gain = torch.where(ok, gain, torch.full_like(gain, float("-inf")))
    n_nodes, _, b = gain.shape
    flat = gain.reshape(n_nodes, -1)
    best = torch.argmax(flat, dim=-1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    return (best_gain, torch.div(best, b, rounding_mode="floor").int(),
            (best % b).int())


def route_one_level(binned, node_id, feature, split_bin, is_leaf,
                    offset: int, n_nodes: int):
    """Advance every row one level: rows in a non-leaf node of the
    [offset, offset+n_nodes) level move to child 2i+1 (bin ≤ split) or
    2i+2 (bin > split); everything else stays. ``node_id`` (N,) with
    (n_nodes,) level tables for one tree, or (T, N) with (T, n_nodes)
    tables for T trees."""
    local = torch.clamp(node_id - offset, 0, n_nodes - 1).long()
    in_level = (node_id >= offset) & (node_id < offset + n_nodes)
    f_n, t_n, leaf_n = (a.gather(-1, local)
                        for a in (feature, split_bin, is_leaf))
    rows = f_n.long().reshape(-1, binned.shape[0])
    go_right = binned.t().gather(0, rows).reshape(f_n.shape) > t_n
    child = 2 * node_id + 1 + go_right.int()
    return torch.where(in_level & ~leaf_n, child, node_id)


def interleave_siblings(left, right, dim: int = 0):
    """Left/right child stats with ``half`` nodes on axis ``dim`` → 2·half
    nodes in local node order: full[2p] = left[p], full[2p+1] = right[p]."""
    shape = list(left.shape)
    shape[dim] *= 2
    return torch.stack([left, right], dim=dim + 1).reshape(shape)


def _level_rows(node_id, sampled, depth: int):
    """(n_nodes, offset, local node id of each row clipped to the level,
    weight = sampled and in this level)."""
    n_nodes = 1 << depth
    offset = n_nodes - 1
    local = node_id - offset
    in_level = (local >= 0) & (local < n_nodes)
    local = torch.clamp(local, 0, n_nodes - 1).int()
    return n_nodes, offset, local, sampled * in_level.float()


def _node_totals(hist_g, hist_h):
    """Per-node Σ grad and Σ hess: feature 0's histogram summed over its
    bins, as the JAX package sums it (both stats in one pass)."""
    return ordered_sum(torch.stack([hist_g[:, 0, :], hist_h[:, 0, :]]))


def _leaf_values(g_tot, h_tot, eta, reg_lambda):
    # dead nodes (no samples routed here) get value 0, not 0/0
    return torch.where(h_tot > 0, -eta * g_tot / (h_tot + reg_lambda),
                       torch.zeros_like(g_tot))


def grow_level(binned, node_id, sampled, grad, hess, *, depth: int,
               n_bins: int, final: bool, eta, reg_lambda, gamma,
               min_child_weight, feature_mask=None,
               final_sums: bool = False):
    """Grow one level of the tree (all 2^depth candidate nodes at once)
    from one full histogram.

    ``final=True`` turns every live node into a leaf (the max_depth
    frontier); its leaf values come from the same full histogram — the
    uniform formulation the JAX package's scatter path uses — unless
    ``final_sums`` asks for plain per-node sums (the sibling-subtraction
    path's final level). ``feature_mask`` restricts split candidates to
    the tree's column sample."""
    n_nodes, offset, local, weight = _level_rows(node_id, sampled, depth)
    gw, hw = grad * weight, hess * weight
    if final and final_sums:
        g_tot, h_tot = node_sums(local, gw, hw, n_nodes)
    else:
        hist_g, hist_h = node_histograms(binned, local, gw, hw, n_nodes,
                                         n_bins)
        g_tot, h_tot = _node_totals(hist_g, hist_h)
    if final:
        return LevelResult(
            torch.zeros(n_nodes, dtype=torch.int32, device=binned.device),
            torch.zeros(n_nodes, dtype=torch.int32, device=binned.device),
            torch.ones(n_nodes, dtype=torch.bool, device=binned.device),
            _leaf_values(g_tot, h_tot, eta, reg_lambda), node_id, g_tot,
            h_tot)
    return _finish_level(binned, node_id, hist_g, hist_h, g_tot, h_tot,
                         offset, n_nodes, eta, reg_lambda, gamma,
                         min_child_weight, feature_mask)


def _finish_level(binned, node_id, hist_g, hist_h, g_tot, h_tot, offset,
                  n_nodes, eta, reg_lambda, gamma, min_child_weight,
                  feature_mask):
    """Level-finishing semantics shared by the direct and
    sibling-subtraction paths: leaf values, split decision, and routing
    of every row (unsampled ones too — prediction covers all)."""
    best_gain, feature, split_bin = best_splits(
        hist_g, hist_h, reg_lambda, gamma, min_child_weight, feature_mask)
    is_leaf = ~(best_gain > 0.0)
    new_node_id = route_one_level(binned, node_id, feature, split_bin,
                                  is_leaf, offset, n_nodes)
    return LevelResult(feature, split_bin, is_leaf,
                       _leaf_values(g_tot, h_tot, eta, reg_lambda),
                       new_node_id, g_tot, h_tot)


def grow_level_sub(binned, node_id, sampled, grad, hess, parent_hists, *,
                   depth: int, n_bins: int, eta, reg_lambda, gamma,
                   min_child_weight, feature_mask=None):
    """``grow_level`` with sibling subtraction: build histograms for LEFT
    children only and derive each right child as parent − left, which
    halves the histogram's (node, stat) columns at every level ≥ 1.
    Returns ``(LevelResult, (hist_g, hist_h))``; the hists feed the next
    level's subtraction. ``parent_hists`` is the previous level's pair
    (None at depth 0, which computes directly).

    Rows whose parent went leaf never re-enter the level, so a right
    sibling of such a node inherits a phantom histogram — harmless,
    because routing only reaches a child through a non-leaf parent.
    Right-child sums differ from direct ones by f32 subtraction rounding.
    """
    n_nodes, offset, local, weight = _level_rows(node_id, sampled, depth)
    if depth == 0 or parent_hists is None:
        hist_g, hist_h = node_histograms(binned, local, grad * weight,
                                         hess * weight, n_nodes, n_bins)
    else:
        w_left = weight * (local % 2 == 0)
        gl, hl = node_histograms(binned, local >> 1, grad * w_left,
                                 hess * w_left, n_nodes // 2, n_bins)
        pg, ph = parent_hists
        hist_g = interleave_siblings(gl, pg - gl)
        hist_h = interleave_siblings(hl, ph - hl)
    g_tot, h_tot = _node_totals(hist_g, hist_h)
    return (_finish_level(binned, node_id, hist_g, hist_h, g_tot, h_tot,
                          offset, n_nodes, eta, reg_lambda, gamma,
                          min_child_weight, feature_mask),
            (hist_g, hist_h))


def route(binned, feature, split_bin, is_leaf, *, max_depth: int):
    """Leaf index of every row of ``binned`` in each tree. ``feature``,
    ``split_bin``, ``is_leaf``: (n_nodes,) for one tree → (N,), or
    (T, n_nodes) for T trees → (T, N); one read-and-descend step per
    depth level."""
    single = feature.dim() == 1
    if single:
        feature, split_bin, is_leaf = (feature[None], split_bin[None],
                                       is_leaf[None])
    n = binned.shape[0]
    binned_t = binned.t()
    node = torch.zeros((feature.shape[0], n), dtype=torch.int64,
                       device=binned.device)
    for _ in range(max_depth):
        f_n = feature.gather(1, node).long()
        t_n = split_bin.gather(1, node)
        leaf_n = is_leaf.gather(1, node)
        go_right = binned_t.gather(0, f_n) > t_n
        node = torch.where(leaf_n, node, 2 * node + 1 + go_right.long())
    return node[0] if single else node


def tree_leaf_values(binned, features, split_bins, is_leafs, leaf_values,
                     *, max_depth: int):
    """Each tree's leaf value for every row: (T, N) from stacked (T,
    n_nodes) tables — the routing and one gather, exact in any program
    (the part of a tree program the AOT store compiles)."""
    leaves = route(binned, features, split_bins, is_leafs,
                   max_depth=max_depth)
    return leaf_values.gather(1, leaves)


def add_leaf_values(margin, values):
    """``margin`` (N,) f32 plus each row of ``values`` (T, N), one add per
    tree in tree order, as the JAX package's scan over trees does — THE
    summation order of a margin."""
    for t in range(values.shape[0]):
        margin = margin + values[t]
    return margin


def accumulate_leaves(margin, binned, features, split_bins, is_leafs,
                      leaf_values, *, max_depth: int):
    """``margin`` (N,) f32 plus each tree's leaf value in tree order: the
    whole-ensemble program and the chunked one (trees/chunked.py) both run
    it (:func:`tree_leaf_values`, then :func:`add_leaf_values`)."""
    if features.shape[0] == 0:
        return margin
    return add_leaf_values(margin, tree_leaf_values(
        binned, features, split_bins, is_leafs, leaf_values,
        max_depth=max_depth))


def predict_margin(binned, features, split_bins, is_leafs, leaf_values,
                   base_margin: float, *, max_depth: int):
    """Ensemble margin over stacked tree arrays (T, n_nodes): every row
    starts at ``base_margin`` and adds each tree's leaf value in tree
    order (:func:`accumulate_leaves`)."""
    margin = torch.full((binned.shape[0],), base_margin, dtype=torch.float32,
                        device=binned.device)
    return accumulate_leaves(margin, binned, features, split_bins, is_leafs,
                             leaf_values, max_depth=max_depth)

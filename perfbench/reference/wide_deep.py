"""Wide&Deep (Cheng et al., 2016) over a featurized draw row: 4 date
fields (day of week, month, day, year), 5 balls and 2 stars.

- Wide: one table row per cross id, summed: 7 singles (each ball slot's
  value), 21 unordered slot pairs (``a * V + b``) and 7 day-of-week x
  slot crosses (``dow * V + b``), each family on its own slab of the
  stacked table; the sum times ``wide_proj`` plus ``wide_bias``.
- Deep: the 7 slots' rows of ``ball_embed`` and the 4 date fields' rows
  of ``field_embed.{i}`` (year modulo 64), concatenated, through dense
  layers with ReLU between them.
- Output: wide + deep.

Ids are the row's values truncated to integers and clipped to each
vocabulary. Leaves are float32, named as the configuration's file lists
them.
"""

from __future__ import annotations

import numpy as np
import torch

FIELD_VOCABS = (8, 13, 32, 64)
SLOTS, DATE_FIELDS, DOW_VOCAB = 7, 4, 8
PAIR_I, PAIR_J = np.triu_indices(SLOTS, k=1)


def _identity(t):
    return t


def cross_rows(x, vocab: int):
    """The stacked table's row of each cross, (B, 35) int64, and the
    slots' ids (B, 7)."""
    balls = torch.clamp(x[:, DATE_FIELDS:].to(torch.int64), 0, vocab - 1)
    dow = torch.clamp(x[:, 0].to(torch.int64), 0, DOW_VOCAB - 1)
    pi = torch.as_tensor(PAIR_I, device=x.device)
    pj = torch.as_tensor(PAIR_J, device=x.device)
    slot = torch.arange(SLOTS, device=x.device)
    pair_slot = torch.arange(len(PAIR_I), device=x.device)
    singles_end = SLOTS * vocab
    pairs_end = singles_end + len(PAIR_I) * vocab * vocab
    rows = torch.cat([
        balls + slot * vocab,
        singles_end + balls[:, pi] * vocab + balls[:, pj]
        + pair_slot * vocab * vocab,
        pairs_end + dow[:, None] * vocab + balls + slot * DOW_VOCAB * vocab,
    ], dim=1)
    return rows, balls


def forward(params: dict, x, vocab: int, deep_layers: int, q=_identity):
    """Outputs (B, out) float32 of rows ``x`` (B, 11)."""
    x = x.to(torch.float32)
    rows, balls = cross_rows(x, vocab)
    table = q(params["wide_table"])
    h = table[rows].sum(dim=1)                              # f32 sums
    wide = q(q(h) @ q(params["wide_proj"]) + q(params["wide_bias"]))
    raw = x[:, :DATE_FIELDS].to(torch.int64)
    raw = torch.cat([raw[:, :3], raw[:, 3:] % 64], dim=1)
    parts = [q(params["ball_embed"])[balls].reshape(x.shape[0], -1)]
    for i, v in enumerate(FIELD_VOCABS):
        parts.append(q(params[f"field_embed.{i}"])[
            torch.clamp(raw[:, i], 0, v - 1)])
    out = torch.cat(parts, dim=1)
    for n in range(deep_layers):
        k, b = params[f"deep.{n}_Dense.kernel"], params[f"deep.{n}_Dense.bias"]
        out = q(q(out) @ q(k) + q(b))
        if n < deep_layers - 1:
            out = torch.relu(out)
    return q(wide + out)

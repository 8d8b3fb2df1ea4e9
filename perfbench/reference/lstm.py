"""A stacked peephole LSTM (Gers and Schmidhuber's peepholes, as
Deeplearning4j's GravesLSTM): gates ordered i, f, g, o; i and f see the
previous cell, o sees the new one; the input projection ``x @ wx + bias``
of every step, then ``h @ wh``; the last layer's final step into a dense
head.

Leaves (float32, named as the configuration's file lists them):
``{l}_LSTM.wx (F, 4H)``, ``.wh (H, 4H)``, ``.bias (4H)``, ``.p_i``,
``.p_f``, ``.p_o (H)`` for each layer ``l``, then
``{L}_Dense.kernel (H, out)`` and ``.bias (out)``.
"""

from __future__ import annotations

import torch


def _identity(t):
    return t


def layer(params: dict, prefix: str, x, q=_identity):
    """One layer over ``x`` (B, T, F) → hs (B, T, H) in float32."""
    wx, wh, bias = (params[prefix + k] for k in ("wx", "wh", "bias"))
    p_i, p_f, p_o = (params[prefix + k] for k in ("p_i", "p_f", "p_o"))
    b, t, _ = x.shape
    hidden = wh.shape[0]
    proj = q(q(x).reshape(b * t, -1) @ q(wx) + q(bias)).reshape(b, t, -1)
    wh_q = q(wh)
    h = x.new_zeros((b, hidden))
    c = x.new_zeros((b, hidden))
    hs = []
    for s in range(t):
        gates = proj[:, s] + q(h) @ wh_q
        i, f, g, o = gates.split(hidden, dim=-1)
        i = torch.sigmoid(i + c * p_i)
        f = torch.sigmoid(f + c * p_f)
        c = f * c + i * torch.tanh(g)
        h = torch.sigmoid(o + c * p_o) * torch.tanh(c)
        hs.append(h)
    return q(torch.stack(hs, dim=1))


def forward(params: dict, x, layers: int, q=_identity, last=None):
    """The stack's outputs (B, out) float32 at each row's step ``last``
    (B,) (the final step when None)."""
    h = x.to(torch.float32)
    for n in range(layers):
        h = layer(params, f"{n}_LSTM.", h, q)
    rows = torch.arange(h.shape[0], device=h.device)
    idx = (torch.full((h.shape[0],), h.shape[1] - 1, device=h.device)
           if last is None else last.to(h.device))
    h_last = h[rows, idx]
    head = f"{layers}_Dense."
    return q(q(h_last) @ q(params[head + "kernel"])
             + q(params[head + "bias"]))

"""Open-loop arrivals and request sizes that are the same work for every
seed.

A Poisson process of rate ``r(t)`` is a unit-rate process mapped through
the inverse of the cumulative rate ``L(t) = integral of r``. Here the
unit-rate gaps are a fixed set, the exponential distribution's quantiles
at ``(i + 1/2) / n``, and the seed only shuffles them; the sizes are a
fixed set too (every length of the range in turn), shuffled by the seed
on its own stream. So every seed offers the same number of requests of
the same sizes over the same window, and only their order and their
clustering change. ``rate`` is a piecewise-constant curve, ``[[seconds,
per_s], ...]``, repeated over the window (one segment: a constant rate).
"""

from __future__ import annotations

import numpy as np


def _curve(segments):
    """(segment lengths, rates, start times, cumulative rate at each
    start, period, requests a period) of a repeated piecewise-constant
    rate."""
    lens = np.array([s for s, _ in segments], np.float64)
    rates = np.array([r for _, r in segments], np.float64)
    edges = np.concatenate([[0.0], np.cumsum(lens)])
    mass = np.concatenate([[0.0], np.cumsum(lens * rates)])
    return lens, rates, edges, mass, lens.sum(), float(mass[-1])


def _cumulative(segments, t: np.ndarray) -> np.ndarray:
    """``L(t)`` of the repeated piecewise-constant curve."""
    lens, rates, edges, mass, period, per_period = _curve(segments)
    whole, rem = np.divmod(t, period)
    seg = np.clip(np.searchsorted(edges, rem, side="right") - 1, 0,
                  len(lens) - 1)
    return whole * per_period + mass[seg] + (rem - edges[seg]) * rates[seg]


def _inverse(segments, u: np.ndarray) -> np.ndarray:
    """``L^-1(u)``: the time at which the cumulative rate reaches ``u``."""
    lens, rates, edges, mass, period, per_period = _curve(segments)
    whole, rem = np.divmod(u, per_period)
    seg = np.clip(np.searchsorted(mass, rem, side="right") - 1, 0,
                  len(lens) - 1)
    return whole * period + edges[seg] + (rem - mass[seg]) / rates[seg]


def schedule(seed: int, seconds: float, rate, sizes: tuple[int, int]
             ) -> tuple[np.ndarray, np.ndarray]:
    """(due offsets in seconds, sizes) of every request of a window of
    ``seconds``. ``rate`` is a number (requests a second) or segments;
    ``sizes`` the inclusive range of request sizes."""
    segments = [[1.0, float(rate)]] if np.isscalar(rate) else rate
    if any(s <= 0 or r <= 0 for s, r in segments):
        raise ValueError(f"rate segments must be positive, got {rate!r}")
    n = int(round(float(_cumulative(segments, np.array([seconds]))[0])))
    rng = np.random.default_rng(seed)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)      # Exp(1) quantiles
    gaps = gaps[rng.permutation(n)]
    u = np.cumsum(gaps) * (n / gaps.sum())           # exactly n by L(T)
    due = _inverse(segments, u)
    due = np.minimum(due, seconds)
    lo, hi = sizes
    span = np.arange(lo, hi + 1)
    size = np.resize(span, n)[np.random.default_rng([seed, 1]).permutation(n)]
    return due, size.astype(np.int64)

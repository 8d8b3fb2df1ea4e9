"""Operations and bytes of the model steps and the kernels, from shapes.

The kernels' least possible times follow ``chip_smoke.py``'s bound
arithmetic (``bf16_bounds``, ``k4_bound_ms``): each input byte read once,
each output byte written once, the products at the compute dtype's peak.
A kernel's least time is the larger of its operations over the peak and
its bytes over the HBM bandwidth.
"""

from __future__ import annotations

import numpy as np

from perfbench.yardstick.peaks import PEAK_HBM_BYTES_S, peak_flops

ITEMSIZE = {"bfloat16": 2, "float32": 4}


def least_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time of one kernel call: bytes or operations, whichever
    binds."""
    return max(nbytes / PEAK_HBM_BYTES_S, flops / peak_flops(dtype))


# -- the peephole LSTM -------------------------------------------------------

def lstm_flops_per_step(in_features: int, hidden: int, layers: int) -> int:
    """Forward multiply-adds x2 of one example's timestep through the
    stack: 2 (in + H) 4H a layer (the input projection and the
    recurrent product)."""
    total, width = 0, in_features
    for _ in range(layers):
        total += 2 * (width + hidden) * 4 * hidden
        width = hidden
    return total


def lstm_flops_per_example(cfg: dict, steps: int) -> int:
    """Forward operations of one example over ``steps`` timesteps, the
    head's product once."""
    return (steps * lstm_flops_per_step(cfg["in_features"], cfg["hidden"],
                                        cfg["layers"])
            + 2 * cfg["hidden"] * cfg["out_dim"])


def k1_call(dtype: str, batch: int, steps: int, hidden: int,
            residuals: bool) -> tuple[int, int]:
    """(bytes, operations) of one K1 call: x_proj in, wh in, hs out (and
    with residuals cs and the gates out), the f32 peepholes in; the
    recurrent product 2 T B H 4H."""
    it = ITEMSIZE[dtype]
    tbh = steps * batch * hidden
    wh = hidden * 4 * hidden
    elems = 4 * tbh + wh + tbh + (tbh + 4 * tbh if residuals else 0)
    return it * elems + 4 * 4 * hidden, 2 * steps * batch * hidden * 4 * hidden


def k2_call(dtype: str, batch: int, steps: int, hidden: int
            ) -> tuple[int, int]:
    """(bytes, operations) of one K2 call: g_hs, hs, cs and the gates in,
    dxp and dwh out, the f32 peepholes in and dpeep out; the dh carry's
    product and dwh's, 2 x 2 (T-1) B H 4H."""
    it = ITEMSIZE[dtype]
    tbh = steps * batch * hidden
    wh = hidden * 4 * hidden
    nbytes = it * (3 * tbh + 4 * tbh + wh + 4 * tbh + wh) + 2 * 4 * 4 * hidden
    return nbytes, 2 * 2 * (steps - 1) * batch * hidden * 4 * hidden


# -- Wide&Deep ----------------------------------------------------------------

def wide_deep_flops_per_row(cfg: dict) -> int:
    """Forward operations of one row: the deep tower's products and the
    wide projection's (the one-hot sums are adds, counted by the K4
    bounds)."""
    sizes = [11 * cfg["embed_dim"], *cfg["hidden_sizes"], cfg["out_dim"]]
    deep = sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return deep + 2 * cfg["wide_embed_dim"] * cfg["out_dim"]


def k4_calls(ids: np.ndarray, vocab: int, width: int, dtype: str
             ) -> tuple[tuple[int, int], tuple[int, int]]:
    """((bytes, adds) of K4a, (bytes, adds) of K4b) on one batch's pair
    ids (B, K) int: K4a reads the ids and the distinct table rows they
    name and writes (B, E) f32; K4b reads the ids and dH and writes the
    dense (K, V, E) block; one f32 add per valid id and element."""
    b, k = ids.shape
    it = ITEMSIZE[dtype]
    valid = (ids >= 0) & (ids < vocab)
    flat = (ids.astype(np.int64) + np.arange(k) * vocab)[valid]
    rows = int(np.unique(flat).size)
    adds = int(valid.sum()) * width
    fwd = 4 * b * k + rows * width * it + 4 * b * width
    dw = 4 * b * k + b * width * it + k * vocab * width * it
    return (fwd, adds), (dw, adds)

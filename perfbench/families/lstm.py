"""The stacked peephole LSTM: how the benchmark builds the program's model
from a configuration file, makes its weights and its batches from the
seed, and which reference computes it."""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import lstm as ref_lstm

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(cfg: dict, device: str):
    """The program's model at the configuration's sizes. Its own initial
    weights are drawn on ``device`` and replaced by :func:`weights`."""
    from euromillioner_tpu_torch.models.lstm import build_lstm

    with torch.device(device):
        gen = torch.Generator(device=device).manual_seed(0)
        return build_lstm(cfg["hidden"], cfg["layers"], cfg["out_dim"],
                          peepholes=cfg["peepholes"],
                          fused=cfg["train"]["fused"],
                          in_features=cfg["in_features"], generator=gen,
                          device=device)


def weights(cfg: dict, shapes: dict, seed: int, device: str) -> dict:
    """Float32 weights from ``seed``, made on ``device`` in one draw:
    products Glorot-normal, peepholes N(0, 0.01), biases 0 with the
    forget gate's at 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    h = cfg["hidden"]
    for name, shape in shapes.items():
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[1]
        if leaf in ("wx", "wh", "kernel"):
            w = z * math.sqrt(2.0 / (shape[0] + shape[1]))
        elif leaf.startswith("p_"):
            w = z * 0.01
        else:
            w = torch.zeros_like(z)
            if "LSTM" in name:
                w[h:2 * h] = 1.0
        out[name] = w.contiguous()
    return out


def batches(cfg: dict, traffic: dict, seed: int) -> list:
    """The pool of distinct training batches (x (B, T, F), y (B, out)) in
    host memory."""
    rng = np.random.default_rng([seed, 2])
    b, t = traffic["batch"], cfg["seq_len"]
    return [(rng.standard_normal((b, t, cfg["in_features"]), np.float32),
             rng.standard_normal((b, cfg["out_dim"]), np.float32))
            for _ in range(traffic["pool_batches"])]


def kernels(cfg: dict, use: str) -> None:
    """Build (or load from the checkout's cache) the kernels ``use``
    runs: training's K1/K2 in its compute dtype, serving's f32 K1."""
    from euromillioner_tpu_torch.ops import fused_lstm as K

    if use == "train":
        bf16 = cfg["train"]["compute_dtype"] == "bfloat16"
        (K.FUSED_LSTM_FWD_BF16 if bf16 else K.FUSED_LSTM_FWD).build()
        (K.FUSED_LSTM_BWD_BF16 if bf16 else K.FUSED_LSTM_BWD).build()
    else:
        K.FUSED_LSTM_FWD.build()


def reference(cfg: dict, q):
    """``forward(params, x)`` of the plain reference under rounding
    ``q``."""
    return lambda params, x: ref_lstm.forward(params, x, cfg["layers"], q)


def serve_reference(cfg: dict, q):
    """``forward(params, x, last)``: each row's output at its step
    ``last``."""
    return lambda params, x, last: ref_lstm.forward(params, x, cfg["layers"],
                                                    q, last=last)


def train_flops_per_sample(cfg: dict) -> int:
    """A training example's model operations: three times the forward's
    (the backward's two products for each of the forward's)."""
    from perfbench.yardstick.counts import lstm_flops_per_example

    return 3 * lstm_flops_per_example(cfg, cfg["seq_len"])

"""Wide&Deep over featurized draw rows: how the benchmark builds the
program's model from a configuration file, makes its weights and rows
from the seed, and which reference computes it."""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import wide_deep as ref_wd

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(cfg: dict, device: str):
    """The program's model at the configuration's sizes. Its own initial
    weights are drawn on ``device`` and replaced by :func:`weights`."""
    from euromillioner_tpu_torch.models.wide_deep import WideDeep

    with torch.device(device):
        gen = torch.Generator(device=device).manual_seed(0)
        return WideDeep(wide_embed_dim=cfg["wide_embed_dim"],
                        embed_dim=cfg["embed_dim"],
                        ball_vocab=cfg["ball_vocab"],
                        hidden_sizes=tuple(cfg["hidden_sizes"]),
                        out_dim=cfg["out_dim"],
                        compute_dtype=DTYPES[cfg["train"]["compute_dtype"]],
                        generator=gen, device=device)


def weights(cfg: dict, shapes: dict, seed: int, device: str) -> dict:
    """Float32 weights from ``seed``, made on ``device`` in one draw:
    tables and the wide projection N(0, 0.01), the deep kernels
    Glorot-normal, biases 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if name.endswith("bias"):
            w = torch.zeros_like(z)
        elif name.endswith("kernel"):
            w = z * math.sqrt(2.0 / (shape[0] + shape[1]))
        else:
            w = z * 0.01
        out[name] = w.contiguous()
    return out


def rows(rng, b: int) -> np.ndarray:
    """``b`` featurized draws: day of week 1-7, month 1-12, day 1-28, year
    2004-2020, five balls 1-50, two stars 1-12."""
    return np.concatenate([
        np.stack([rng.integers(1, 8, b), rng.integers(1, 13, b),
                  rng.integers(1, 29, b), rng.integers(2004, 2021, b)], 1),
        rng.integers(1, 51, size=(b, 5)), rng.integers(1, 13, size=(b, 2)),
    ], axis=1).astype(np.float32)


def batches(cfg: dict, traffic: dict, seed: int) -> list:
    """The pool of distinct training batches (x (B, 11), y (B, out)) in
    host memory."""
    rng = np.random.default_rng([seed, 2])
    b = traffic["batch"]
    return [(rows(rng, b),
             rng.standard_normal((b, cfg["out_dim"]), np.float32))
            for _ in range(traffic["pool_batches"])]


def pair_ids(x: np.ndarray, vocab: int) -> np.ndarray:
    """The 21 slot pairs' ids of rows ``x`` (B, 11), as the wide tower's
    one-hot kernels see them."""
    balls = np.clip(x[:, 4:].astype(np.int64), 0, vocab - 1)
    return balls[:, ref_wd.PAIR_I] * vocab + balls[:, ref_wd.PAIR_J]


def kernels(cfg: dict, use: str) -> None:
    from euromillioner_tpu_torch.ops import wide_onehot as K

    K.WIDE_ONEHOT_FWD.build()
    if use == "train":
        K.WIDE_ONEHOT_DW.build()


def reference(cfg: dict, q):
    layers = len(cfg["hidden_sizes"]) + 1
    return lambda params, x: ref_wd.forward(params, x, cfg["ball_vocab"],
                                            layers, q)


def train_flops_per_sample(cfg: dict) -> int:
    from perfbench.yardstick.counts import wide_deep_flops_per_row

    return 3 * wide_deep_flops_per_row(cfg)

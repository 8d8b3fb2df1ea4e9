#!/usr/bin/env python3
"""Wall times of the port's two tree trainers on one NVIDIA GPU, for the
checkout of the port at ``--root`` (by default this one), so that two
checkouts can be compared one after another on one card:

    python3 tree_walls.py --root OLD > old.json
    python3 tree_walls.py > new.json

Each run, in a process of its own, trains chip_smoke.py's two tree paths
as a user calls them, with chip_smoke.py's data recipes: the scaled GBT
(bench.py's GBT_SCALED: 200k x 28, depth 6, 60 rounds, binning outside the
timed runs) and the RF_SHAPE classifier (100k x 28, 20 trees, depth 8,
binning inside). Each is warmed up once, timed ``--runs`` times (wall
clock, synchronised), and run once more with CUDA events around every K3
launch. Then K3 alone at the launch-bound shapes (the reference
pipeline's levels, the 300-bin shape) and the scaled GBT's deepest level:
its median time per call between CUDA events, and the host's microseconds
per call (wrapper, allocation, launch) over calls issued without
synchronising. It prints one JSON line: the walls, their median, the rate,
K3's seconds and share of the median wall, K3's per-call times, and the
card's name and power limit. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def walls(run, runs: int) -> list[float]:
    """``run`` once untimed, then the wall seconds of ``runs`` runs."""
    import torch

    run()
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


# K3 alone: the reference pipeline's levels, the 300-bin shape and the
# scaled GBT's deepest level (chip_smoke.py's K3_SHAPES)
K3_CALL_SHAPES = tuple((1193, 10, 44, 1 << d) for d in range(4)) + (
    (50_000, 8, 300, 4), (200_000, 28, 256, 64))


def k3_calls(cs, K, calls: int = 200) -> dict:
    """K3's median ms per call (CUDA events, chip_smoke.time_ms) and the
    host's microseconds per call over ``calls`` calls issued back to back,
    at each K3_CALL_SHAPES shape."""
    import torch

    out = {}
    for n, f, n_bins, n_nodes in K3_CALL_SHAPES:
        binned, local, gw, hw = cs.k3_inputs(n, f, n_bins, n_nodes, 0)

        def call():
            return K.fused_histogram(binned, local, gw, hw, n_bins, n_nodes)

        ms = cs.time_ms(call, warmup=10, runs=100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        host_us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        out["x".join(map(str, (n, f, n_bins, n_nodes)))] = {
            "ms": ms, "host_us": host_us}
    return out


def summary(times: list[float], units: float, k3_ms: float) -> dict:
    wall = statistics.median(times)
    return {"walls_s": times, "median_s": wall, "per_s": units / wall,
            "k3_s": k3_ms / 1e3, "k3_share": k3_ms / 1e3 / wall}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=None,
                    help="checkout whose euromillioner_tpu_torch to run")
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    here = Path(__file__).resolve().parent
    root = (args.root or here).resolve()
    if not (root / "euromillioner_tpu_torch").is_dir():
        print(f"tree_walls: no euromillioner_tpu_torch/ under {root}",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("tree_walls: no CUDA device is available", file=sys.stderr)
        return 1
    # chip_smoke's recipes first, from this checkout; the port from --root
    sys.path.insert(0, str(here))
    import chip_smoke as cs

    sys.path.insert(0, str(root))
    import euromillioner_tpu_torch
    from euromillioner_tpu_torch.core.device import resolve_device
    from euromillioner_tpu_torch.ops import fused_histogram as K
    from euromillioner_tpu_torch.ops.fused_histogram import (
        FUSED_HISTOGRAM, FUSED_HISTOGRAM_SETS)
    from euromillioner_tpu_torch.trees import random_forest as rf
    from euromillioner_tpu_torch.trees import train

    resolve_device("cuda")
    loaded = Path(euromillioner_tpu_torch.__file__).resolve().parents[1]
    if loaded != root:
        print(f"tree_walls: imported the port from {loaded}, not {root}",
              file=sys.stderr)
        return 1

    dtrain = cs.scaled_data()
    dtrain.quantized(256)
    g = cs.SCALED
    params = {"objective": "binary:logistic", "eta": g["eta"],
              "max_depth": g["max_depth"], "gamma": g["gamma"],
              "device": "cuda"}

    def gbt():
        train(params, dtrain, g["rounds"], verbose_eval=False)

    gbt_times = walls(gbt, args.runs)
    gbt_k3 = cs.kernel_ms(FUSED_HISTOGRAM, gbt)

    x, y, _ = cs.rf_data()
    s = cs.RF_SHAPE

    def forest():
        rf.train_classifier(x, y, s["num_classes"], num_trees=s["trees"],
                            max_depth=s["max_depth"], max_bins=s["max_bins"],
                            seed=cs.RF_SEED, device="cuda")
        torch.cuda.synchronize()

    rf_times = walls(forest, args.runs)
    rf_k3 = cs.kernel_ms(FUSED_HISTOGRAM_SETS, forest)
    print(json.dumps({
        "root": str(root),
        "device": cs.nvidia_smi("name,power.limit"),
        "scaled_gbt": summary(gbt_times, g["rounds"], gbt_k3),
        "rf_classifier": summary(rf_times, s["trees"], rf_k3),
        "k3_calls": k3_calls(cs, K)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

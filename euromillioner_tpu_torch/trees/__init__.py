"""Gradient-boosted trees (the JAX package's ``trees/``, its GBT half):
histogram-based split finding on the device, level by level, with the
per-level histogram in a hand-written CUDA kernel (K3)."""

from euromillioner_tpu_torch.trees.gbt import Booster, DMatrix, train

__all__ = ["Booster", "DMatrix", "train"]

"""Tree ensembles (the JAX package's ``trees/``): gradient-boosted trees
and the random forest, with histogram-based split finding on the device,
level by level, and the per-level histogram in a hand-written CUDA kernel
(K3; the forest launches its set form once per level for all trees);
``chunked.py`` splits a trained ensemble into fixed-size chunks for the
serving engine's chunked dispatch."""

from euromillioner_tpu_torch.trees.gbt import Booster, DMatrix, train
from euromillioner_tpu_torch.trees.random_forest import (RandomForestModel,
                                                         train_classifier,
                                                         train_regressor)

__all__ = ["Booster", "DMatrix", "RandomForestModel", "train",
           "train_classifier", "train_regressor"]

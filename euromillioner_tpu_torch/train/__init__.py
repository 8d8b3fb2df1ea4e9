"""Training: optimizers, the Trainer with watch lists, metrics and
checkpoints (the JAX package's ``train/``)."""

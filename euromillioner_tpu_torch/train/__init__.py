"""Training: optimizers, the Trainer with watch lists, metrics,
checkpoints and truncated BPTT over a whole history (the JAX package's
``train/``)."""

"""Training: loss and train step, checkpoints, the Trainer (port of the
JAX package's `train`)."""

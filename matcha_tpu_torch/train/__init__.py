"""Training: the optimizer, the loop, metrics and checkpoints."""

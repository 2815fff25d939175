"""The training step: losses, gradients and the optimizer."""

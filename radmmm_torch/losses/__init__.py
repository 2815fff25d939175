"""Loss functions of the training step."""

"""Training system: config, train step, checkpoints, the training loop."""

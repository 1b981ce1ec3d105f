"""Training and inference: ``train_project`` with its step and checkpoints,
the k-fold splits, MC-dropout UQ and external evaluation."""

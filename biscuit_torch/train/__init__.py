"""Training and inference: ``train_project`` with its step and checkpoints,
the k-fold splits, MC-dropout UQ and external evaluation."""

from . import splits  # noqa: F401


def __getattr__(name):
    # Lazy: trainer and evaluate import pandas.
    if name in ("trainer", "uq", "evaluate"):
        import importlib

        return importlib.import_module("." + name, __name__)
    raise AttributeError(name)

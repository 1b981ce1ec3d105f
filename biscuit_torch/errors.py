"""Typed exceptions of the port.

The port's copy of ``biscuit_tpu/errors.py``: the same class names and
inheritance, so ``except`` clauses written against either package (or
the reference BISCUIT's ``errors.py``) work on both.
"""


class MatchError(Exception):
    """Base class for model/eval discovery failures."""


class ModelNotFoundError(MatchError):
    """No model directory matched the requested label/outcome/kfold."""


class MultipleModelsFoundError(MatchError):
    """More than one model directory matched."""


class EvalError(Exception):
    """Evaluation could not be performed."""


class ThresholdError(Exception):
    """Uncertainty threshold could not be detected from cross-validation."""


class ROCFailedError(Exception):
    """ROC curve could not be generated (e.g. empty predictions)."""


class PredsContainNaNError(Exception):
    """Tile-level predictions contain NaNs."""

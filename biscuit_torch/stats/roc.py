"""ROC curve, AUC and Youden-J threshold selection (NumPy, float64); the
port's copy of ``biscuit_tpu/stats/roc.py``.

The reference BISCUIT delegates these to ``sklearn.metrics.roc_curve`` /
``auc`` and picks the operating point with
``max(zip(tpr, fpr), key=lambda x: x[0]-x[1])``. This module reproduces
sklearn's conventions exactly, without importing sklearn:

* descending stable sort of scores,
* collapse to distinct score values,
* ``drop_intermediate`` collinear-point pruning,
* a leading ``(fpr=0, tpr=0)`` point with threshold ``+inf``,
* NaN curves (with no exception) when only one class is present,
* Youden tie-breaking toward the *first* maximal ``tpr - fpr`` along the
  curve (Python ``max`` keeps the first strictly-greatest key, which equals
  ``np.argmax`` on first-occurrence semantics).
"""

from __future__ import annotations

import warnings

import numpy as np

__all__ = [
    "roc_curve",
    "auc_score",
    "trapezoid_auc",
    "youden_threshold",
    "auc_and_youden",
    "average_precision",
]


class UndefinedMetricWarning(UserWarning):
    """Raised when an ROC curve is degenerate (single-class y_true)."""


def _validate_binary(y_true: np.ndarray) -> np.ndarray:
    """Validate a {0,1} label vector, mirroring sklearn's binary handling."""
    classes = np.unique(y_true)
    if classes.size > 2:
        raise ValueError(
            f"y_true must be binary; got {classes.size} distinct values"
        )
    if not np.all(np.isin(classes, (0, 1))):
        raise ValueError(f"y_true labels must be within {{0, 1}}; got {classes}")
    return y_true == 1


def roc_curve(y_true, y_score, drop_intermediate: bool = True):
    """Compute (fpr, tpr, thresholds) with sklearn-identical semantics.

    Args:
        y_true: array-like of {0,1} ground-truth labels.
        y_score: array-like of prediction scores (higher = more positive).
        drop_intermediate: drop collinear suboptimal thresholds (sklearn
            default True; the reference always uses the default).

    Returns:
        fpr, tpr, thresholds — float64 arrays. thresholds[0] is +inf.
    """
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    if y_true.shape != y_score.shape:
        raise ValueError("y_true and y_score must have the same shape")
    if y_true.size == 0:
        # sklearn raises ValueError for 0-sample input; utils.auc converts
        # this to NaN (the reference's utils.py:497-504).
        raise ValueError("Found array with 0 samples")
    pos = _validate_binary(y_true)

    # Stable descending sort by score.
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[order]
    pos = pos[order]

    # Indices of the last occurrence of each distinct score value.
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_score.size - 1]

    tps = np.cumsum(pos, dtype=np.float64)[threshold_idxs]
    fps = 1.0 + threshold_idxs - tps
    thresholds = y_score[threshold_idxs]

    if drop_intermediate and fps.size > 2:
        keep = np.where(
            np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        )[0]
        fps = fps[keep]
        tps = tps[keep]
        thresholds = thresholds[keep]

    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]

    if fps[-1] <= 0:
        warnings.warn(
            "No negative samples in y_true; false positive rate is undefined",
            UndefinedMetricWarning,
            stacklevel=2,
        )
        fpr = np.full_like(fps, np.nan)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        warnings.warn(
            "No positive samples in y_true; true positive rate is undefined",
            UndefinedMetricWarning,
            stacklevel=2,
        )
        tpr = np.full_like(tps, np.nan)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def trapezoid_auc(x, y) -> float:
    """Area under a curve via the trapezoid rule (sklearn.metrics.auc)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.size < 2:
        raise ValueError("At least 2 points are required to compute an AUC")
    dx = np.diff(x)
    direction = 1.0
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1.0
        else:
            raise ValueError("x is neither increasing nor decreasing")
    return float(direction * np.trapezoid(y, x))


def auc_score(y_true, y_score) -> float:
    """AUROC. Returns NaN (with a warning already emitted) for degenerate
    curves, mirroring the reference's utils.auc (utils.py:487-504)."""
    try:
        fpr, tpr, _ = roc_curve(y_true, y_score)
        return trapezoid_auc(fpr, tpr)
    except ValueError:
        return float("nan")


def average_precision(y_true, y_score) -> float:
    """Average precision (sklearn.metrics.average_precision_score semantics:
    step-wise integral of the precision-recall curve, AP = sum (R_i - R_{i-1})
    * P_i over descending-score thresholds)."""
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    pos = _validate_binary(y_true)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    pos = pos[order]
    y_sorted = y_score[order]
    distinct = np.where(np.diff(y_sorted))[0]
    threshold_idxs = np.r_[distinct, y_sorted.size - 1]
    tps = np.cumsum(pos, dtype=np.float64)[threshold_idxs]
    fps = 1.0 + threshold_idxs - tps
    if tps[-1] == 0:
        return float("nan")
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def youden_threshold(fpr, tpr, thresholds) -> float:
    """Optimal threshold via Youden's J = tpr - fpr.

    First-occurrence tie-breaking, matching the reference's
    ``max(zip(tpr, fpr), key=...)`` + ``list.index`` idiom. A single-class
    (NaN) curve raises ValueError: in the reference, ``max`` over NaN keys
    returns the first ``(nan, fpr)`` tuple and ``list(zip(...)).index``
    then raises ValueError because NaN tuples never compare equal.
    Callers mirror the reference's handling where it has any
    (threshold.py:151-152 -> 0.5 fallback; 219-222 -> ROCFailedError) and
    deliberately add it where it doesn't (detect()'s tile/slide-UQ
    branches degrade to the undetectable-fold return instead of crashing
    the results assembly — see threshold.detect) — verified by
    tests/test_reference_parity.py.
    """
    j = np.asarray(tpr, dtype=np.float64) - np.asarray(fpr, dtype=np.float64)
    if j.size == 0:
        raise ValueError("empty ROC curve")
    best = int(np.argmax(j))
    if np.isnan(j[best]):
        raise ValueError("Youden J undefined: single-class ROC curve")
    return float(np.asarray(thresholds)[best])


def auc_and_youden(y_true, y_score):
    """(AUC, optimal threshold) in one pass over the ROC curve."""
    fpr, tpr, thresholds = roc_curve(y_true, y_score)
    return trapezoid_auc(fpr, tpr), youden_threshold(fpr, tpr, thresholds)

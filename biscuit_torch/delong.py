"""Fast DeLong AUC variance and paired AUC comparison (Sun & Xu 2014).

The port's copy of ``biscuit_tpu/delong.py``: ``compute_midrank``,
``fastDeLong``, ``calc_pvalue``, ``compute_ground_truth_statistics``,
``delong_roc_variance`` and ``delong_roc_test``, with the same float64
arithmetic in the same order (midranks by a vectorized run-length pass),
so both packages give the same numbers. scipy is imported by the one
function that needs it.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "compute_midrank",
    "fastDeLong",
    "calc_pvalue",
    "compute_ground_truth_statistics",
    "delong_roc_variance",
    "delong_roc_test",
]


def compute_midrank(x: np.ndarray) -> np.ndarray:
    """Midranks of a 1-D array (ties get the average 1-based rank)."""
    x = np.asarray(x)
    order = np.argsort(x, kind="mergesort")
    z = x[order]
    n = z.size
    # Run boundaries of equal values.
    starts = np.r_[0, np.where(z[1:] != z[:-1])[0] + 1]
    ends = np.r_[starts[1:], n]
    # Average 1-based rank of a run spanning [start, end).
    mid = 0.5 * (starts + ends - 1.0) + 1.0
    ranks = np.repeat(mid, ends - starts)
    out = np.empty(n, dtype=np.float64)
    out[order] = ranks
    return out


def fastDeLong(predictions_sorted_transposed: np.ndarray, label_1_count: int):
    """AUCs and DeLong covariance for classifiers over shared examples.

    Args:
        predictions_sorted_transposed: (n_classifiers, n_examples) array with
            all positive examples first.
        label_1_count: number of positive examples.

    Returns:
        (aucs, covariance)
    """
    m = label_1_count
    preds = np.asarray(predictions_sorted_transposed, dtype=np.float64)
    n = preds.shape[1] - m
    k = preds.shape[0]

    tx = np.empty((k, m), dtype=np.float64)
    ty = np.empty((k, n), dtype=np.float64)
    tz = np.empty((k, m + n), dtype=np.float64)
    for r in range(k):
        tx[r] = compute_midrank(preds[r, :m])
        ty[r] = compute_midrank(preds[r, m:])
        tz[r] = compute_midrank(preds[r])
    aucs = tz[:, :m].sum(axis=1) / m / n - (m + 1.0) / 2.0 / n
    v01 = (tz[:, :m] - tx) / n
    v10 = 1.0 - (tz[:, m:] - ty) / m
    sx = np.cov(v01)
    sy = np.cov(v10)
    delongcov = sx / m + sy / n
    return aucs, delongcov


def calc_pvalue(aucs: np.ndarray, sigma: np.ndarray) -> np.ndarray:
    """log10 p-value for the hypothesis that two correlated AUCs differ."""
    import scipy.stats

    contrast = np.array([[1, -1]])
    z = np.abs(np.diff(aucs)) / np.sqrt(
        np.dot(np.dot(contrast, sigma), contrast.T)
    )
    return np.log10(2) + scipy.stats.norm.logsf(z, loc=0, scale=1) / np.log(10)


def compute_ground_truth_statistics(ground_truth: np.ndarray):
    ground_truth = np.asarray(ground_truth)
    if not np.array_equal(np.unique(ground_truth), [0, 1]):
        raise ValueError("ground_truth must contain both classes {0, 1}")
    order = (-ground_truth).argsort(kind="mergesort")
    label_1_count = int(ground_truth.sum())
    return order, label_1_count


def delong_roc_variance(ground_truth, predictions):
    """(AUC, variance) for one classifier's predictions."""
    order, label_1_count = compute_ground_truth_statistics(ground_truth)
    preds_sorted = np.asarray(predictions, dtype=np.float64)[np.newaxis, order]
    aucs, delongcov = fastDeLong(preds_sorted, label_1_count)
    assert len(aucs) == 1
    return aucs[0], delongcov


def delong_roc_test(ground_truth, predictions_one, predictions_two):
    """log10 p-value that two paired classifiers have different AUCs."""
    order, label_1_count = compute_ground_truth_statistics(ground_truth)
    stacked = np.vstack((predictions_one, predictions_two))[:, order]
    aucs, delongcov = fastDeLong(stacked, label_1_count)
    return calc_pvalue(aucs, delongcov)

"""ROC / AUC / Youden threshold search, segment reductions and DeLong on
the caller's device.

Counterpart of ``biscuit_tpu/ops/roc_jax.py``: the same functions without
the ``_jax`` suffix, taking and returning tensors on the device of their
inputs (the card on the device statistics backend, ``threshold_device``).
They are the on-device twins of :mod:`biscuit_torch.stats.roc`, which keeps
sklearn's semantics on the host:

* thresholds are evaluated at every sample position, with positions inside
  a run of equal scores excluded, which reproduces sklearn's
  distinct-threshold collapse for the argmax;
* AUC is the rank statistic (Mann-Whitney) with midranks for ties, which
  equals the trapezoid ROC AUC, in one sort;
* group (slide/patient) means are segment sums keyed on integer group ids.

What differs from the JAX module, and why:

* Eager PyTorch does not recompile by shape, so there is no ``jit``, no
  power-of-two padding of rows or segments and no compile cache. The
  optional ``mask`` arguments stay for callers that pad.
* Curve counts (``tps``/``fps``) are int64 cumulative sums, exact at any
  row count (the JAX ones are f32, exact to 2**24 rows); Youden's J and the
  AUC statistics are f64.
* Group sums are f64 and deterministic: rows are sorted stably by segment
  and each segment is summed by ``torch.segment_reduce``, which neither
  rounds through TF32 nor adds with float atomics (as ``index_add_`` does),
  so a group table repeats bit for bit. No process-wide precision setting
  is read or changed.
* Sorts are stable (``stable=True``) where JAX's are, ``argmax`` keeps the
  first occurrence, and ``searchsorted`` takes the ascending key
  ``t = -s`` as in the JAX module.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "auc",
    "youden_threshold",
    "youden_candidates",
    "uncertainty_threshold",
    "segment_mean",
    "group_reduce",
    "delong_variance",
    "delong_test",
    "apply_thresholds",
]

# f64 slack below the J maximum within which candidates are kept: a strict
# superset of every exact tie (distinct integer count pairs differ in true
# J by >= 1/(m*n), far above f64 noise), as in the JAX module.
_J_MARGIN = 1e-5


def _mask(mask, like: torch.Tensor) -> torch.Tensor:
    """The row mask as f64, all ones when None."""
    if mask is None:
        return torch.ones(like.shape[0], dtype=torch.float64,
                          device=like.device)
    return mask.to(torch.float64)


def _midranks(x: torch.Tensor) -> torch.Tensor:
    """Midranks (average 1-based rank over ties) of a 1-D tensor, f64."""
    n = x.shape[0]
    order = torch.argsort(x, stable=True)
    z = x[order]
    idx = torch.arange(n, device=x.device)
    differs = z[1:] != z[:-1]
    edge = torch.ones(1, dtype=torch.bool, device=x.device)
    is_start = torch.cat([edge, differs])
    is_end = torch.cat([differs, edge])
    # The first and last index of each position's run of equal values.
    start_idx = torch.cummax(torch.where(is_start, idx, 0), 0).values
    end_idx = torch.cummin(
        torch.where(is_end, idx, n - 1).flip(0), 0).values.flip(0)
    mid = 0.5 * (start_idx + end_idx).to(torch.float64) + 1.0
    out = torch.empty(n, dtype=torch.float64, device=x.device)
    out[order] = mid
    return out


def auc(y_true, y_score, mask=None):
    """AUROC via the rank statistic (ties get midranks), a 0-d f64 tensor.
    ``mask`` drops padded rows. NaN when a class is absent (the host's
    semantics)."""
    y = y_true.to(torch.float64)
    mask = _mask(mask, y)
    # Masked rows rank lowest; each valid positive's rank is then shifted
    # by the number of masked rows, which is subtracted below.
    score = torch.where(mask > 0, y_score,
                        torch.full_like(y_score, float("-inf")))
    ranks = _midranks(score)
    m = (y * mask).sum()
    n = ((1.0 - y) * mask).sum()
    pad = (1.0 - mask).sum()
    sum_pos_ranks = (ranks * y * mask).sum() - pad * m
    value = (sum_pos_ranks - m * (m + 1.0) / 2.0) / (m * n)
    return torch.where((m > 0) & (n > 0), value,
                       torch.full_like(value, float("nan")))


def _cum_curve(y_true, y_score, mask):
    """Descending-sorted cumulative int64 ``tps``/``fps`` with the valid
    threshold positions flagged: (tps, fps, sorted scores, valid, sorted
    mask). A position is valid when it is the last of its score run and
    not padding."""
    if mask is None:
        v = torch.ones(y_score.shape[0], dtype=torch.bool,
                       device=y_score.device)
    else:
        v = mask > 0
    score = torch.where(v, y_score, torch.full_like(y_score, float("-inf")))
    order = torch.argsort(score, descending=True, stable=True)
    s = score[order]
    v = v[order]
    t = (y_true[order] != 0) & v
    tps = torch.cumsum(t, 0, dtype=torch.int64)
    fps = torch.cumsum(v, 0, dtype=torch.int64) - tps
    edge = torch.ones(1, dtype=torch.bool, device=s.device)
    is_last = torch.cat([s[:-1] != s[1:], edge])
    return tps, fps, s, is_last & v, v


def _j(tps, fps):
    """Youden's J at every curve position, f64, and the class counts."""
    m, n = tps[-1], fps[-1]
    j = (tps.to(torch.float64) / torch.clamp_min(m, 1)
         - fps.to(torch.float64) / torch.clamp_min(n, 1))
    return j, m, n


def youden_threshold(y_true, y_score, mask=None):
    """Optimal threshold by Youden's J with sklearn's distinct-threshold
    semantics and first-occurrence tie-breaking: (threshold, J at the
    optimum), 0-d tensors. No positive J gives the +inf origin point of
    sklearn's curve (J = 0), as the host picks."""
    tps, fps, s, valid, _v = _cum_curve(y_true, y_score, mask)
    j, _m, _n = _j(tps, fps)
    j = torch.where(valid, j, torch.full_like(j, float("-inf")))
    best = torch.argmax(j)
    thr = torch.where(j[best] > 0, s[best],
                      torch.full_like(s[best], float("inf")))
    return thr, torch.clamp_min(j[best], 0.0)


def youden_candidates(y_true, y_score, mask=None, k: int = 128):
    """Near-optimal Youden operating points with exact integer counts.

    At an exact J tie the host's pick is decided by the f64 rounding noise
    of ``tps/m - fps/n``, so the device returns every valid curve position
    whose J is within ``_J_MARGIN`` of the maximum, with its integer
    ``tps``/``fps``, and the caller re-evaluates J as the host does
    (``threshold_device._resolve_youden``). sklearn's ``drop_intermediate``
    pruning is evaluated at the candidates (``keep`` False = pruned), since
    a pruned position can tie the maximum and must not be picked.

    Returns a dict of tensors: ``tps``/``fps`` (int64), ``score``, ``keep``
    (each of length min(k, rows), in curve order, the first ``count``
    real), ``count`` (selected positions, pruned ones included: the
    overflow indicator), ``m`` and ``n`` (class counts).
    """
    tps, fps, s, valid, v = _cum_curve(y_true, y_score, mask)
    n_rows = s.shape[0]
    j, m, n = _j(tps, fps)
    jmax = torch.where(valid, j, torch.full_like(j, float("-inf"))).max()
    sel = valid & (j >= jmax - _J_MARGIN)
    # The first k selected positions in curve order; the rest read
    # n_rows, which the caller drops by ``count``.
    idx = torch.arange(n_rows, device=s.device)
    pos = torch.topk(torch.where(sel, idx, n_rows), min(k, n_rows),
                     largest=False, sorted=True).values
    posc = pos.clamp(0, n_rows - 1)

    # drop_intermediate at the candidates: keep one unless both second
    # differences against its neighbouring valid positions vanish. A
    # candidate ends its run, so the previous valid position is its run's
    # start - 1 and the next one ends the following run.
    t = -s
    tc = t[posc]
    run_start = torch.searchsorted(t, tc, side="left")
    nxt = (posc + 1).clamp(0, n_rows - 1)
    nxt_end = torch.searchsorted(t, t[nxt], side="right") - 1
    prev = run_start - 1
    has_both = (prev >= 0) & (posc + 1 < n_rows) & v[nxt]
    pc = prev.clamp(0, n_rows - 1)
    nc = nxt_end.clamp(0, n_rows - 1)
    d2f = fps[nc] - 2 * fps[posc] + fps[pc]
    d2t = tps[nc] - 2 * tps[posc] + tps[pc]
    keep = torch.where(has_both, (d2f != 0) | (d2t != 0),
                       torch.ones_like(has_both))
    return {"tps": tps[posc], "fps": fps[posc], "score": s[posc],
            "keep": keep, "count": sel.sum(), "m": m, "n": n}


def uncertainty_threshold(incorrect, uncertainty, mask=None):
    """The reference's UQ threshold (threshold.py:417-426): the Youden
    point of ROC(incorrect, uncertainty)."""
    return youden_threshold(incorrect, uncertainty, mask)


def _segment_sums(cols, segment_ids, num_segments: int):
    """Deterministic f64 per-segment sums of the rows of ``cols`` (C, N):
    a stable sort by segment, then one sequential sum a segment.
    Returns (C, num_segments)."""
    order = torch.argsort(segment_ids, stable=True)
    lengths = torch.bincount(segment_ids, minlength=num_segments)
    data = cols.to(torch.float64)[:, order].T
    return torch.segment_reduce(data, "sum", lengths=lengths, axis=0).T


def segment_mean(values, segment_ids, num_segments: int, mask=None):
    """Per-segment f64 means with an optional row mask, and the row counts;
    empty segments give 0."""
    mask = _mask(mask, values)
    sums = _segment_sums(torch.stack([mask, values.to(torch.float64) * mask]),
                         segment_ids, num_segments)
    return sums[1] / torch.clamp_min(sums[0], 1.0), sums[0]


def group_reduce(y_true, y_pred, uncertainty, segment_ids,
                 num_segments: int, mask=None):
    """Tile -> group aggregation (threshold.py:189-204 on the device): the
    group means of y_pred / y_true / uncertainty (f64) and the tile counts,
    one sort for all of them."""
    mask = _mask(mask, y_pred)
    cols = torch.stack([mask, y_pred.to(torch.float64) * mask,
                        y_true.to(torch.float64) * mask,
                        uncertainty.to(torch.float64) * mask])
    sums = _segment_sums(cols, segment_ids, num_segments)
    counts = sums[0]
    means = sums[1:] / torch.clamp_min(counts, 1.0)
    return {
        # The uint8 label cast of the reference (threshold.py:197-200),
        # guarded as in the JAX module.
        "y_true": torch.floor(means[1] + 1e-6).to(torch.int64),
        "y_pred": means[0],
        "uncertainty": means[2],
        "count": counts,
    }


def _masked_midranks(score, select, within):
    """Midranks of ``score`` among the rows of the ``select`` subset,
    evaluated pairwise (O(n^2)): DeLong runs at group scale.

    rank_i = #[j in subset : s_j < s_i] + (#[j in subset : s_j == s_i]+1)/2
    """
    s_i = score[:, None]
    s_j = score[None, :]
    sel = (select * within)[None, :]
    less = ((s_j < s_i) * sel).sum(1)
    equal = ((s_j == s_i) * sel).sum(1)
    return less + (equal + 1.0) / 2.0


def _delong_parts(y_true, score, mask):
    """(AUC, V01, V10, positives, negatives, m, n) of one classifier
    (Sun & Xu 2014, eqs. 5-6), f64."""
    y = y_true.to(torch.float64)
    s = score.to(torch.float64)
    pos = y * mask
    neg = (1.0 - y) * mask
    m, n = pos.sum(), neg.sum()
    tx = _masked_midranks(s, pos, mask)    # ranks among positives
    ty = _masked_midranks(s, neg, mask)    # ranks among negatives
    tz = _masked_midranks(s, mask, mask)   # ranks among all valid rows
    value = ((tz * pos).sum() - m * (m + 1.0) / 2.0) / (m * n)
    return value, (tz - tx) / n, 1.0 - (tz - ty) / m, pos, neg, m, n


def _cov(u, v, sel, count):
    mu = (u * sel).sum() / count
    mv = (v * sel).sum() / count
    return ((u - mu) * (v - mv) * sel).sum() / torch.clamp_min(count - 1.0,
                                                               1.0)


def delong_variance(y_true, y_score, mask=None):
    """(AUC, DeLong variance) of one classifier: the device counterpart of
    ``delong.delong_roc_variance``."""
    mask = _mask(mask, y_true)
    value, v01, v10, pos, neg, m, n = _delong_parts(y_true, y_score, mask)
    return value, _cov(v01, v01, pos, m) / m + _cov(v10, v10, neg, n) / n


def delong_test(y_true, score_a, score_b, mask=None):
    """log10 p-value that two paired classifiers have different AUCs: the
    device counterpart of ``delong.delong_roc_test``."""
    mask = _mask(mask, y_true)
    a = _delong_parts(y_true, score_a, mask)
    b = _delong_parts(y_true, score_b, mask)
    pos, neg, m, n = a[3], a[4], a[5], a[6]
    parts = (a, b)
    sigma = torch.stack([torch.stack([
        _cov(parts[i][1], parts[k][1], pos, m) / m
        + _cov(parts[i][2], parts[k][2], neg, n) / n
        for k in range(2)]) for i in range(2)])
    contrast = torch.tensor([1.0, -1.0], dtype=torch.float64,
                            device=sigma.device)
    var = contrast @ sigma @ contrast
    z = torch.abs(a[0] - b[0]) / torch.sqrt(var)
    # log10(2 * (1 - Phi(z))) through the complementary error function.
    log_sf = torch.log(0.5 * torch.special.erfc(z / math.sqrt(2.0)))
    return math.log10(2.0) + log_sf / math.log(10.0)


def apply_thresholds(y_true, y_pred, uncertainty, segment_ids,
                     num_segments: int, tile_uq, slide_uq, tile_pred,
                     slide_pred, mask=None):
    """threshold.apply on the device (threshold.py:248-361): tile-UQ
    filter -> group means -> group-UQ filter (keep the confident) ->
    AUC / accuracy / sensitivity / specificity / percent included, each a
    0-d f64 tensor. ``tile_pred`` is accepted for the JAX signature; the
    group statistics do not use it."""
    mask = _mask(mask, y_pred)
    present = _segment_sums(mask[None], segment_ids, num_segments)[0] > 0
    keep_tiles = mask * (uncertainty < tile_uq)
    g = group_reduce(y_true, y_pred, uncertainty, segment_ids, num_segments,
                     keep_tiles)
    gmask = ((g["count"] > 0) & (g["uncertainty"] < slide_uq)).to(
        torch.float64)
    value = auc(g["y_true"], g["y_pred"], gmask)
    yt = g["y_true"] > 0
    yp = g["y_pred"] > slide_pred
    tp = (gmask * (yt & yp)).sum()
    fp = (gmask * (~yt & yp)).sum()
    tn = (gmask * (~yt & ~yp)).sum()
    fn = (gmask * (yt & ~yp)).sum()
    total = torch.clamp_min(tp + tn + fp + fn, 1.0)
    return {
        "auc": value,
        "percent_incl": gmask.sum() / torch.clamp_min(
            present.to(torch.float64).sum(), 1.0),
        "acc": (tp + tn) / total,
        "sensitivity": tp / torch.clamp_min(tp + fn, 1.0),
        "specificity": tn / torch.clamp_min(tn + fp, 1.0),
    }

"""Device backend of the uncertainty-thresholding pipeline.

Counterpart of ``biscuit_tpu/ops/threshold_device.py``:
:func:`biscuit_torch.threshold.detect`, ``apply`` and ``from_cv`` send a
frame here when ``backend="device"``, when ``BISCUIT_DEVICE_STATS=1``, or
when it holds at least ``BISCUIT_DEVICE_STATS_MIN_ROWS`` rows (the JAX
package's default, 1,000,000; ``PERF.md`` gives the H100's own
crossover). Its results are the host path's, which is held against the
reference's ``threshold.py`` (detect 364-475, apply 248-361,
process_group 180-245).

The O(N)-in-tiles work runs on ``device`` (the card unless the caller
passes ``device="cpu"``), on :mod:`biscuit_torch.ops.roc_device`; the
O(groups) tail runs the host statistics code:

* the tile columns go to the device once, as f32 (the JAX package's
  ``_prepare`` casts the same way, so on an f64 frame a tile threshold is
  the host's score rounded to f32), with int32 group codes in
  first-appearance order (``pd.factorize``; NaN keys go to a segment of
  their own that no group reads, the host's ``pd.notna`` filter);
* the tile-prediction and the tile-uncertainty Youden searches return
  their near-optimal candidates with exact integer counts, and
  :func:`_resolve_youden` re-evaluates J in f64 on the host over that
  small set, so the chosen threshold is the host's bit for bit, tie noise
  included; each search is one device->host copy;
* the tile filter and the tile->group reduction give the group table in
  one more device->host copy: each mean is summed in f64 (deterministic,
  ``roc_device.group_reduce``) and rounded once to f32, which is what
  pandas gives for the mean of an f32 column, the device's tile columns;
* the slide- and patient-level tail is the host logic on that table, so
  every reference quirk (the ROCFailedError conversion, the slide_uq=0.5
  fallback, the uint8 label cast) is the host's.

:class:`HostFallback` sends a call to the host path for the JAX package's
own reasons only: the screening of ``_precheck`` (an empty frame,
non-binary or single-class labels, NaN uncertainty), non-numeric
threshold arguments, a candidate overflow (more than ``_CAND_K`` tied
candidates), and the JAX package's 2**24-row screen (the port's counts are
int64, but its backend takes the frames the JAX package's takes). Any
other exception, a CUDA error or an out-of-memory among them, propagates:
it never becomes a host run, and neither does a missing card.

Eager PyTorch does not recompile by shape, so the JAX module's
power-of-two bucketing (``_bucket``) and persistent compile cache
(``_enable_persistent_compile_cache``) have no counterpart here, and
neither has its two-pass f32 group mean: the f64 sum rounded once is the
correctly rounded f32 mean, where the JAX backend's is within ~1 ulp of it.

Known deviation, as in the JAX backend: group means are f32 values, so
two groups whose f64 means differ by less than f32 resolution (~6e-8) on
an f64 frame can tie here and not on the host, which can move a
noise-level threshold choice or an AUC at such a tie. Thresholds agree
within 1e-6.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from .. import errors
from ..device import resolve_device
from ..utils_log import log
from .roc_device import group_reduce, youden_candidates

__all__ = ["detect_device", "apply_device", "HostFallback"]

# Shared with the host module so the two backends never disagree on which
# threshold types are numbers (threshold.py imports this module lazily,
# inside its functions, so the import is not circular at load time).
from ..threshold import _FLOAT_TYPES  # noqa: E402

_CAND_K = 128
_MAX_ROWS = 1 << 24


class HostFallback(Exception):
    """Internal: this call runs on the host path (a degenerate input whose
    host behaviour depends on exception details, or an argument the device
    backend does not take)."""


def _resolve(device) -> torch.device:
    """``device`` as a torch device; ``None`` means the card, and without
    one the call raises (never a quiet host run)."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise RuntimeError(f"{e}, or backend='host' for the host "
                           "statistics") from None


def _prepare(df, level, device):
    """The tile columns (f32) and group codes (int64) on ``device``:
    (y_true, y_pred, uncertainty, codes, levels, num_segments). Groups are
    in first-appearance order (the host's ``pd.unique``); rows with a NaN
    key go to the last segment, which is not a group."""
    if len(df) >= _MAX_ROWS:
        raise HostFallback("frame exceeds the 2**24-row budget")
    codes, levels = pd.factorize(df[level], use_na_sentinel=True)
    nseg = len(levels)
    cols = torch.from_numpy(np.stack([
        df[c].to_numpy(np.float32)
        for c in ("y_true", "y_pred", "uncertainty")])).to(device)
    seg = torch.from_numpy(
        np.where(codes >= 0, codes, nseg).astype(np.int32)).to(device)
    return cols[0], cols[1], cols[2], seg.long(), levels, nseg + 1


def _resolve_youden(cand) -> float:
    """Pick the operating point exactly as the host does.

    ``cand`` is :func:`roc_device.youden_candidates`' output: every
    unpruned curve position within the margin of the J maximum, with exact
    integer (tps, fps), in curve order. They come to the host in one copy;
    ``tps/m - fps/n`` in f64 there is the host's value bit for bit,
    including the rounding that decides exact ties, and argmax keeps the
    first occurrence, as np.argmax and the reference's ``max(zip(...))``
    do. The (0, 0, +inf) origin of the curve is prepended (J = 0), as in
    stats.roc.roc_curve.

    Raises ValueError for a single-class curve (the host's
    youden_threshold contract) and :class:`HostFallback` when the
    candidates overflowed ``_CAND_K``.
    """
    k = cand["tps"].shape[0]
    packed = torch.cat([
        cand["tps"].to(torch.float64), cand["fps"].to(torch.float64),
        cand["score"].to(torch.float64), cand["keep"].to(torch.float64),
        torch.stack([cand["count"], cand["m"], cand["n"]]).to(torch.float64),
    ]).cpu().numpy()
    m, n = float(packed[4 * k + 1]), float(packed[4 * k + 2])
    if m <= 0 or n <= 0:
        raise ValueError("Youden J undefined: single-class ROC curve")
    count = int(packed[4 * k])
    if count > _CAND_K:
        raise HostFallback(f"youden candidate overflow ({count})")
    keep = packed[3 * k:3 * k + count] > 0
    tps = packed[:count][keep]
    fps = packed[k:k + count][keep]
    score = packed[2 * k:2 * k + count][keep]
    j = np.r_[0.0, tps / m - fps / n]
    score = np.r_[np.inf, score]
    return float(score[np.argmax(j)])


def _precheck(df):
    """Degenerate-input screening, in the host's order. NaN predictions
    raise as on the host (threshold.py:136-138); inputs whose error
    behaviour depends on host exception details fall back."""
    if not len(df):
        raise HostFallback("empty frame")
    y_pred = df["y_pred"].to_numpy()
    if np.isnan(y_pred).sum():
        raise errors.PredsContainNaNError
    y_true = df["y_true"].to_numpy()
    classes = np.unique(y_true)
    if classes.size > 2 or not np.all(np.isin(classes, (0, 1))):
        raise HostFallback("non-binary labels")
    if classes.size < 2:
        # Host: tile ROC warns, Youden raises ValueError -> 0.5, etc.
        raise HostFallback("single-class tile labels")
    if df["uncertainty"].isna().any():
        raise HostFallback("NaN uncertainty")


def _tile_stages(df, tile_pred, tile_uq, level, device):
    """The device pipeline: resolve tile_pred, detect tile_uq if asked,
    filter, and reduce to the group table.

    Returns (tile_pred, tile_uq, tu_mode, group table dict of numpy
    arrays, levels). Group rows are in first-appearance order; the last
    one (NaN keys) is not a group."""
    yt, yp, u, seg, levels, nseg = _prepare(df, level, device)

    if tile_pred == "detect":
        # The host's 0.5 fallback for a single-class curve is unreachable:
        # _precheck screens single-class frames.
        tile_pred = _resolve_youden(youden_candidates(yt, yp, k=_CAND_K))
        log.debug(f"Auto-detected tile prediction threshold: {tile_pred:.4f}")

    if isinstance(tile_uq, _FLOAT_TYPES):
        tu_mode = "fixed"
    elif tile_uq == "detect":
        tu_mode = "detect"
        tp = float(np.float32(tile_pred))
        wrong = ((yp < tp) & (yt == 1)) | ((yp >= tp) & (yt == 0))
        # A ValueError (single-class error ROC) propagates to
        # detect_device, which degrades to the undetectable-fold return,
        # as the host detect() does.
        tile_uq = _resolve_youden(youden_candidates(wrong, u, k=_CAND_K))
        log.debug(f"Tile-level optimal UQ threshold: {tile_uq:.4f}")
    else:
        tu_mode = "off"

    tmask = (u < float(np.float32(tile_uq)) if tu_mode != "off"
             else torch.ones_like(u, dtype=torch.bool))
    g = group_reduce(yt, yp, u, seg, nseg, tmask)
    # ONE device->host copy of the whole group table, its means rounded
    # to f32 (module docstring).
    table = torch.stack([
        g["count"], g["y_true"].to(torch.float64),
        g["y_pred"].float().double(),
        g["uncertainty"].float().double()]).cpu().numpy()
    log.debug(f"Number of tiles after filter: {int(table[0, :-1].sum())}")
    return (tile_pred, tile_uq, tu_mode,
            dict(zip(("count", "y_true", "y_pred", "uncertainty"), table)),
            levels)


def _group_frame(g, levels):
    """The host-side group table (first-appearance order, empty groups
    dropped), the input to the host-logic tail."""
    n_real = len(levels)
    present = g["count"][:n_real] > 0
    return {
        "levels": np.asarray(levels)[present],
        "y_true": g["y_true"][:n_real][present].astype(np.uint8),
        "y_pred": g["y_pred"][:n_real][present],
        "uncertainty": g["uncertainty"][:n_real][present],
    }


def detect_device(df, tile_uq="detect", slide_uq="detect", tile_pred="detect",
                  slide_pred="detect", plot=False, patients=None,
                  device=None):
    """Device counterpart of :func:`biscuit_torch.threshold.detect`, on
    ``device`` (the card unless ``device="cpu"``; without one it raises).

    The same return contract ((thresholds dict, slide AUC) or the same
    exceptions); raises :class:`HostFallback` when the call must run on
    the host. ``patients`` only changes a column of the host's frame
    (detect groups by slide), so it is accepted and ignored. The frame is
    not changed.

    The slide-level tail is the host detect logic (threshold.py:300-341
    of the JAX package, reference threshold.py:428-475) over the device's
    group means.
    """
    from ..stats.roc import auc_score, roc_curve, youden_threshold

    device = _resolve(device)
    if plot:
        raise HostFallback("plot requires the host tile frame")
    for v in (tile_pred, slide_pred):
        if v != "detect" and not isinstance(v, _FLOAT_TYPES + (int,)):
            raise HostFallback("non-numeric prediction threshold")
    _precheck(df)

    if not isinstance(tile_uq, _FLOAT_TYPES) and tile_uq != "detect":
        log.debug("Not performing tile-level uncertainty thresholding.")
        tile_uq = None

    empty_thresh = {k: None for k in (
        "tile_uq", "slide_uq", "tile_pred", "slide_pred")}
    try:
        tile_pred, tile_uq_res, tu_mode, g, levels = _tile_stages(
            df, tile_pred, tile_uq, "slide", device)
    except ValueError:
        # A single-class error ROC in the tile-UQ search: the host
        # detect()'s deliberate degrade (an undetectable fold, which
        # from_cv skips).
        log.error("Unable to detect tile UQ threshold "
                  "(single-class error ROC)")
        return empty_thresh, None
    tile_uq = tile_uq_res if tu_mode != "off" else None
    gf = _group_frame(g, levels)
    gyt = gf["y_true"]
    gyp = gf["y_pred"]
    gu = gf["uncertainty"]

    # --- host-logic tail: process_group_predictions (threshold.py:100-158)
    if not len(gyt):
        log.error("Unable to process slide predictions")
        return empty_thresh, None
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        l_fpr, l_tpr, l_thresh = roc_curve(gyt, gyp)
    if slide_pred == "detect":
        try:
            slide_pred = youden_threshold(l_fpr, l_tpr, l_thresh)
        except ValueError:
            log.error("Unable to process slide predictions")
            return empty_thresh, None
        log.debug(f"Using detected prediction threshold: {slide_pred:.4f}")

    s_incorrect = (
        ((gyp < slide_pred) & (gyt == 1)) | ((gyp >= slide_pred) & (gyt == 0))
    ).astype(int)

    # --- host-logic tail: detect (threshold.py:308-341)
    if slide_uq == "detect":
        if not s_incorrect.sum():
            log.debug(
                "Unable to calculate slide UQ threshold; "
                "no incorrect predictions made"
            )
            slide_uq = None
            keep = np.ones(gyt.shape, bool)
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                s_fpr, s_tpr, s_thresh = roc_curve(s_incorrect, gu)
            try:
                slide_uq = youden_threshold(s_fpr, s_tpr, s_thresh)
            except ValueError:
                # An all-incorrect slide error ROC: the same degrade as
                # the host detect()'s slide branch.
                log.error("Unable to detect slide UQ threshold "
                          "(single-class error ROC)")
                return empty_thresh, None
            log.debug(f"Slide-level optimal UQ threshold: {slide_uq:.4f}")
            keep = gu < slide_uq
    else:
        log.debug("Not performing slide-level uncertainty thresholding.")
        slide_uq = 0.5  # reference quirk (threshold.py:461-463)
        keep = np.ones(gyt.shape, bool)

    auc = auc_score(gyt[keep], gyp[keep])
    thresholds = {
        "tile_uq": tile_uq,
        "slide_uq": slide_uq,
        "tile_pred": tile_pred,
        "slide_pred": slide_pred,
    }
    return thresholds, auc


def apply_device(df, tile_uq, slide_uq, tile_pred=0.5, slide_pred=0.5,
                 plot=False, keep="high_confidence", title=None,
                 patients=None, level="slide", device=None):
    """Device counterpart of :func:`biscuit_torch.threshold.apply`, on
    ``device`` (the card unless ``device="cpu"``; without one it raises).

    The same return contract (results dict, thresholded group DataFrame).
    The group table comes from the device's reduction, and the group-level
    tail is the host apply logic (threshold.py:210-240 of the JAX package,
    reference threshold.py:310-361), so columns, order and quirks match.
    Raises :class:`HostFallback` for arguments whose host behaviour is an
    exception."""
    from ..stats.roc import auc_score

    assert keep in ("high_confidence", "low_confidence")
    assert not (level == "patient" and patients is None)
    device = _resolve(device)
    if slide_pred == "detect" or not isinstance(
        slide_pred, _FLOAT_TYPES + (int,)
    ):
        # The host path fails downstream on a non-numeric slide_pred
        # (float > str); the host keeps that contract.
        raise HostFallback("non-numeric slide_pred")
    if tile_pred != "detect" and not isinstance(
        tile_pred, _FLOAT_TYPES + (int,)
    ):
        raise HostFallback("non-numeric tile_pred")
    # apply() takes the UQ thresholds by truthiness (`if tile_uq:`), so
    # ints filter like floats and a truthy non-number (the string
    # 'detect', valid only for detect()) fails in the host's comparison:
    # the host raises its own TypeError.
    _num = _FLOAT_TYPES + (int, np.integer)
    if tile_uq and not isinstance(tile_uq, _num):
        raise HostFallback("non-numeric truthy tile_uq")
    if slide_uq and not isinstance(slide_uq, _num):
        raise HostFallback("non-numeric truthy slide_uq")
    _precheck(df)

    if patients:
        df = df.assign(patient=df["slide"].map(patients))
    # The host's denominator counts a NaN key too (pd.unique keeps one
    # NaN); the group statistics then drop it (pd.notna).
    num_pre_filter = df[level].nunique(dropna=False)
    if tile_uq:
        log.debug(f"Applying tile UQ threshold of {tile_uq:.5f}")

    # Truthiness as the reference: a 0/None tile_uq skips the filter; an
    # int becomes a float for _tile_stages' fixed-threshold branch.
    tile_pred, _, _, g, levels = _tile_stages(
        df, tile_pred, float(tile_uq) if tile_uq else None, level, device)
    gf = _group_frame(g, levels)
    gyt = gf["y_true"]
    gyp = gf["y_pred"]
    gu = gf["uncertainty"]

    if not len(gyt):
        log.error("Unable to process slide predictions")
        empty = {k: None for k in (
            "auc", "percent_incl", "acc", "sensitivity", "specificity")}
        return empty, None

    # The thresholds are data values (a Youden optimum is a group mean)
    # and the group means here are f32: rounding the incoming thresholds
    # to f32 excludes the boundary group by the strict '<' as on the host,
    # so detect -> apply is consistent within a backend.
    slide_pred = float(np.float32(slide_pred))
    if slide_uq:
        slide_uq = float(np.float32(slide_uq))

    # --- host-logic tail: process_group_predictions' output frame
    correct = ((gyp < slide_pred) & (gyt == 0)) | (
        (gyp >= slide_pred) & (gyt == 1))
    s_df = pd.DataFrame({
        level: pd.Series(gf["levels"]),
        "error": pd.Series(np.abs(gyt - gyp)),
        "uncertainty": pd.Series(gu),
        "correct": pd.Series(correct),
        "incorrect": pd.Series(~correct).astype(int),
        "y_true": pd.Series(gyt),
        "y_pred": pd.Series(gyp),
        "y_pred_bin": pd.Series(gyp >= slide_pred).astype(int),
    })

    if plot:
        from ..threshold import plot_uncertainty

        plot_uncertainty(s_df, threshold=slide_uq, kind=level, title=title)

    # --- host-logic tail: apply (threshold.py:213-240)
    if slide_uq:
        log.debug(f"Using {level} uncertainty threshold of {slide_uq:.5f}")
        if keep == "high_confidence":
            s_df = s_df.loc[s_df["uncertainty"] < slide_uq]
        else:
            s_df = s_df.loc[s_df["uncertainty"] >= slide_uq]

    auc = auc_score(s_df["y_true"].to_numpy(), s_df["y_pred"].to_numpy())
    percent_incl = len(s_df) / num_pre_filter
    y_true_b = s_df["y_true"].to_numpy().astype(bool)
    y_pred_b = s_df["y_pred"].to_numpy() > slide_pred
    tp = np.logical_and(y_true_b, y_pred_b).sum()
    fp = np.logical_and(~y_true_b, y_pred_b).sum()
    tn = np.logical_and(~y_true_b, ~y_pred_b).sum()
    fn = np.logical_and(y_true_b, ~y_pred_b).sum()
    with np.errstate(invalid="ignore", divide="ignore"):
        acc = (tp + tn) / (tp + tn + fp + fn)
        sensitivity = tp / (tp + fn)
        specificity = tn / (tn + fp)
    results = {
        "auc": auc,
        "percent_incl": percent_incl,
        "acc": acc,
        "sensitivity": sensitivity,
        "specificity": specificity,
    }
    return results, s_df

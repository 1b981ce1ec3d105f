"""Uncertainty thresholds: derive them from cross-validated tile
predictions and apply them to an external cohort, on the host.

The port's copy of the host path of ``biscuit_tpu/threshold.py`` (the
reference BISCUIT's ``threshold.py``): ``process_tile_predictions``,
``process_group_predictions``, ``apply``, ``detect`` and ``from_cv``,
with the same DataFrame semantics (column names, the 'detect' sentinels,
the fold aggregation min/max/mean, the uint8 cast of group labels) and
the same arithmetic, so both packages give equal thresholds on equal
frames. It keeps the JAX package's deliberate fixes: a fold whose error
ROC is single-class degrades to "undetectable" in ``detect`` instead of
raising, and ``apply(..., tile_uq=None)`` skips the tile filter.

``plot=True`` draws the uncertainty figure (``plot_uncertainty``, with
the numpy LOESS ``_loess_smooth``) where the JAX package draws it;
matplotlib and seaborn are imported only then.

Not ported yet: the device statistics backend (``backend="device"``
raises; ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from . import errors
from .stats.roc import auc_score, roc_curve, trapezoid_auc, youden_threshold
from .utils_log import log

__all__ = [
    "process_tile_predictions",
    "process_group_predictions",
    "apply",
    "detect",
    "from_cv",
    "plot_uncertainty",
]

_FLOAT_TYPES = (float, np.float16, np.float32, np.float64)


def _host_only(backend) -> None:
    """Refuse what the port does not have yet: the device backend."""
    if backend == "device":
        raise NotImplementedError(
            "the device statistics backend is not ported yet (ROADMAP.md "
            "Queue 1 item 8); use backend='host' or None")
    if backend not in (None, "host"):
        raise ValueError(f"backend must be 'host', 'device' or None: {backend}")


# ---------------------------------------------------------------------------
# Tile- and group-level prediction processing
# ---------------------------------------------------------------------------

def process_tile_predictions(df, pred_thresh=0.5, patients=None):
    """Annotate tile predictions with correctness flags and binary calls.

    Mirrors threshold.py:125-177: tile ROC -> Youden-J prediction threshold
    (if ``pred_thresh == 'detect'``), NaN guard, slide->patient mapping, and
    the derived columns error/correct/incorrect/y_pred_bin.

    Returns:
        (df, pred_thresh)
    """
    y_pred = df["y_pred"].to_numpy()
    if np.isnan(y_pred).sum():
        raise errors.PredsContainNaNError
    y_true = df["y_true"].to_numpy()

    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fpr, tpr, thresh = roc_curve(y_true, y_pred)
        tile_auc = trapezoid_auc(fpr, tpr) if fpr.size >= 2 else float("nan")
    try:
        opt_pred = youden_threshold(fpr, tpr, thresh)
    except ValueError:
        log.debug("Unable to calculate tile prediction threshold; using 0.5")
        opt_pred = 0.5

    if pred_thresh == "detect":
        log.debug(f"Auto-detected tile prediction threshold: {opt_pred:.4f}")
        pred_thresh = opt_pred
    else:
        log.debug(f"Using tile prediction threshold: {pred_thresh:.4f}")

    if patients is not None:
        df["patient"] = df["slide"].map(patients)
    else:
        log.warning("Patients not provided; assuming 1:1 slide:patient mapping")

    log.debug(f"Tile AUC: {tile_auc:.4f}")
    df["error"] = abs(df["y_true"] - df["y_pred"])
    df["correct"] = (
        ((df["y_pred"] < pred_thresh) & (df["y_true"] == 0))
        | ((df["y_pred"] >= pred_thresh) & (df["y_true"] == 1))
    )
    df["incorrect"] = (~df["correct"]).astype(int)
    df["y_pred_bin"] = (df["y_pred"] >= pred_thresh).astype(int)
    return df, pred_thresh


def process_group_predictions(df, pred_thresh, level):
    """Aggregate tile predictions to group (slide/patient) level.

    Mirrors threshold.py:180-245. Group order follows first appearance
    (``pd.unique``); group-mean labels are cast to uint8 exactly like the
    reference (assumes label purity within a group — SURVEY.md §2.2.7).
    """
    for c in ("y_true", "y_pred", "uncertainty"):
        if c not in df.columns:
            raise ValueError(
                "Missing columns. Expected y_true, y_pred, uncertainty. "
                f"Got: {df.columns.tolist()}"
            )

    log.debug(f"Calculating {level}-level means from {len(df)} predictions")
    levels = [lv for lv in pd.unique(df[level]) if pd.notna(lv)]
    reduced = df[[level, "y_pred", "y_true", "uncertainty"]]
    grouped = reduced.groupby(level, sort=False).mean().reindex(levels)
    yp = grouped["y_pred"].to_numpy()
    yt = grouped["y_true"].to_numpy().astype(np.uint8)
    u = grouped["uncertainty"].to_numpy()
    if not len(yt):
        raise errors.ROCFailedError("Unable to generate ROC; preds are empty.")

    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        l_fpr, l_tpr, l_thresh = roc_curve(yt, yp)
        level_auc = trapezoid_auc(l_fpr, l_tpr) if l_fpr.size >= 2 else float("nan")

    if pred_thresh == "detect":
        try:
            pred_thresh = youden_threshold(l_fpr, l_tpr, l_thresh)
        except ValueError:
            raise errors.ROCFailedError(f"Unable to generate {level}-level ROC")
        log.debug(f"Using detected prediction threshold: {pred_thresh:.4f}")
    else:
        log.debug(f"Using {level} prediction threshold: {pred_thresh:.4f}")
    log.debug(f"{level} AUC: {level_auc:.4f}")

    correct = ((yp < pred_thresh) & (yt == 0)) | ((yp >= pred_thresh) & (yt == 1))
    incorrect = pd.Series(
        ((yp < pred_thresh) & (yt == 1)) | ((yp >= pred_thresh) & (yt == 0))
    ).astype(int)

    l_df = pd.DataFrame(
        {
            level: pd.Series(levels),
            "error": pd.Series(abs(yt - yp)),
            "uncertainty": pd.Series(u),
            "correct": correct,
            "incorrect": incorrect,
            "y_true": pd.Series(yt),
            "y_pred": pd.Series(yp),
            "y_pred_bin": pd.Series(yp >= pred_thresh).astype(int),
        }
    )
    return l_df, pred_thresh


# ---------------------------------------------------------------------------
# Threshold application
# ---------------------------------------------------------------------------

def apply(
    df,
    tile_uq,
    slide_uq,
    tile_pred=0.5,
    slide_pred=0.5,
    plot=False,
    keep="high_confidence",
    title=None,
    patients=None,
    level="slide",
    backend=None,
):
    """Apply pre-calculated tile- and group-level uncertainty thresholds.

    Mirrors threshold.py:248-361. Returns (results dict with keys auc,
    percent_incl, acc, sensitivity, specificity; thresholded group-level
    DataFrame). Zero/None thresholds skip the respective filter (reference
    truthiness semantics). ``backend`` is None or "host" (module
    docstring).
    """
    assert keep in ("high_confidence", "low_confidence")
    assert not (level == "patient" and patients is None)
    _host_only(backend)

    if tile_uq:
        log.debug(f"Applying tile UQ threshold of {tile_uq:.5f}")
    else:
        # DELIBERATE FIX vs threshold.py:284 — the reference formats
        # tile_uq with :.5f unconditionally, so apply(df, tile_uq=None, ...)
        # (the documented "skip the tile filter" call) raises TypeError
        # before reaching the `if tile_uq` guard below.
        log.debug("No tile UQ threshold; skipping tile-level filter")
    if patients:
        df["patient"] = df["slide"].map(patients)
    log.debug(
        f"Number of {level}s before tile UQ filter: "
        f"{pd.unique(df[level]).shape[0]}"
    )

    df, _ = process_tile_predictions(df, pred_thresh=tile_pred, patients=patients)
    num_pre_filter = pd.unique(df[level]).shape[0]

    if tile_uq:
        df = df[df["uncertainty"] < tile_uq]
    log.debug(f"Number of tiles after tile-level filter: {len(df)}")

    try:
        s_df, _ = process_group_predictions(df, pred_thresh=slide_pred, level=level)
    except errors.ROCFailedError:
        log.error("Unable to process slide predictions")
        empty = {k: None for k in (
            "auc", "percent_incl", "acc", "sensitivity", "specificity")}
        return empty, None

    if plot:
        plot_uncertainty(s_df, threshold=slide_uq, kind=level, title=title)

    if slide_uq:
        log.debug(f"Using {level} uncertainty threshold of {slide_uq:.5f}")
        if keep == "high_confidence":
            s_df = s_df.loc[s_df["uncertainty"] < slide_uq]
        else:
            s_df = s_df.loc[s_df["uncertainty"] >= slide_uq]

    auc = auc_score(s_df["y_true"].to_numpy(), s_df["y_pred"].to_numpy())
    percent_incl = len(s_df) / num_pre_filter

    y_true = s_df["y_true"].to_numpy().astype(bool)
    y_pred = s_df["y_pred"].to_numpy() > slide_pred
    tp = np.logical_and(y_true, y_pred).sum()
    fp = np.logical_and(~y_true, y_pred).sum()
    tn = np.logical_and(~y_true, ~y_pred).sum()
    fn = np.logical_and(y_true, ~y_pred).sum()
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


# ---------------------------------------------------------------------------
# Threshold detection
# ---------------------------------------------------------------------------

def detect(
    df,
    tile_uq="detect",
    slide_uq="detect",
    tile_pred="detect",
    slide_pred="detect",
    plot=False,
    patients=None,
    backend=None,
):
    """Detect optimal tile- and slide-level uncertainty thresholds.

    Mirrors threshold.py:364-475. Uncertainty thresholds are the Youden-J
    point of the ROC of uncertainty vs. incorrectness. Non-'detect',
    non-float ``tile_uq`` disables tile filtering; non-'detect' ``slide_uq``
    falls back to 0.5 (reference quirk, threshold.py:461-463).
    ``backend`` is None or "host" (module docstring).

    Returns:
        (thresholds dict with keys tile_uq/slide_uq/tile_pred/slide_pred,
         slide-level AUROC)
    """
    log.debug("Detecting thresholds...")
    empty_thresh = {k: None for k in (
        "tile_uq", "slide_uq", "tile_pred", "slide_pred")}
    _host_only(backend)
    try:
        df, detected_tile_pred = process_tile_predictions(
            df, pred_thresh=tile_pred, patients=patients
        )
    except errors.PredsContainNaNError:
        log.error("Tile-level predictions contain NaNs; unable to process.")
        return empty_thresh, None

    if tile_pred == "detect":
        tile_pred = detected_tile_pred

    if isinstance(tile_uq, _FLOAT_TYPES):
        df = df[df["uncertainty"] < tile_uq]
    elif tile_uq != "detect":
        log.debug("Not performing tile-level uncertainty thresholding.")
        tile_uq = None
    else:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t_fpr, t_tpr, t_thresh = roc_curve(
                df["incorrect"].to_numpy(), df["uncertainty"].to_numpy()
            )
        try:
            tile_uq = youden_threshold(t_fpr, t_tpr, t_thresh)
        except ValueError:
            # DELIBERATE FIX of a latent reference crash (documented per
            # SURVEY.md §2.2 convention): when a fold's error ROC is
            # single-class (every tile correct — reached on small folds;
            # the paper's ~1000-tile folds always contain errors), the
            # reference's bare Youden idiom (threshold.py:419-425, no
            # try/except unlike its slide-pred path at :219-222) raises
            # ValueError out of detect() and crashes the whole results
            # assembly. Degrade to "fold undetectable" instead — the
            # exact contract from_cv already applies when slide_uq
            # comes back None (skip the fold; all folds undetectable ->
            # ThresholdError -> experiment.results skips the UQ row).
            # Shaken out by benchmarks/run_full_matrix.py on the full
            # 280-experiment grid.
            log.error("Unable to detect tile UQ threshold "
                      "(single-class error ROC)")
            return empty_thresh, None
        log.debug(f"Tile-level optimal UQ threshold: {tile_uq:.4f}")
        df = df[df["uncertainty"] < tile_uq]

    log.debug(f"Number of tiles after filter: {len(df)}")

    try:
        s_df, slide_pred = process_group_predictions(
            df, pred_thresh=slide_pred, level="slide"
        )
    except errors.ROCFailedError:
        log.error("Unable to process slide predictions")
        return empty_thresh, None

    if slide_uq == "detect":
        if not s_df["incorrect"].to_numpy().sum():
            log.debug(
                "Unable to calculate slide UQ threshold; "
                "no incorrect predictions made"
            )
            slide_uq = None
        else:
            import warnings

            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                s_fpr, s_tpr, s_thresh = roc_curve(
                    s_df["incorrect"].to_numpy(), s_df["uncertainty"].to_numpy()
                )
            try:
                slide_uq = youden_threshold(s_fpr, s_tpr, s_thresh)
            except ValueError:
                # Same deliberate fix as the tile branch: the reference
                # guards all-correct (incorrect.sum()==0 above) but not
                # ALL-incorrect, where the slide error ROC is also
                # single-class and its bare Youden idiom raises.
                log.error("Unable to detect slide UQ threshold "
                          "(single-class error ROC)")
                return empty_thresh, None
            log.debug(f"Slide-level optimal UQ threshold: {slide_uq:.4f}")
            if plot:
                plot_uncertainty(s_df, threshold=slide_uq, kind="slide")
            s_df = s_df[s_df["uncertainty"] < slide_uq]
    else:
        log.debug("Not performing slide-level uncertainty thresholding.")
        slide_uq = 0.5
        if plot:
            plot_uncertainty(s_df, threshold=slide_uq, kind="slide")

    auc = auc_score(s_df["y_true"].to_numpy(), s_df["y_pred"].to_numpy())
    thresholds = {
        "tile_uq": tile_uq,
        "slide_uq": slide_uq,
        "tile_pred": tile_pred,
        "slide_pred": slide_pred,
    }
    return thresholds, auc


def from_cv(dfs, **kwargs):
    """Optimal thresholds from a set of cross-validation folds.

    Mirrors threshold.py:478-557 including the cross-fold aggregation:
    tile_uq -> min over folds, slide_uq -> max, prediction thresholds ->
    mean (threshold.py:544-550). Folds where either threshold cannot be
    detected are skipped. The dead `tile_uq_thresh`/`slide_uq_thresh` kwarg
    skip-path of the reference (threshold.py:513-516, never exercised by any
    caller) is preserved for API parity.
    """
    required_cols = ("y_true", "y_pred", "uncertainty", "slide", "patient")
    k_tile_thresh, k_slide_thresh = [], []
    k_tile_pred_thresh, k_slide_pred_thresh = [], []
    skip_tile = "tile_uq_thresh" in kwargs and kwargs["tile_uq_thresh"] is None
    skip_slide = "slide_uq_thresh" in kwargs and kwargs["slide_uq_thresh"] is None

    for idx, df in enumerate(dfs):
        log.debug(f"Detecting thresholds from fold {idx}")
        if not all(col in df.columns for col in required_cols):
            raise ValueError(
                f"DataFrame missing columns, expected {required_cols}, got: "
                f"{', '.join(df.columns.tolist())}"
            )
        thresholds, _auc = detect(df, **kwargs)
        if thresholds["tile_uq"] is None or thresholds["slide_uq"] is None:
            log.debug(f"Skipping CV #{idx}, unable to detect threshold")
            continue

        k_tile_pred_thresh.append(thresholds["tile_pred"])
        k_slide_pred_thresh.append(thresholds["slide_pred"])
        if not skip_tile:
            k_tile_thresh.append(thresholds["tile_uq"])
        if not skip_slide:
            k_slide_thresh.append(thresholds["slide_uq"])

    if not skip_tile and not len(k_tile_thresh):
        raise errors.ThresholdError("Unable to detect tile UQ threshold.")
    if not skip_slide and not len(k_slide_thresh):
        raise errors.ThresholdError("Unable to detect slide UQ threshold.")

    return {
        "tile_uq": k_tile_thresh if skip_tile else float(np.min(k_tile_thresh)),
        "slide_uq": k_slide_thresh if skip_slide else float(np.max(k_slide_thresh)),
        "tile_pred": float(np.mean(k_tile_pred_thresh)),
        "slide_pred": float(np.mean(k_slide_pred_thresh)),
    }


# ---------------------------------------------------------------------------
# Plotting
# ---------------------------------------------------------------------------

def _loess_smooth(x, y, frac=0.75):
    """Local linear regression with tricube weights (numpy implementation,
    replaces the reference's skmisc.loess dependency). Returns (fit, se)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.size
    k = max(2, int(np.ceil(frac * n)))
    fit = np.empty(n)
    se = np.empty(n)
    for i in range(n):
        d = np.abs(x - x[i])
        idx = np.argpartition(d, min(k - 1, n - 1))[:k]
        h = d[idx].max()
        w = (1 - np.clip(d[idx] / (h if h > 0 else 1.0), 0, 1) ** 3) ** 3
        sw = w.sum()
        xw = (w * x[idx]).sum() / sw
        yw = (w * y[idx]).sum() / sw
        cov = (w * (x[idx] - xw) * (y[idx] - yw)).sum()
        var = (w * (x[idx] - xw) ** 2).sum()
        b = cov / var if var > 0 else 0.0
        fit[i] = yw + b * (x[i] - xw)
        resid = y[idx] - (yw + b * (x[idx] - xw))
        se[i] = np.sqrt((w * resid**2).sum() / sw / max(1, sw))
    return fit, se


def plot_uncertainty(df, kind, threshold=None, title=None, seed=None):
    """3-panel uncertainty figure: KDE, scatter vs threshold, calibration.

    DELIBERATE FIGURE-PARITY PORT (SURVEY-quirk style disclosure): this
    function intentionally reproduces the reference figure *pixel-for-pixel*
    — panel layout, marker shapes/sizes, and styling constants ('#FC6D77'
    error marks, '#EAEAF2' panel background) are copied from reference
    threshold.py:15-122 because the published Figure-4 artifacts are the
    parity target; the plotting code itself is restructured (explicit axes,
    numpy LOESS replacement for skmisc). Behavioral deviations:
    ``kind='tile'`` subsampling accepts a ``seed`` (reference is unseeded,
    threshold.py:32-33), and the LOESS band uses :func:`_loess_smooth`.
    """
    import matplotlib.pyplot as plt
    import seaborn as sns

    if kind == "tile":
        df = df.sample(n=min(1000, len(df)), random_state=seed)

    f, axes = plt.subplots(1, 3)
    f.set_size_inches(15, 5)
    palette = sns.color_palette("Set2")
    tf_pal = {True: palette[0], False: palette[1]}

    # Left: KDE of uncertainty by correctness.
    kde = sns.kdeplot(
        x="uncertainty", hue="correct", data=df, fill=True,
        palette=tf_pal, ax=axes[0],
    )
    kde.set(xlabel="Uncertainty")
    axes[0].title.set_text(f"Uncertainty density ({kind}-level)")

    # Middle: prediction vs uncertainty scatter split by threshold.
    if threshold is not None:
        axes[1].axhline(y=threshold, color="r", linestyle="--")
        at_df = df.loc[df["uncertainty"] >= threshold]
        axes[1].scatter(
            x=at_df.loc[at_df["correct"], "y_pred"],
            y=at_df.loc[at_df["correct"], "uncertainty"],
            marker="o", s=10, color="gray",
        )
        axes[1].scatter(
            x=at_df.loc[~at_df["correct"], "y_pred"],
            y=at_df.loc[~at_df["correct"], "uncertainty"],
            marker="x", color="#FC6D77",
        )
        bt_df = df.loc[df["uncertainty"] < threshold]
    else:
        bt_df = df
    axes[1].scatter(
        x=bt_df.loc[bt_df["correct"], "y_pred"],
        y=bt_df.loc[bt_df["correct"], "uncertainty"],
        marker="o", s=10,
    )
    axes[1].scatter(
        x=bt_df.loc[~bt_df["correct"], "y_pred"],
        y=bt_df.loc[~bt_df["correct"], "uncertainty"],
        marker="x", color="red",
    )
    if title is not None:
        axes[1].title.set_text(title)

    # Right: probability calibration (local regression of correct~uncertainty).
    l_df = df[["uncertainty", "correct"]].sort_values(by=["uncertainty"])
    x = l_df["uncertainty"].to_numpy()
    y = l_df["correct"].astype(float).to_numpy()
    z, se = _loess_smooth(x, y)
    axes[2].plot(x, y, "+", ms=6)
    axes[2].plot(x, z)
    axes[2].fill_between(x, z - 1.96 * se, z + 1.96 * se, alpha=0.2)
    axes[2].tick_params(labelrotation=90)
    axes[2].set_ylim(-0.1, 1.1)
    if threshold is not None:
        axes[2].axvline(x=threshold, color="r", linestyle="--")

    for ax in (axes[1], axes[2]):
        ax.spines["bottom"].set_linewidth(0.5)
        ax.spines["bottom"].set_color("black")
        ax.tick_params(axis="x", colors="black")
        ax.grid(visible=True, which="both", axis="both", color="white")
        ax.set_facecolor("#EAEAF2")

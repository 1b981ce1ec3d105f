"""The ``tile_predictions`` column contract, model/eval discovery, the
results readers and the prediction metrics of the port.

The port's copy of ``biscuit_tpu/utils.py`` (reference BISCUIT
``utils.py``), over the same on-disk contract (SURVEY.md §2.4):

* the outcome-prefixed column names (``{outcome}_y_true0``,
  ``{outcome}_y_pred{i}``, ``{outcome}_uncertainty{i}``), the frame that
  carries them, and the renaming back to ``y_true``/``y_pred``/
  ``uncertainty`` that the threshold code reads;
* the model dir ``{NNNNN-}{outcome}-{label}-HP0[-kfold{k}]``, matched by
  slicing off its first 6 characters, with its epoch subdir
  ``{outcome}-{label}-HP0{tail}_epoch{E}``; the eval dir, matched by
  slicing off its first 11;
* ``results_log.csv`` rows keyed by ``model_name ...epoch{E}``, whose
  metric cells are parsed as JSON, then as a Python literal (what the
  reference writes), never with ``eval()``.

``prediction_metrics`` keeps the reference's bootstrap (B=500 draws of
n=150) and DeLong CIs; its ``rng`` argument pins the bootstrap, which is
unseeded by default as in the reference. ``auc_and_threshold`` gives
``(auc, nan)`` on single-class labels instead of raising, as the JAX
package does. scipy is imported by the functions that need it, and
matplotlib by ``truncate_colormap``, the heatmaps' colormap helper.
"""

from __future__ import annotations

import ast
import json
import os
import warnings
from os.path import exists, join
from statistics import mean, variance

import numpy as np
import pandas as pd

from .delong import delong_roc_variance
from .errors import ModelNotFoundError, MultipleModelsFoundError
from .stats.roc import auc_score, roc_curve, trapezoid_auc, youden_threshold
from .utils_log import log, path_to_ext


def uncertainty_header(outcome, underscore=False):
    return str(outcome) + ("_" if underscore else "-") + "uncertainty1"


def y_true_header(outcome, underscore=False):
    return str(outcome) + ("_" if underscore else "-") + "y_true0"


def y_pred_header(outcome, underscore=False):
    return str(outcome) + ("_" if underscore else "-") + "y_pred1"


def tile_predictions_frame(outcome, df, probs, unc) -> pd.DataFrame:
    """Assemble the tile_predictions CSV columns
    ({outcome}_y_true0, {outcome}_y_pred{i}, {outcome}_uncertainty{i} —
    reference experiment.py:694-698, utils.py:19-28)."""
    out = pd.DataFrame({"slide": df["slide"],
                        "loc_x": df["loc_x"], "loc_y": df["loc_y"]})
    out[f"{outcome}_y_true0"] = df["y_true"]
    for c in range(probs.shape[1]):
        out[f"{outcome}_y_pred{c}"] = probs[:, c]
    if unc is not None:
        for c in range(unc.shape[1]):
            out[f"{outcome}_uncertainty{c}"] = unc[:, c]
    return out


def rename_cols(df, outcome, *, y_true=None, y_pred=None, uncertainty=None):
    """Rename outcome-prefixed prediction columns to canonical names, in
    place. Supports both dash and underscore separators (utils.py:31-53)."""
    if y_true is None:
        y_true = y_true_header(
            outcome,
            underscore=(y_true_header(outcome, underscore=True) in df.columns),
        )
        if y_true not in df.columns:
            y_true = str(outcome) + "-y_true"
    if y_pred is None:
        y_pred = y_pred_header(
            outcome,
            underscore=(y_pred_header(outcome, underscore=True) in df.columns),
        )
    if uncertainty is None:
        uncertainty = uncertainty_header(
            outcome,
            underscore=(uncertainty_header(outcome, underscore=True) in df.columns),
        )
    df.rename(
        columns={y_true: "y_true", y_pred: "y_pred", uncertainty: "uncertainty"},
        inplace=True,
    )


# --- Results readers (reference utils.py:66-504) ---------------------------


def truncate_colormap(cmap, minval=0.0, maxval=1.0, n=100):
    """Truncate a matplotlib colormap (utils.py:57-63)."""
    import matplotlib.colors as colors

    return colors.LinearSegmentedColormap.from_list(
        f"trunc({cmap.name},{minval:.2f},{maxval:.2f})",
        cmap(np.linspace(minval, maxval, n)),
    )


def _parse_cell(cell):
    """Parse a results_log metric cell: JSON first (our writer), then Python
    literal (reference writer). Never uses eval()."""
    if isinstance(cell, dict):
        return cell
    try:
        return json.loads(cell)
    except (json.JSONDecodeError, TypeError):
        return ast.literal_eval(cell)


def get_model_results(path, epoch, outcome):
    """Read metrics for one epoch from a model dir's results_log.csv
    (utils.py:66-117).

    Returns dict with keys pt_auc, pt_ap, slide_auc, slide_ap, tile_auc,
    tile_ap, opt_thresh.
    """
    csv = pd.read_csv(join(path, "results_log.csv"))
    result_rows = {}
    for _, row in csv.iterrows():
        try:
            row_epoch = int(str(row["model_name"]).split("epoch")[-1])
        except ValueError:
            continue
        result_rows[row_epoch] = row
    if epoch not in result_rows:
        raise ModelNotFoundError(f"Unable to find results for epoch {epoch}")
    r = result_rows[epoch]
    out = {
        "pt_auc": _parse_cell(r["patient_auc"])[outcome][0],
        "pt_ap": mean(_parse_cell(r["patient_ap"])[outcome]),
        "slide_auc": _parse_cell(r["slide_auc"])[outcome][0],
        "slide_ap": mean(_parse_cell(r["slide_ap"])[outcome]),
        "tile_auc": _parse_cell(r["tile_auc"])[outcome][0],
        "tile_ap": mean(_parse_cell(r["tile_ap"])[outcome]),
    }
    pred_path = join(path, f"patient_predictions_{outcome}_val_epoch{epoch}.csv")
    if exists(pred_path):
        _, opt_thresh = auc_and_threshold(*read_group_predictions(pred_path))
    else:
        opt_thresh = None
        for pq in (
            join(path,
                 f"patient_predictions_{outcome}_val_epoch{epoch}"
                 ".parquet.gzip"),
            # reference's slideflow-1.2 fallback name (utils.py:105)
            join(path, "patient_predictions_val_epoch1.parquet.gzip"),
        ):
            try:
                _, opt_thresh = auc_and_threshold(
                    *read_group_predictions(pq)
                )
                break
            except OSError:
                continue
    out["opt_thresh"] = opt_thresh
    return out


def get_eval_results(path, outcome):
    """Read metrics from an eval dir's results_log.csv (utils.py:120-161)."""
    csv = pd.read_csv(join(path, "results_log.csv"))
    r = None
    for _, row in csv.iterrows():
        r = row
    if r is None:
        raise ModelNotFoundError(f"Empty results_log at {path}")
    out = {
        "pt_auc": _parse_cell(r["patient_auc"])[outcome][0],
        "pt_ap": mean(_parse_cell(r["patient_ap"])[outcome]),
        "slide_auc": _parse_cell(r["slide_auc"])[outcome][0],
        "slide_ap": mean(_parse_cell(r["slide_ap"])[outcome]),
        "tile_auc": _parse_cell(r["tile_auc"])[outcome][0],
        "tile_ap": mean(_parse_cell(r["tile_ap"])[outcome]),
    }
    pred_path = join(path, f"patient_predictions_{outcome}_eval.csv")
    if exists(pred_path):
        _, opt_thresh = auc_and_threshold(*read_group_predictions(pred_path))
    else:
        try:
            pq = join(path, "patient_predictions_eval.parquet.gzip")
            _, opt_thresh = auc_and_threshold(*read_group_predictions(pq))
        except OSError:
            opt_thresh = None
    out["opt_thresh"] = opt_thresh
    return out


def find_cv_early_stop(project, label, outcome, k=3):
    """Mean early-stop batch across cross-val folds, or None unless early
    stopping triggered in *every* fold (utils.py:164-187)."""
    cv_folders = find_cv(project, label, k=k, outcome=outcome)
    early_stop_batch = []
    for folder in cv_folders:
        csv = pd.read_csv(join(folder, "results_log.csv"))
        row = next(csv.iterrows())[1]
        if "early_stop_batch" in row and not pd.isna(row["early_stop_batch"]):
            early_stop_batch.append(row["early_stop_batch"])
    if len(early_stop_batch) == len(cv_folders):
        return round(mean(early_stop_batch))
    return None


def df_from_cv(project, label, outcome, epoch=None, k=3, y_true=None,
               y_pred=None, uncertainty=None):
    """Load tile predictions from each cross-val fold and canonicalize
    columns (utils.py:190-228)."""
    dfs = []
    model_folders = find_cv(project, label, epoch=epoch, k=k, outcome=outcome)
    patients = project.dataset().patients()
    e = "" if epoch is None else "../"
    for folder in model_folders:
        csv_path = join(folder, f"{e}tile_predictions_val_epoch1.csv")
        parquet_path = join(folder, f"{e}tile_predictions_val_epoch1.parquet.gzip")
        if exists(csv_path):
            df = pd.read_csv(csv_path)
        elif exists(parquet_path):
            df = pd.read_parquet(parquet_path)
        else:
            raise OSError(f"Could not find tile predictions file at {folder}")
        rename_cols(df, outcome, y_true=y_true, y_pred=y_pred,
                    uncertainty=uncertainty)
        if "patient" not in df.columns:
            df["patient"] = df["slide"].map(patients)
        dfs.append(df)
    return dfs


# --- Model discovery (filesystem contract, SURVEY.md §2.4) ---------------------


def find_model(project, label, outcome, epoch=None, kfold=None):
    """Locate a model dir by its `{outcome}-{label}-HP0[-kfold{k}]` suffix
    (first 6 chars are a run counter, utils.py:253-261)."""
    tail = "" if kfold is None else f"-kfold{kfold}"
    model_name = f"{outcome}-{label}-HP0{tail}"
    matching = [
        o for o in os.listdir(project.models_dir) if o[6:] == model_name
    ]
    if len(matching) > 1:
        raise MultipleModelsFoundError(
            f"Multiple matching models found matching {model_name}"
        )
    if not matching:
        raise ModelNotFoundError(f"No matching model found matching {model_name}.")
    if epoch is not None:
        return join(
            project.models_dir, matching[0],
            f"{outcome}-{label}-HP0{tail}_epoch{epoch}",
        )
    return join(project.models_dir, matching[0])


def model_exists(project, label, outcome, epoch=None, kfold=None):
    try:
        find_model(project, label, outcome, kfold=kfold, epoch=epoch)
        return True
    except ModelNotFoundError:
        return False


def find_cv(project, label, outcome, epoch=None, k=3):
    """Paths to the k cross-validation fold model dirs (utils.py:295-311)."""
    return [
        find_model(project, label, outcome, epoch=epoch, kfold=_k)
        for _k in range(1, k + 1)
    ]


def find_eval(project, label, outcome, epoch=1):
    """Locate an eval dir by its 11-char-sliced suffix (utils.py:331-334)."""
    matching = [
        o for o in os.listdir(project.eval_dir)
        if o[11:] == f"{outcome}-{label}-HP0_epoch{epoch}"
    ]
    if len(matching) > 1:
        raise MultipleModelsFoundError(
            f"Multiple matching eval experiments found for label {label}"
        )
    if not matching:
        raise ModelNotFoundError(f"No matching eval found for label {label}")
    return join(project.eval_dir, matching[0])


def eval_exists(project, label, outcome, epoch=1):
    try:
        find_eval(project, label, outcome, epoch=epoch)
        return True
    except ModelNotFoundError:
        return False


def get_slides_from_model_manifest(model_dir, dataset=None):
    """Slides used to train/validate a model, from its manifest
    (stand-in for sf.util.get_slides_from_model_manifest,
    experiment.py:528,556,664,725,1009,1078-1080).

    Args:
        model_dir: model directory containing slide_manifest.csv.
        dataset: None (all), 'training', or 'validation'.
    """
    manifest_path = join(model_dir, "slide_manifest.csv")
    if not exists(manifest_path):
        # epoch subdir given; look one level up
        parent = os.path.dirname(model_dir.rstrip("/"))
        manifest_path = join(parent, "slide_manifest.csv")
    df = pd.read_csv(manifest_path, dtype=str)
    if dataset is not None:
        df = df[df["dataset"] == dataset]
    return df["slide"].tolist()


# --- Thresholding & metrics -----------------------------------------------------


def read_group_predictions(path):
    """Read a patient/slide-level predictions file -> (y_true, y_pred).

    Column resolution per utils.py:364-397: prefers 'y_true1' /
    'percent_tiles_positive1', falls back to a single '*y_true' column and
    the second of two 'y_pred' columns.
    """
    if not exists(path):
        raise OSError(f"Could not find predictions file at {path}")
    ext = path_to_ext(path).lower()
    if ext == "csv":
        df = pd.read_csv(path)
    elif ext in ("parquet", "gzip"):
        df = pd.read_parquet(path)
    else:
        raise ValueError(f"Unrecognized extension for prediction file {path}")
    if "y_true1" in df.columns:
        y_true = df["y_true1"].to_numpy()
    else:
        y_true_cols = [c for c in df.columns if c.endswith("y_true")]
        if len(y_true_cols) == 1:
            y_true = df[y_true_cols[0]].to_numpy()
        else:
            raise ValueError(f"Could not find y_true column at {path}")
    if "percent_tiles_positive1" in df.columns:
        y_pred = df["percent_tiles_positive1"].to_numpy()
    else:
        y_pred_cols = [c for c in df.columns if "y_pred" in c]
        if len(y_pred_cols) == 2:
            y_pred = df[y_pred_cols[1]].to_numpy()
        else:
            raise ValueError(
                f"Expected exactly 2 y_pred columns at {path}; "
                f"got {len(y_pred_cols)}"
            )
    return y_true, y_pred


def prediction_metrics(y_true, y_pred, threshold, rng=None):
    """Accuracy/sensitivity/specificity + bootstrap Youden CI + DeLong AUC CI
    (utils.py:400-464). B=500 bootstrap iterations of n=150 samples with an
    Agresti-Coull-style correction, exactly as the reference code does.

    Args:
        rng: optional np.random.Generator for a reproducible bootstrap
            (reference uses the unseeded global RNG).
    """
    from scipy import stats

    yt = np.asarray(y_true).astype(bool)
    yp = np.asarray(y_pred) > threshold
    if rng is None:
        rng = np.random.default_rng()

    alpha = 0.05
    z = stats.norm.ppf(1 - alpha / 2)
    tp = np.logical_and(yt, yp).sum()
    fp = np.logical_and(~yt, yp).sum()
    tn = np.logical_and(~yt, ~yp).sum()
    fn = np.logical_and(yt, ~yp).sum()
    acc = (tp + tn) / (tp + tn + fp + fn)
    sensitivity = tp / (tp + fn)
    specificity = tn / (tn + fp)

    # Vectorized bootstrap (B=500, n=150) of the Youden index with the
    # reference's half-z**2 continuity correction.
    B, n = 500, 150
    idx = rng.integers(0, yt.shape[0], size=(B, n))
    byt = yt[idx]
    byp = yp[idx]
    btp = np.logical_and(byt, byp).sum(axis=1)
    bfp = np.logical_and(~byt, byp).sum(axis=1)
    btn = np.logical_and(~byt, ~byp).sum(axis=1)
    bfn = np.logical_and(byt, ~byp).sum(axis=1)
    all_jac = ((btn + 0.5 * z**2) / (btn + bfp + z**2)) - (
        (bfn + 0.5 * z**2) / (bfn + btp + z**2)
    )
    jac = mean(all_jac.tolist())
    jac_var = variance(all_jac.tolist())
    jac_low = jac - z * np.sqrt(jac_var)
    jac_high = jac + z * np.sqrt(jac_var)

    y_true_arr = np.asarray(y_true)
    if not np.array_equal(np.unique(y_true_arr), [0, 1]):
        log.warning("Unable to calculate CI; y_true is not binary {0,1}")
        ci = [None, None]
    else:
        delong_auc, auc_cov = delong_roc_variance(y_true_arr, np.asarray(y_pred))
        auc_std = np.sqrt(auc_cov)
        lower_upper_q = np.abs(np.array([0, 1]) - alpha / 2)
        ci = stats.norm.ppf(lower_upper_q, loc=delong_auc, scale=auc_std)
        ci[ci > 1] = 1

    return {
        "auc_low": ci[0],
        "auc_high": ci[1],
        "acc": acc,
        "sens": sensitivity,
        "spec": specificity,
        "youden": sensitivity + specificity - 1,
        "youden_low": jac_low,
        "youden_high": jac_high,
    }


def auc_and_threshold(y_true, y_pred):
    """(AUC, Youden-optimal threshold) — utils.py:467-484.

    DELIBERATE FIX (SURVEY.md §2.2 convention): on single-class y_true
    the reference's bare Youden idiom (utils.py:482-483, no try/except)
    raises an uncaught ValueError that crashes results assembly — hit by
    the full-matrix sitting on a 10:1 ratio experiment whose
    site-preserving CV fold validated on majority-class slides only.
    Degrade to (nan, nan) instead, the same contract as the sibling
    ``auc`` helper (reference utils.py:487-504) which the reference
    already uses for undefined ROCs.
    """
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fpr, tpr, threshold = roc_curve(y_true, y_pred)
        roc_auc = trapezoid_auc(fpr, tpr)
    try:
        return roc_auc, youden_threshold(fpr, tpr, threshold)
    except ValueError:
        log.warning("Unable to calculate ROC")
        return roc_auc, float("nan")


def auc(y_true, y_pred):
    """AUROC; NaN (with log warning) on failure — utils.py:487-504."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = auc_score(y_true, y_pred)
    if np.isnan(result):
        log.warning("Unable to calculate ROC")
    return result

"""The ``tile_predictions`` column contract of the port.

Counterpart of the contract half of ``biscuit_tpu/utils.py`` (reference
BISCUIT ``utils.py:19-53``): the outcome-prefixed column names
(``{outcome}_y_true0``, ``{outcome}_y_pred{i}``,
``{outcome}_uncertainty{i}``), the frame that carries them, and the
renaming back to ``y_true``/``y_pred``/``uncertainty`` that the
threshold code reads. Model and eval discovery, the results readers and
the bootstrap metrics are not ported yet.
"""

from __future__ import annotations

import pandas as pd


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

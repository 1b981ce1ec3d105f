"""The port's host thresholds against the JAX package's host path
(``backend="host"``), on the frames ``tests/test_threshold.py`` builds.

Tolerance 0: the port's ``threshold.py`` and ``stats/roc.py`` are copies
that do the same numpy/pandas arithmetic in the same order, so every
frame is equal under ``assert_frame_equal`` and every number is the same
float (NaN where the JAX package gives NaN).
"""

import math

import numpy as np
import pandas as pd
import pytest
import torch
from pandas.testing import assert_frame_equal

from biscuit_torch import errors as port_errors
from biscuit_torch import threshold as port
from biscuit_tpu import errors as jax_errors
from biscuit_tpu import threshold as ref
from test_threshold import make_preds

torch.set_num_threads(1)

KEYS = ("tile_uq", "slide_uq", "tile_pred", "slide_pred")


def _same(got, want):
    """Exactly equal, NaN equal to NaN, for numbers, None and dicts."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got)
    else:
        assert got == want and type(got) is type(want), (got, want)


def _both(fn_name, df, *args, **kw):
    """(port result, JAX host result) of one call, each on its own copy."""
    host = {"backend": "host"} if fn_name in ("apply", "detect") else {}
    return (getattr(port, fn_name)(df.copy(), *args, **kw),
            getattr(ref, fn_name)(df.copy(), *args, **kw, **host))


def _patients():
    """Two slides of one class to a patient (slide i and i + 20)."""
    return {f"slide{i}": f"P{i % 20}" for i in range(40)}


@pytest.mark.parametrize("pred_thresh", [0.5, "detect"])
@pytest.mark.parametrize("with_patients", [False, True])
def test_process_tile_predictions(pred_thresh, with_patients):
    df = make_preds(acc=0.85)
    kw = {"patients": _patients()} if with_patients else {}
    if with_patients:
        df = df.drop(columns=["patient"])
    (got, gt), (want, wt) = _both("process_tile_predictions", df,
                                  pred_thresh=pred_thresh, **kw)
    assert_frame_equal(got, want, check_exact=True)
    _same(gt, wt)


@pytest.mark.parametrize("level", ["slide", "patient"])
@pytest.mark.parametrize("pred_thresh", [0.5, "detect"])
def test_process_group_predictions(level, pred_thresh):
    df = make_preds(seed=5, n_patients=20).sample(
        frac=1.0, random_state=1).reset_index(drop=True)
    (got, gt), (want, wt) = _both("process_group_predictions", df,
                                  pred_thresh, level)
    assert_frame_equal(got, want, check_exact=True)
    _same(gt, wt)


def test_group_errors_are_the_same():
    empty = pd.DataFrame(columns=["slide", "y_true", "y_pred", "uncertainty"])
    with pytest.raises(port_errors.ROCFailedError):
        port.process_group_predictions(empty, 0.5, "slide")
    with pytest.raises(ValueError, match="Missing columns"):
        port.process_group_predictions(
            pd.DataFrame({"slide": ["a"], "y_pred": [0.5]}), 0.5, "slide")
    nan = make_preds()
    nan.loc[0, "y_pred"] = np.nan
    with pytest.raises(port_errors.PredsContainNaNError):
        port.process_tile_predictions(nan)


# (make_preds kwargs, detect kwargs): the detected case, a fixed tile
# threshold, slide_uq not detected (falls back to 0.5), a perfect model
# (single-class error ROC: degrades to undetectable), every slide correct
# after the tile filter (slide_uq None), and NaN predictions.
DETECT_CASES = [
    ({"acc": 0.85}, {}),
    ({}, {"tile_uq": 0.15}),
    ({}, {"slide_uq": None}),
    ({"acc": 1.0}, {}),
    ({"acc": 0.9, "no_hard_slides": True}, {}),
    ({"nan": True}, {}),
]


@pytest.mark.parametrize("preds,kw", DETECT_CASES)
def test_detect(preds, kw):
    preds = dict(preds)
    nan = preds.pop("nan", False)
    df = make_preds(**preds)
    if nan:
        df.loc[0, "y_pred"] = np.nan
    (gt, gauc), (wt, wauc) = _both("detect", df, **kw)
    _same(gt, wt)
    _same(gauc, wauc)


@pytest.mark.parametrize("keep", ["high_confidence", "low_confidence"])
@pytest.mark.parametrize("level", ["slide", "patient"])
def test_apply(keep, level):
    thresh, _ = ref.detect(make_preds(seed=1, acc=0.8), backend="host")
    df = make_preds(seed=2, acc=0.8).drop(columns=["patient"])
    (gr, gdf), (wr, wdf) = _both("apply", df, keep=keep, level=level,
                                 patients=_patients(),
                                 **{k: thresh[k] for k in KEYS})
    _same(gr, wr)
    assert_frame_equal(gdf, wdf, check_exact=True)


def test_apply_without_thresholds():
    """tile_uq=None skips the tile filter (the JAX package's deliberate
    fix), zeros skip both filters."""
    df = make_preds(seed=3, acc=0.8)
    for tile_uq, slide_uq in ((None, 0.1), (0, 0)):
        (gr, gdf), (wr, wdf) = _both("apply", df, tile_uq, slide_uq)
        _same(gr, wr)
        assert_frame_equal(gdf, wdf, check_exact=True)


# Three good folds; two good folds and an all-correct one (skipped); the
# two-stage nested protocol's first stage (slide_uq not detected).
FROM_CV_CASES = [
    ([{"seed": s, "acc": 0.8} for s in range(3)], {}),
    ([{"seed": 0, "acc": 0.8}, {"seed": 1, "acc": 0.8},
      {"seed": 9, "acc": 1.0}], {}),
    ([{"seed": s, "acc": 0.8} for s in range(3)],
     {"tile_uq": "detect", "slide_uq": None}),
]


@pytest.mark.parametrize("folds,kw", FROM_CV_CASES)
def test_from_cv(folds, kw):
    dfs = [make_preds(**f) for f in folds]
    got = port.from_cv([d.copy() for d in dfs], **kw)
    want = ref.from_cv([d.copy() for d in dfs], backend="host", **kw)
    _same(got, want)


def test_from_cv_raises_where_the_jax_package_raises():
    dfs = [make_preds(seed=s, acc=0.9, no_hard_slides=True) for s in range(2)]
    with pytest.raises(jax_errors.ThresholdError):
        ref.from_cv([d.copy() for d in dfs], backend="host")
    with pytest.raises(port_errors.ThresholdError):
        port.from_cv([d.copy() for d in dfs])
    with pytest.raises(ValueError, match="missing columns"):
        port.from_cv([pd.DataFrame({"y_true": [1]})])


def test_what_is_not_ported_raises():
    df = make_preds()
    for call in (lambda: port.detect(df.copy(), backend="device"),
                 lambda: port.apply(df.copy(), 0.1, 0.1, backend="device"),
                 lambda: port.from_cv([df.copy()], backend="device")):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            call()
    with pytest.raises(ValueError, match="backend must be"):
        port.detect(df.copy(), backend="gpu")


def _plotted(mod, call, monkeypatch):
    """(the result of ``call``, the frames and arguments it gave
    ``mod.plot_uncertainty``)."""
    captured = []
    with monkeypatch.context() as mp:
        mp.setattr(mod, "plot_uncertainty",
                   lambda df, threshold=None, kind=None, title=None:
                   captured.append((df.copy(), threshold, kind, title)))
        return call(), captured


@pytest.mark.parametrize("fn,kw", [
    ("detect", {}), ("detect", {"slide_uq": 0.5}),
    ("apply", {"tile_uq": 0.1, "slide_uq": 0.05, "title": "Exp. X"}),
    ("apply", {"tile_uq": None, "slide_uq": 0.05, "level": "patient",
               "patients": _patients(), "keep": "low_confidence"})])
def test_plot_true_draws_the_jax_frames(fn, kw, monkeypatch):
    """``plot=True`` hands ``plot_uncertainty`` the same frames, at the
    same places, as the JAX package's host path, and the results are the
    same as without the figure."""
    df = make_preds(acc=0.85)
    if "patients" in kw:
        df = df.drop(columns=["patient"])
    got, got_frames = _plotted(port, lambda: getattr(port, fn)(
        df.copy(), plot=True, **kw), monkeypatch)
    want, want_frames = _plotted(ref, lambda: getattr(ref, fn)(
        df.copy(), plot=True, backend="host", **kw), monkeypatch)
    _same(got[0], want[0])
    assert len(got_frames) == len(want_frames) == 1
    for (gdf, *gargs), (wdf, *wargs) in zip(got_frames, want_frames):
        assert gargs == wargs
        assert_frame_equal(gdf, wdf)
    _same(getattr(port, fn)(df.copy(), **kw)[0], got[0])


def test_plot_true_draws_a_figure():
    import matplotlib.pyplot as plt

    plt.close("all")
    port.detect(make_preds(acc=0.85), plot=True)
    assert len(plt.gcf().axes) == 3
    plt.close("all")

"""The port's experiment supervisor (biscuit_torch/experiment.py) on the
CPU: the 6-step protocol as tests/test_experiment.py runs it for the JAX
package, with every assertion of its ``TestSixStepProtocol`` and
``TestNestedCV``, then held against the JAX package on the tree the port
wrote.

The projects are built as tests/test_experiment.py builds them (24
training and 10 evaluation slides of 6 PNG tiles of 32 px, 20% hard
slides; 30 slides for nested CV), through the port's tfrecord writer,
and trained at ``xception_tiny`` with ``train_kwargs={"device": "cpu",
...}``.

Parity is checked on one tree, not across two trainings: Adam moves a
weight whose gradient is near zero by about the learning rate a step
whatever the gradient's sign, so two packages whose gradients differ by
f32 rounding train apart (ROADMAP.md Queue 3). On the port's tree the
JAX package's readers, ``results`` and ``thresholds_from_nested_cv`` are
run beside the port's: equal to 1e-12 (they do the same float64 pandas
and numpy arithmetic in the same order, so in fact exactly). The
bootstrap of ``prediction_metrics`` is unseeded in both packages, so
both are given ``np.random.default_rng(0)`` for the comparison.
"""

import io
import os
import shutil
from os.path import exists, join

import numpy as np
import pandas as pd
import pytest
import torch
from pandas.testing import assert_frame_equal
from PIL import Image

from biscuit_torch import threshold as port_threshold
from biscuit_torch import utils as port_utils
from biscuit_torch.data.tfrecord import TFRecordWriter
from biscuit_torch.experiment import Experiment
from biscuit_torch.hp import ModelParams
from biscuit_torch.project import Project
from biscuit_tpu import experiment as jax_experiment
from biscuit_tpu import threshold as jax_threshold
from biscuit_tpu import utils as jax_utils
from biscuit_tpu.project import Project as JaxProject

torch.set_num_threads(1)
OUTCOME = "cohort"
TOL = 1e-12


def tiny_hp(**kw):
    base = dict(
        model="xception_tiny", tile_px=32, tile_um=32, batch_size=16,
        epochs=[1], early_stop=False, dropout=0.1, uq=False,
        hidden_layer_width=32, hidden_layers=2, learning_rate=3e-3,
        normalizer=None, augment="xy", uq_samples=4,
    )
    base.update(kw)
    return ModelParams(**base)


def write_tiles(tfr_dir, slide, label, hard, rng, n=6):
    with TFRecordWriter(str(tfr_dir / f"{slide}.tfrecords")) as w:
        for t in range(n):
            img = rng.integers(40, 120, (32, 32, 3)).astype(np.uint8)
            # hard slides: most tiles carry no class signal
            if rng.random() <= (0.8 if hard else 0.05):
                ch = 0 if label == 0 else 2
                img[..., ch] = np.clip(img[..., ch] + 100, 0, 255)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            w.write_tile(slide, buf.getvalue(), loc_x=t, loc_y=0)


def build_project(tmp, name, n_slides, seed):
    """``n_slides`` slides alternating LUAD/LUSC, two a site, every fifth
    hard, with 'order'/'order2' columns; the port's Project over them."""
    rng = np.random.default_rng(seed)
    rows = []
    tfr = tmp / f"{name}_tfr"
    tfr.mkdir()
    for i in range(n_slides):
        label = i % 2
        slide = f"{name}sl{i}"
        rows.append(dict(
            patient=f"{name}P{i}", slide=slide,
            cohort="LUAD" if label == 0 else "LUSC",
            site=f"{i // 2}", order=str(i), order2=str(n_slides - i),
        ))
        write_tiles(tfr, slide, label, (i % 5) == 0, rng)
    ann_path = str(tmp / f"{name}_ann.csv")
    pd.DataFrame(rows).to_csv(ann_path, index=False)
    P = Project(str(tmp / name), annotations=ann_path, name=name, create=True)
    P.add_source("SRC", tfrecords=str(tfr))
    return P


def seeded_metrics(monkeypatch):
    """Both packages' ``prediction_metrics`` with a fresh
    ``default_rng(0)`` each call, and the JAX statistics on the host."""
    monkeypatch.delenv("BISCUIT_DEVICE_STATS", raising=False)
    for mod in (port_utils, jax_utils):
        real = mod.prediction_metrics
        monkeypatch.setattr(
            mod, "prediction_metrics",
            lambda yt, yp, threshold, real=real: real(
                yt, yp, threshold, rng=np.random.default_rng(0)))


def jax_twin(exp, outdir):
    """The JAX ``Experiment`` over the port's project roots."""
    return jax_experiment.Experiment(
        exp.train_project.root,
        eval_projects=[p.root for p in exp.eval_projects],
        outcome=exp.outcome, outcome1=exp.outcome1, outcome2=exp.outcome2,
        outdir=outdir)


def assert_same_value(got, want):
    """Equal to TOL for floats (NaN equal to NaN, infinities equal),
    exactly otherwise; tuples and dicts item by item."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_same_value(got[k], want[k])
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_value(g, w)
    elif isinstance(want, (float, np.floating)):
        if np.isnan(want):
            assert np.isnan(got)
        elif np.isinf(want):
            assert got == want
        else:
            assert abs(got - want) <= TOL, (got, want)
    else:
        assert got == want, (got, want)


@pytest.fixture(scope="module")
def exp_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("exp")
    train_P = build_project(tmp, "tr", 24, seed=0)
    eval_P = build_project(tmp, "ev", 10, seed=1)
    exp = Experiment(
        train_P, eval_projects=[eval_P], outcome=OUTCOME,
        outcome1="LUAD", outcome2="LUSC", outdir=str(tmp / "results"),
    )
    # validate_on_batch/validation_steps through train_kwargs: they
    # collide with Experiment.train's named defaults unless popped.
    exp.train_kwargs = {"device": "cpu", "seed": 0, "validate_on_batch": 16,
                        "validation_steps": 8}
    exp.original_annotations = str(tmp / "tr_ann.csv")
    return exp


@pytest.fixture(scope="module")
def ran(exp_env):
    exp_env.run({"ZC": {"out1": 10, "out2": 10}}, steps=[2, 3, 5, 6],
                hp=tiny_hp())
    return exp_env


# --- TestSixStepProtocol's assertions ---------------------------------------

def test_step2_cv_models(ran):
    assert port_utils.model_exists(ran.train_project, "EXP_ZC",
                                   outcome=OUTCOME, kfold=1)
    assert len(port_utils.find_cv(ran.train_project, "EXP_ZC",
                                  outcome=OUTCOME)) == 3


def test_step3_uq_models_have_uncertainty(ran):
    m = port_utils.find_cv(ran.train_project, "EXP_ZC_UQ", outcome=OUTCOME)[0]
    df = pd.read_csv(join(m, "tile_predictions_val_epoch1.csv"))
    assert "cohort_uncertainty1" in df.columns


def test_step5_full_model_saved(ran):
    path = port_utils.find_model(ran.train_project, "EXP_ZC_FULL",
                                 outcome=OUTCOME, epoch=1)
    assert exists(join(path, "model.msgpack"))


def test_step6_eval(ran):
    assert port_utils.eval_exists(ran.eval_projects[0], "EXP_ZC_FULL",
                                  outcome=OUTCOME, epoch=1)
    d = port_utils.find_eval(ran.eval_projects[0], "EXP_ZC_FULL",
                             outcome=OUTCOME)
    assert set(os.listdir(d)) == {
        "results_log.csv", "tile_predictions_eval.csv",
        f"patient_predictions_{OUTCOME}_eval.csv",
        f"slide_predictions_{OUTCOME}_eval.csv"}


def test_experiments_csv_written(ran):
    exp_ann = join(ran.train_project.root, "experiments.csv")
    assert exists(exp_ann)
    assert "include_ZC" in pd.read_csv(exp_ann, nrows=0).columns


def test_experiments_csv_equals_the_jax_add(ran, tmp_path):
    path = str(tmp_path / "ann.csv")
    shutil.copy(ran.original_annotations, path)
    jax_exp = jax_experiment.Experiment.__new__(jax_experiment.Experiment)
    jax_exp.outcome, jax_exp.outcome1, jax_exp.outcome2 = (
        OUTCOME, "LUAD", "LUSC")
    jax_exp.add(path, label="ZC", out1=10, out2=10)
    with open(path, "rb") as a, open(join(ran.train_project.root,
                                          "experiments.csv"), "rb") as b:
        assert a.read() == b.read()


def test_idempotent_rerun(ran, capsys):
    before = sorted(os.listdir(ran.train_project.models_dir))
    ran.run({"ZC": {"out1": 10, "out2": 10}}, steps=[2, 3, 5], hp=tiny_hp())
    assert sorted(os.listdir(ran.train_project.models_dir)) == before
    assert "already done" in capsys.readouterr().out


def test_results_assembly(ran):
    df, eval_dfs = ran.results(["ZC"], uq=True, eval=True)
    assert len(df) >= 6  # 3 folds non-UQ + 3 folds UQ-all
    assert set(df["uq"]) >= {"none", "all"}
    assert exists(join(ran.outdir, "crossval_results.csv"))
    ev = eval_dfs["ev"]
    assert len(ev) >= 1
    assert ev.iloc[0]["uq"] == "none"
    assert 0 <= ev.iloc[0]["patient_auc"] <= 1


def test_display_writes_figures(ran):
    df, eval_dfs = ran.results(["ZC"], uq=False, eval=True)
    ran.display(df, eval_dfs, ttest_uq_groups=None)
    assert exists(join(ran.outdir, "crossval.svg"))
    assert exists(join(ran.outdir, "ev_eval.svg"))


def _captured_calibration(exp, mod, monkeypatch, tile_uq):
    captured = []
    with monkeypatch.context() as mp:
        mp.setattr(mod, "plot_uncertainty",
                   lambda df, kind, threshold=None, **kw: captured.append(
                       (df.copy(), kind, threshold)))
        exp.plot_uq_calibration(label="EXP_ZC_UQ", tile_uq=tile_uq,
                                slide_uq=0.05, slide_pred=0.5)
    return captured


def _fold_predictions(ran):
    raw = []
    for ki in (1, 2, 3):
        m = port_utils.find_model(ran.train_project, "EXP_ZC_UQ",
                                  outcome=OUTCOME, kfold=ki)
        raw.append(pd.read_csv(join(m, "tile_predictions_val_epoch1.csv"),
                               dtype={"slide": str}))
    return pd.concat(raw, ignore_index=True)


def test_plot_uq_calibration_plots_recomputed_data(ran, monkeypatch):
    """The frames ``plot_uq_calibration`` gives ``plot_uncertainty``
    carry what a by-hand pandas recomputation of the CV predictions
    gives (tests/test_experiment.py's content assertions)."""
    raw = _fold_predictions(ran)
    ypred = raw["cohort_y_pred1"].to_numpy()
    ytrue = raw["cohort_y_true0"].to_numpy()
    unc = raw["cohort_uncertainty1"].to_numpy()
    tile_uq = float(np.median(unc))  # both sides non-empty
    (tile_df, tile_kind, tile_thr), (sl_df, sl_kind, sl_thr) = (
        _captured_calibration(ran, port_threshold, monkeypatch, tile_uq))
    assert (tile_kind, sl_kind) == ("tile", "slide")
    assert tile_thr == tile_uq and sl_thr == 0.05

    assert len(tile_df) == len(raw)
    assert np.allclose(np.sort(tile_df["uncertainty"]), np.sort(unc))
    hand_tile = pd.DataFrame({
        "slide": raw["slide"], "y_pred": ypred,
        "correct": ((ypred >= 0.5) & (ytrue == 1))
        | ((ypred < 0.5) & (ytrue == 0)),
    })
    merged = tile_df.sort_values(["slide", "y_pred"]).reset_index(drop=True)
    hand_tile = hand_tile.sort_values(["slide", "y_pred"]).reset_index(
        drop=True)
    assert np.array_equal(merged["correct"].to_numpy(),
                          hand_tile["correct"].to_numpy())

    keep = raw[unc < tile_uq]
    hand = keep.groupby("slide").agg(
        y_pred=("cohort_y_pred1", "mean"),
        y_true=("cohort_y_true0", "mean"),
        uncertainty=("cohort_uncertainty1", "mean")).reset_index()
    hand["correct"] = ((hand["y_pred"] >= 0.5)
                       & (hand["y_true"].astype(np.uint8) == 1)) | (
        (hand["y_pred"] < 0.5) & (hand["y_true"].astype(np.uint8) == 0))
    got = sl_df.sort_values("slide").reset_index(drop=True)
    hand = hand.sort_values("slide").reset_index(drop=True)
    assert got["slide"].tolist() == hand["slide"].tolist()
    assert np.allclose(got["y_pred"].to_numpy(), hand["y_pred"].to_numpy())
    assert np.allclose(got["uncertainty"].to_numpy(),
                       hand["uncertainty"].to_numpy())
    assert np.array_equal(got["correct"].to_numpy(),
                          hand["correct"].to_numpy())
    assert len(sl_df) == keep["slide"].nunique()


# --- Parity with the JAX package on the port's tree --------------------------

def test_plot_uq_calibration_frames_equal_the_jax_ones(ran, monkeypatch,
                                                       tmp_path):
    tile_uq = float(np.median(_fold_predictions(ran)["cohort_uncertainty1"]))
    got = _captured_calibration(ran, port_threshold, monkeypatch, tile_uq)
    want = _captured_calibration(jax_twin(ran, str(tmp_path)),
                                 jax_threshold, monkeypatch, tile_uq)
    assert len(got) == len(want) == 2
    for (gdf, gkind, gthr), (wdf, wkind, wthr) in zip(got, want):
        assert (gkind, gthr) == (wkind, wthr)
        assert_frame_equal(gdf, wdf, check_exact=False, rtol=0, atol=TOL)
    # Drawn for real, each figure is saved.
    ran.plot_uq_calibration(label="EXP_ZC_UQ", tile_uq=tile_uq,
                            slide_uq=0.05, slide_pred=0.5)
    for kind in ("tile", "slide"):
        assert exists(join(ran.outdir,
                           f"EXP_ZC_UQ_{kind}_uncertainty_v_preds.svg"))


def _jax_project(P):
    return JaxProject(P.root)


def _model_dirs(ran):
    P = ran.train_project
    return [port_utils.find_model(P, label, OUTCOME, kfold=k)
            for label in ("EXP_ZC", "EXP_ZC_UQ") for k in (1, 2, 3)]


def test_discovery_readers_equal_the_jax_ones(ran):
    P, E = ran.train_project, ran.eval_projects[0]
    jP, jE = _jax_project(P), _jax_project(E)
    for label in ("EXP_ZC", "EXP_ZC_UQ", "EXP_ZC_FULL", "EXP_NONE"):
        for kfold in (None, 1, 2, 3, 4):
            for epoch in (None, 1):
                args = (label, OUTCOME)
                kw = dict(epoch=epoch, kfold=kfold)
                assert (port_utils.model_exists(P, *args, **kw)
                        == jax_utils.model_exists(jP, *args, **kw))
                if port_utils.model_exists(P, *args, **kw):
                    assert (port_utils.find_model(P, *args, **kw)
                            == jax_utils.find_model(jP, *args, **kw))
    for label in ("EXP_ZC", "EXP_ZC_UQ"):
        for epoch in (None, 1):
            assert (port_utils.find_cv(P, label, OUTCOME, epoch=epoch)
                    == jax_utils.find_cv(jP, label, OUTCOME, epoch=epoch))
    for label in ("EXP_ZC_FULL", "EXP_ZC"):
        assert (port_utils.eval_exists(E, label, OUTCOME)
                == jax_utils.eval_exists(jE, label, OUTCOME))
    assert (port_utils.find_eval(E, "EXP_ZC_FULL", OUTCOME)
            == jax_utils.find_eval(jE, "EXP_ZC_FULL", OUTCOME))
    with pytest.raises(port_utils.ModelNotFoundError):
        port_utils.find_model(P, "EXP_NONE", OUTCOME)
    for d in _model_dirs(ran) + [port_utils.find_model(
            P, "EXP_ZC_FULL", OUTCOME, epoch=1)]:
        for dataset in (None, "training", "validation"):
            assert (port_utils.get_slides_from_model_manifest(d, dataset)
                    == jax_utils.get_slides_from_model_manifest(d, dataset))


def test_results_readers_equal_the_jax_ones(ran):
    P, E = ran.train_project, ran.eval_projects[0]
    jP = _jax_project(P)
    for d in _model_dirs(ran):
        assert_same_value(port_utils.get_model_results(d, 1, OUTCOME),
                          jax_utils.get_model_results(d, 1, OUTCOME))
        for level in ("patient", "slide"):
            path = join(d, f"{level}_predictions_{OUTCOME}_val_epoch1.csv")
            for g, w in zip(port_utils.read_group_predictions(path),
                            jax_utils.read_group_predictions(path)):
                np.testing.assert_array_equal(g, w)
            yt, yp = port_utils.read_group_predictions(path)
            assert_same_value(port_utils.auc_and_threshold(yt, yp),
                              jax_utils.auc_and_threshold(yt, yp))
            assert_same_value(port_utils.auc(yt, yp), jax_utils.auc(yt, yp))
    eval_dir = port_utils.find_eval(E, "EXP_ZC_FULL", OUTCOME)
    assert_same_value(port_utils.get_eval_results(eval_dir, OUTCOME),
                      jax_utils.get_eval_results(eval_dir, OUTCOME))
    for label in ("EXP_ZC", "EXP_ZC_UQ"):
        assert (port_utils.find_cv_early_stop(P, label, OUTCOME)
                == jax_utils.find_cv_early_stop(jP, label, OUTCOME))
    for g, w in zip(port_utils.df_from_cv(P, "EXP_ZC_UQ", OUTCOME),
                    jax_utils.df_from_cv(jP, "EXP_ZC_UQ", OUTCOME)):
        assert_frame_equal(g, w, check_exact=False, rtol=0, atol=TOL)
    with pytest.raises(OSError):
        port_utils.df_from_cv(P, "EXP_ZC_UQ", OUTCOME, epoch=1)
    with pytest.raises(OSError):
        jax_utils.df_from_cv(jP, "EXP_ZC_UQ", OUTCOME, epoch=1)


def test_results_equal_the_jax_results(ran, monkeypatch, tmp_path):
    seeded_metrics(monkeypatch)
    got_df, got_ev = ran.results(["ZC"], uq=True, eval=True)
    want_df, want_ev = jax_twin(ran, str(tmp_path)).results(
        ["ZC"], uq=True, eval=True)
    assert set(got_df["uq"]) == {"none", "all"} and len(got_df) == 6
    assert_frame_equal(got_df, want_df, check_exact=False, rtol=0, atol=TOL)
    assert got_ev.keys() == want_ev.keys() == {"ev"}
    assert {"patient_youden_low", "slide_youden_high"} <= set(got_ev["ev"])
    assert_frame_equal(got_ev["ev"], want_ev["ev"], check_exact=False,
                       rtol=0, atol=TOL)


def test_display_prints_the_jax_ttests(ran, tmp_path, capsys):
    """On the protocol's frames (no 'include' arm below 100 slides: the
    t-tests print "(error)") and on tests/test_figures.py's frame."""
    from test_figures import _results_frame

    df, eval_dfs = ran.results(["ZC"], uq=False, eval=True)
    frames = [(df, eval_dfs), (_results_frame()[0], {})]
    twin = jax_twin(ran, str(tmp_path))
    for frame, evs in frames:
        capsys.readouterr()
        ran.display(frame, evs, ttest_uq_groups=("none", "all"))
        got = capsys.readouterr().out
        twin.display(frame, evs, ttest_uq_groups=("none", "all"))
        assert got == capsys.readouterr().out and "p =" in got
        ran.display(frame, evs)
        got = capsys.readouterr().out
        twin.display(frame, evs)
        assert got == capsys.readouterr().out and "p =" in got
    assert exists(join(ran.outdir, "relplot.svg"))


# --- What is not ported, and the card ----------------------------------------

def test_what_is_not_ported_raises(exp_env):
    saved = dict(exp_env.train_kwargs)
    exp_env.train_kwargs["n_submeshes"] = 2
    try:
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            exp_env.run({"ZC": {"out1": 10, "out2": 10}}, steps=[2],
                        hp=tiny_hp())
    finally:
        exp_env.train_kwargs = saved
    for kw in ({"scheduler": object()}, {"claim": lambda t: True},
               {"collect": []}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            exp_env.train_nested_cv(tiny_hp(), "EXP_ZC", **kw)


def test_run_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    P = build_project(tmp_path, "cd", 10, seed=3)
    exp = Experiment(P, outdir=str(tmp_path / "results"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        exp.run({"ZD": {"out1": 5, "out2": 5}}, steps=[2], hp=tiny_hp())
    assert os.listdir(P.models_dir) == []
    assert not exists(join(P.root, "splits_ZD.json"))


# --- Nested CV (TestNestedCV) --------------------------------------------------

@pytest.fixture(scope="module")
def nested(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nested")
    train_P = build_project(tmp, "ntr", 30, seed=2)
    exp = Experiment(train_P, outcome=OUTCOME, outdir=str(tmp / "results"))
    exp.train_kwargs = {"device": "cpu"}
    hp = tiny_hp(uq=True)
    # outer 2-fold CV models first (the nested driver reads their
    # manifests), then inner 2-fold per outer fold.
    exp.train(hp=hp, label="EXP_N_UQ", val_k_fold=2, val_k=[1, 2],
              val_strategy="k-fold", splits="splits_N.json", seed=0)
    exp.train_nested_cv(hp=hp, label="EXP_N_UQ", outer_k=2, inner_k=2,
                        val_strategy="k-fold", seed=0)
    return exp


def test_inner_models_exist(nested):
    for outer in (1, 2):
        for inner in (1, 2):
            assert port_utils.model_exists(
                nested.train_project, f"EXP_N_UQ-k{outer}", outcome=OUTCOME,
                kfold=inner)


def test_inner_trained_on_outer_train_slides_only(nested):
    outer_model = port_utils.find_model(nested.train_project, "EXP_N_UQ",
                                        outcome=OUTCOME, kfold=1)
    outer_train = set(port_utils.get_slides_from_model_manifest(
        outer_model, dataset="training"))
    inner_model = port_utils.find_model(nested.train_project, "EXP_N_UQ-k1",
                                        outcome=OUTCOME, kfold=1)
    inner_all = set(port_utils.get_slides_from_model_manifest(
        inner_model, dataset=None))
    assert inner_all <= outer_train


def test_nested_cv_is_idempotent(nested):
    before = sorted(os.listdir(nested.train_project.models_dir))
    nested.train_nested_cv(hp=tiny_hp(uq=True), label="EXP_N_UQ", outer_k=2,
                           inner_k=2, val_strategy="k-fold", seed=0)
    assert sorted(os.listdir(nested.train_project.models_dir)) == before


def test_thresholds_from_nested_cv(nested, tmp_path):
    df, thresh = nested.thresholds_from_nested_cv("EXP_N_UQ", outer_k=2,
                                                  inner_k=2)
    assert thresh["tile_uq"] is not None
    assert thresh["slide_uq"] is not None
    assert thresh["slide_pred"] is not None
    assert len(df) == 2  # one row per outer fold
    assert set(df["uq"]) == {"include"}
    assert ((df["patient_uq_perc"] > 0)
            & (df["patient_uq_perc"] <= 1)).all()
    twin = jax_experiment.Experiment(nested.train_project.root,
                                     outcome=OUTCOME, outdir=str(tmp_path))
    want_df, want = twin.thresholds_from_nested_cv("EXP_N_UQ", outer_k=2,
                                                   inner_k=2)
    assert_same_value(thresh, want)
    assert_frame_equal(df, want_df, check_exact=False, rtol=0, atol=TOL)


# --- Step 4 through run, and the thresholded results -------------------------

@pytest.fixture(scope="module")
def ladder50(tmp_path_factory):
    """Steps 3-6 of a 50-slide experiment (step 4 needs >= 50 slides):
    3 UQ folds, 3 x 5 nested folds, the FULL model and its evaluation.
    Its id, 'G', is not one of NO_UQ_EXPS, so ``results`` derives the
    nested-CV thresholds and applies them to the evaluation."""
    tmp = tmp_path_factory.mktemp("ladder50")
    train_P = build_project(tmp, "gtr", 50, seed=4)
    eval_P = build_project(tmp, "gev", 10, seed=5)
    exp = Experiment(train_P, eval_projects=[eval_P], outcome=OUTCOME,
                     outdir=str(tmp / "results"))
    exp.train_kwargs = {"device": "cpu", "seed": 0, "validate_on_batch": 16,
                        "validation_steps": 8}
    exp.run({"G": {"out1": 25, "out2": 25}}, steps=[3, 4, 5, 6],
            hp=tiny_hp())
    return exp


def test_step4_trains_the_nested_folds(ladder50):
    P = ladder50.train_project
    for outer in (1, 2, 3):
        outer_train = set(port_utils.get_slides_from_model_manifest(
            port_utils.find_model(P, "EXP_G_UQ", OUTCOME, kfold=outer),
            dataset="training"))
        for inner in range(1, 6):
            d = port_utils.find_model(P, f"EXP_G_UQ-k{outer}", OUTCOME,
                                      kfold=inner)
            assert exists(join(d, "tile_predictions_val_epoch1.csv"))
            assert set(port_utils.get_slides_from_model_manifest(d)) <= (
                outer_train)
    assert len(os.listdir(P.models_dir)) == 3 + 15 + 1


def test_thresholded_results_equal_the_jax_results(ladder50, monkeypatch,
                                                   tmp_path):
    seeded_metrics(monkeypatch)
    got_df, got_ev = ladder50.results(["G"], uq=True, eval=True)
    want_df, want_ev = jax_twin(ladder50, str(tmp_path)).results(
        ["G"], uq=True, eval=True)
    assert set(got_df["uq"]) == {"all", "include"}
    assert set(got_ev["gev"]["uq"]) == {"none", "include", "exclude"}
    assert_frame_equal(got_df, want_df, check_exact=False, rtol=0, atol=TOL)
    assert_frame_equal(got_ev["gev"], want_ev["gev"], check_exact=False,
                       rtol=0, atol=TOL)
    got = ladder50.thresholds_from_nested_cv("EXP_G_UQ")
    want = jax_twin(ladder50, str(tmp_path)).thresholds_from_nested_cv(
        "EXP_G_UQ")
    assert_same_value(got[1], want[1])
    assert_frame_equal(got[0], want[0], check_exact=False, rtol=0, atol=TOL)


def test_package_exports_experiment():
    import biscuit_torch

    assert biscuit_torch.Experiment is Experiment
    with pytest.raises(AttributeError):
        biscuit_torch.Heatmap

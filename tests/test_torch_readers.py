"""The port's experiment matrix, annotation subsets, DeLong, prediction
metrics, figures and CLIs against the JAX package's, on the same inputs.

- ``published_matrix`` and ``Experiment.config``: equal dicts, and the
  same ValueError where the JAX package raises.
- ``Experiment.add``: the written CSV byte for byte (pandas reads the
  annotations as strings, adds the 'gan'/'site' defaults, sorts, and
  writes ``include_{label}``; both packages do the same calls).
- DeLong (tests/test_delong.py's cases and seeded random inputs),
  ``prediction_metrics`` (both given ``np.random.default_rng(0)``),
  ``_parse_cell`` and ``_loess_smooth``: the same float64 numpy/scipy
  arithmetic in the same order, held to 1e-12 (1e-10 for the LOESS fit,
  the bound tests/test_loess.py holds the JAX one to).
- ``plot_uncertainty``: the data of every line and scatter collection it
  draws, equal to the JAX figure's.
- The CLIs through click's ``CliRunner``: ``configure`` writes the same
  project files as the JAX CLI (paths made relative to each output),
  ``train`` trains the three CV folds of ZD on the CPU, ``results``
  writes the ``crossval_results.csv`` that ``Experiment.results`` writes
  (and the JAX ``Experiment.results`` reads off the same tree), and what
  is not ported raises.
"""

import json
import os
import shutil
from os.path import exists, join

import numpy as np
import pandas as pd
import pytest
import torch
from click.testing import CliRunner
from pandas.testing import assert_frame_equal

from biscuit_torch import delong as port_delong
from biscuit_torch import experiment as port_experiment
from biscuit_torch import threshold as port_threshold
from biscuit_torch import utils as port_utils
from biscuit_torch.cli import configure as port_configure
from biscuit_torch.cli import results as port_results
from biscuit_torch.cli import train as port_train
from biscuit_tpu import delong as jax_delong
from biscuit_tpu import experiment as jax_experiment
from biscuit_tpu import threshold as jax_threshold
from biscuit_tpu import utils as jax_utils
from biscuit_tpu.cli import configure as jax_configure
from biscuit_tpu.cli import train as jax_train
from test_torch_experiment import (
    assert_same_value,
    build_project,
    jax_twin,
    tiny_hp,
)

torch.set_num_threads(1)
TOL = 1e-12


# --- The matrix and the annotation subsets -----------------------------------

@pytest.mark.parametrize("ladder", [None, ["ZD", "G", "Z", "AA", "R"]])
@pytest.mark.parametrize("arms", [
    {}, {"orderings": False}, {"ratio": False, "gan": False},
    {"reg": False}, {"reg": False, "ratio": False}])
def test_published_matrix_equals_the_jax_one(ladder, arms):
    assert (port_experiment.published_matrix(ladder=ladder, **arms)
            == jax_experiment.published_matrix(ladder=ladder, **arms))


def test_ladder_constants_equal_the_jax_ones():
    for name in ("ALL_EXP", "NO_UQ_EXPS", "FULL_EPOCH_EXPS", "RATIO_EXPS",
                 "GAN_EXPS", "GAN_FRACTIONS"):
        assert getattr(port_experiment, name) == getattr(jax_experiment,
                                                         name), name


@pytest.mark.parametrize("args,kw", [
    (("{}", ["ZC", "ZD"], 1), {}), (("{}", ["AA"], 1), {}),
    (("R{}_3", ["D"], 3), {}), (("{}_10", list("AMDPGZ"), 10), {}),
    (("{}", ["ZD"], 1), {"gan": 0.1, "order": "r"}),
    (("{}", ["Q", "O"], 2.5), {})])
def test_config_equals_the_jax_one(args, kw):
    assert (port_experiment.Experiment.config(*args, **kw)
            == jax_experiment.Experiment.config(*args, **kw))


@pytest.mark.parametrize("args", [("{}", ["AA"], 3), ("{}", ["ZD"], 0.5),
                                  ("{}", ["ZD"], "3")])
def test_config_raises_where_the_jax_one_raises(args):
    for cls in (port_experiment.Experiment, jax_experiment.Experiment):
        with pytest.raises(ValueError):
            cls.config(*args)


def _annotations(n=24, gan=True, site=True, order2=True):
    rows = []
    for i in range(n):
        row = dict(patient=f"P{i}", slide=f"s{i}",
                   cohort="LUAD" if i % 2 == 0 else "LUSC", order=str(i))
        if order2:
            row["order2"] = str((7 * i) % n)
        if site:
            row["site"] = "GAN" if i >= n - 8 else f"site{i // 4}"
        if gan:
            row["gan"] = "1" if i >= n - 8 else "0"
        rows.append(row)
    return pd.DataFrame(rows)


def _bare(mod):
    exp = mod.Experiment.__new__(mod.Experiment)
    exp.outcome, exp.outcome1, exp.outcome2 = "cohort", "LUAD", "LUSC"
    return exp


@pytest.mark.parametrize("frame,calls", [
    (dict(), [dict(label="T", out1=3, out2=2)]),
    (dict(), [dict(label="R", out1=2, out2=4, order="r")]),
    (dict(), [dict(label="T2", out1=4, out2=4, order_col="order2")]),
    (dict(), [dict(label="G", out1=6, out2=6, gan=0.5),
              dict(label="GR", out1=6, out2=4, gan=0.4, order="r")]),
    (dict(gan=False, site=False), [dict(label="T", out1=5, out2=5)]),
    (dict(gan=False, site=False, order2=False),
     [dict(label="N", out1=2, out2=3, order_col="order_new")]),
])
def test_add_writes_the_jax_csv(tmp_path, frame, calls):
    got, want = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    for path in (got, want):
        _annotations(**frame).to_csv(path, index=False)
    for kw in calls:
        _bare(port_experiment).add(got, **kw)
        _bare(jax_experiment).add(want, **kw)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    out = pd.read_csv(got)
    assert (out[f"include_{calls[0]['label']}"] == "include").sum() == (
        calls[0]["out1"] + calls[0]["out2"]
        + round(calls[0].get("gan", 0) * calls[0]["out1"])
        + round(calls[0].get("gan", 0) * calls[0]["out2"]))


def test_add_refuses_what_the_jax_add_refuses(tmp_path):
    for mod in (port_experiment, jax_experiment):
        path = str(tmp_path / "ann.csv")
        _annotations().to_csv(path, index=False)
        with pytest.raises(AssertionError, match="not enough LUAD"):
            _bare(mod).add(path, label="X", out1=20, out2=2)
        with pytest.raises(AssertionError):
            _bare(mod).add(path, label="X", out1=2, out2=2, gan=1.5)


# --- DeLong, prediction metrics and result cells -----------------------------

def _delong_inputs():
    """tests/test_delong.py's inputs and seeded random ones with ties."""
    out = []
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 500)
    out.append((y, rng.random(500) + 0.5 * y, None))
    rng = np.random.default_rng(1)
    y = rng.integers(0, 2, 200)
    p = rng.random(200) + 0.5 * y
    out.append((y, p, p + 1e-3 * rng.standard_normal(200)))
    rng = np.random.default_rng(2)
    y = rng.integers(0, 2, 2000)
    out.append((y, y + 0.2 * rng.standard_normal(2000), rng.random(2000)))
    for seed in range(3, 8):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(20, 400))
        y = rng.integers(0, 2, n)
        out.append((y, np.round(rng.random(n) + 0.3 * y, 2),
                    np.round(rng.random(n), 1)))
    return out


@pytest.mark.parametrize("case", range(8))
def test_delong_equals_the_jax_one(case):
    y, p, p2 = _delong_inputs()[case]
    np.testing.assert_array_equal(port_delong.compute_midrank(p),
                                  jax_delong.compute_midrank(p))
    for g, w in zip(port_delong.compute_ground_truth_statistics(y),
                    jax_delong.compute_ground_truth_statistics(y)):
        np.testing.assert_array_equal(g, w)
    got = port_delong.delong_roc_variance(y, p)
    want = jax_delong.delong_roc_variance(y, p)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL)
    if p2 is not None:
        np.testing.assert_allclose(port_delong.delong_roc_test(y, p, p2),
                                   jax_delong.delong_roc_test(y, p, p2),
                                   rtol=0, atol=TOL)
        order, m = jax_delong.compute_ground_truth_statistics(y)
        stacked = np.vstack((p, p2))[:, order]
        for g, w in zip(port_delong.fastDeLong(stacked, m),
                        jax_delong.fastDeLong(stacked, m)):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


def test_delong_pvalue_and_single_class():
    aucs = np.array([0.9, 0.8])
    sigma = np.array([[0.001, 0.0002], [0.0002, 0.0015]])
    np.testing.assert_allclose(port_delong.calc_pvalue(aucs, sigma),
                               jax_delong.calc_pvalue(aucs, sigma),
                               rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="both classes"):
        port_delong.delong_roc_variance(np.ones(5, int), np.arange(5.0))


@pytest.mark.parametrize("seed,n,threshold", [
    (0, 40, 0.5), (1, 300, 0.3), (2, 12, 0.7), (3, 60, 0.5)])
def test_prediction_metrics_equal_the_jax_ones(seed, n, threshold):
    rng = np.random.default_rng(seed)
    y_true = rng.integers(0, 2, n)
    y_pred = np.clip(0.4 * y_true + rng.random(n) * 0.7, 0, 1)
    if seed == 3:
        y_true = np.full(n, 1)       # not binary {0, 1}: no DeLong CI
    got = port_utils.prediction_metrics(y_true, y_pred, threshold,
                                        rng=np.random.default_rng(0))
    want = jax_utils.prediction_metrics(y_true, y_pred, threshold,
                                        rng=np.random.default_rng(0))
    assert list(got) == list(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None
        else:
            assert_same_value(float(got[k]), float(want[k]))


@pytest.mark.parametrize("cell", [
    '{"cohort": [0.75]}', "{'cohort': [0.5, 0.25]}", {"cohort": [1.0]}])
def test_parse_cell_equals_the_jax_one(cell):
    assert port_utils._parse_cell(cell) == jax_utils._parse_cell(cell)


def test_single_class_auc_and_threshold_is_nan():
    y, p = np.ones(6, int), np.linspace(0, 1, 6)
    for mod in (port_utils, jax_utils):
        auc, thr = mod.auc_and_threshold(y, p)
        assert np.isnan(thr)
        assert np.isnan(mod.auc(y, p))


# --- Figures ----------------------------------------------------------------

@pytest.mark.parametrize("seed,n,frac", [(3, 20, 0.75), (9, 40, 0.75),
                                         (5, 30, 0.3), (5, 30, 0.9),
                                         (7, 7, 0.75)])
def test_loess_smooth_equals_the_jax_one(seed, n, frac):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 1, n))
    y = (rng.uniform(0, 1, n) < (1 - x)).astype(float) if seed == 9 else (
        np.sin(2 * x) + rng.normal(0, 0.1, n))
    for g, w in zip(port_threshold._loess_smooth(x, y, frac=frac),
                    jax_threshold._loess_smooth(x, y, frac=frac)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)


def _figure_frame(n=40):
    rng = np.random.default_rng(3)
    y_true = np.repeat([0, 1], n // 2)
    y_pred = np.clip(y_true * 0.6 + rng.normal(0.2, 0.18, n), 0, 1)
    unc = rng.uniform(0.0, 0.3, n)
    correct = ((y_pred >= 0.5) & (y_true == 1)) | (
        (y_pred < 0.5) & (y_true == 0))
    return pd.DataFrame(dict(
        slide=[f"s{i}" for i in range(n)], y_true=y_true, y_pred=y_pred,
        uncertainty=unc, correct=correct, incorrect=(~correct).astype(int)))


def _drawn(mod, df, **kw):
    """The data of every line and scatter collection of each panel."""
    import matplotlib.pyplot as plt

    mod.plot_uncertainty(df.copy(), **kw)
    fig = plt.gcf()
    out = []
    for ax in fig.axes:
        out.append(([ln.get_xydata() for ln in ax.lines],
                    [np.asarray(c.get_offsets()) for c in ax.collections
                     if len(c.get_offsets())],
                    ax.get_title()))
    plt.close("all")
    return out


@pytest.mark.parametrize("kw", [
    dict(kind="slide", threshold=0.15), dict(kind="slide"),
    dict(kind="patient", threshold=0.1, title="Exp. X"),
    dict(kind="tile", threshold=0.2, seed=0)])
def test_plot_uncertainty_draws_the_jax_figure(kw):
    got, want = _drawn(port_threshold, _figure_frame(), **kw), _drawn(
        jax_threshold, _figure_frame(), **kw)
    assert len(got) == len(want) == 3
    for (gl, gc, gt), (wl, wc, wt) in zip(got, want):
        assert gt == wt and len(gl) == len(wl) and len(gc) == len(wc)
        for g, w in zip(gl + gc, wl + wc):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


# --- The CLIs ---------------------------------------------------------------

def _configure(module, base):
    (base / "anns").mkdir(parents=True)
    for name in ("tcga", "cptac"):
        pd.DataFrame({"slide": ["a"], "cohort": ["LUAD"]}).to_csv(
            base / "anns" / f"{name}.csv", index=False)
    res = CliRunner().invoke(module.configure_projects, [
        "--train_slides", str(base / "slides" / "train"),
        "--val_slides", str(base / "slides" / "val"),
        "--train_anns", str(base / "anns" / "tcga.csv"),
        "--val_anns", str(base / "anns" / "cptac.csv"),
        "--out", str(base / "projects"), "--extract", "False"])
    return res


def test_configure_writes_the_jax_projects(tmp_path):
    got, want = tmp_path / "port", tmp_path / "jax"
    for module, base in ((port_configure, got), (jax_configure, want)):
        res = _configure(module, base)
        assert res.exit_code == 0, res.output
    files = ["gan_config.json"] + [
        join(p, f) for p in ("training", "evaluation")
        for f in ("settings.json", "datasets.json")]
    for f in files:
        with open(got / "projects" / f) as a, open(
                want / "projects" / f) as b:
            assert (a.read().replace(str(got), "BASE")
                    == b.read().replace(str(want), "BASE")), f
    with open(got / "projects" / "training" / "datasets.json") as f:
        assert set(json.load(f)) == {"Training", "LUNG_GAN"}


def test_configure_extract_waits_for_item_4(tmp_path):
    """``configure --extract True`` (``--gan_extract False``) on two
    annotated JPEG tiled slides a project writes, tile for tile and byte
    for byte, the tfrecords the JAX CLI writes (Queue 1 item 4 is in)."""
    from PIL import Image

    from biscuit_torch.data.native_loader import write_tiled_tiff

    rng = np.random.default_rng(0)
    for part in ("train", "val"):
        (tmp_path / part).mkdir()
        for i in range(2):
            img = np.full((96, 96, 3), 244, np.uint8)
            img[:, :60] = rng.integers(60, 200, (96, 60, 3))
            write_tiled_tiff(str(tmp_path / part / f"{part}{i}.svs"), img,
                             tile=32, jpeg=True)
        Image.fromarray(img).save(tmp_path / part / f"{part}x.png")
        pd.DataFrame({"patient": [f"{part}P{i}" for i in range(2)],
                      "slide": [f"{part}{i}" for i in range(2)],
                      "cohort": ["LUAD", "LUSC"]}).to_csv(
                          tmp_path / f"{part}.csv", index=False)
    args = ["--train_slides", str(tmp_path / "train"),
            "--val_slides", str(tmp_path / "val"),
            "--train_anns", str(tmp_path / "train.csv"),
            "--val_anns", str(tmp_path / "val.csv"),
            "--tile_px", "32", "--tile_um", "32", "--mpp", "1.0",
            "--qc", "otsu", "--gan_extract", "False"]
    for name, mod in (("port", port_configure), ("jax", jax_configure)):
        res = CliRunner().invoke(mod.configure_projects, args + [
            "--out", str(tmp_path / name)])
        assert res.exit_code == 0, (res.output, res.exception)
    for proj, part in (("training", "train"), ("evaluation", "val")):
        tfr = tmp_path / "port" / proj / "tfrecords" / "32px_32um"
        assert sorted(os.listdir(tfr)) == sorted(
            f"{part}{i}.tfrecords{s}" for i in range(2)
            for s in ("", ".index.npy"))
        for f in os.listdir(tfr):
            got = (tfr / f).read_bytes()
            assert got == (tmp_path / "jax" / proj / "tfrecords" /
                           "32px_32um" / f).read_bytes()
            assert len(got) > 0
        rel = f"{proj}/extraction_report_32px.csv"
        assert ((tmp_path / "port" / rel).read_bytes()
                == (tmp_path / "jax" / rel).read_bytes())


@pytest.mark.parametrize("s", ["1-6", "2,3", "4", "3-3", "1,5,6"])
def test_num_range_equals_the_jax_one(s):
    assert port_train.num_range(s) == jax_train.num_range(s)


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory):
    """A 10-slide training project and a 4-slide evaluation project, and
    the train CLI's run of ZD's step 2 on them, on the CPU."""
    tmp = tmp_path_factory.mktemp("cli")
    train_P = build_project(tmp, "ctr", 10, seed=5)
    eval_P = build_project(tmp, "cev", 4, seed=6)
    hp_json = tmp / "tiny.json"
    hp_json.write_text(json.dumps(tiny_hp().to_dict()))
    res = CliRunner().invoke(port_train.train_models, [
        "--train_project", train_P.root, "--eval_project", eval_P.root,
        "--subset", "ZD", "--steps", "2", "--ratio", "False",
        "--orderings", "False", "--hp_json", str(hp_json),
        "--device", "cpu"])
    assert res.exit_code == 0, (res.output, res.exception)
    return train_P, eval_P, tmp, res.output


def test_train_cli_writes_the_cv_folds(cli_tree):
    train_P, _, tmp, output = cli_tree
    assert "Running 1 experiments (reg1), steps [2]" in output
    dirs = sorted(os.listdir(train_P.models_dir))
    assert [d[6:] for d in dirs] == [
        f"cohort-EXP_ZD-HP0-kfold{k}" for k in (1, 2, 3)]
    for d in dirs:
        assert exists(join(train_P.models_dir, d, "results_log.csv"))
        with open(join(train_P.models_dir, d, "params.json")) as f:
            assert json.load(f)["hp"] == tiny_hp().to_dict()
    assert exists(join(train_P.root, "splits_ZD.json"))


def test_results_cli_writes_what_experiment_results_writes(cli_tree):
    train_P, eval_P, tmp, _ = cli_tree
    out = tmp / "cli_results"
    res = CliRunner().invoke(port_results.show_results, [
        "--train_project", train_P.root, "--eval_project", eval_P.root,
        "--outdir", str(out), "--subset", "ZD", "--ratio", "False"])
    assert res.exit_code == 0, (res.output, res.exception)
    labels = list(port_experiment.published_matrix(ladder=["ZD"])["reg1"])
    labels += ["ZD_R", "ZD2", "ZD_R2"]
    exp = port_experiment.Experiment(train_P.root, [eval_P.root],
                                     outdir=str(tmp / "lib_results"))
    df, _ = exp.results(labels, uq=True, eval=True)
    with open(out / "crossval_results.csv", "rb") as a, open(
            tmp / "lib_results" / "crossval_results.csv", "rb") as b:
        assert a.read() == b.read()
    assert list(df["uq"]) == ["none"] * 3 and list(df["fold"]) == [1, 2, 3]
    want, _ = jax_twin(exp, str(tmp / "jax_results")).results(
        labels, uq=True, eval=True)
    assert_frame_equal(df, want, check_exact=False, rtol=0, atol=TOL)


@pytest.mark.parametrize("flag", ["--heatmap", "--umap"])
def test_results_cli_heatmap_and_umap_wait_for_item_4(cli_tree, flag,
                                                      tmp_path, monkeypatch):
    """``--heatmap`` / ``--umap`` (Queue 1 item 4 is in) write the files
    the JAX CLI writes, on the CPU. The tree has no EXP_AA models, so
    both packages' ``find_model`` return one saved here (the tiny hp with
    UQ, the port's initial weights) and their nested-CV thresholds a
    fixed tile threshold. The tile export's file names carry each tile's
    uncertainty, which the two packages' dropout streams draw apart: its
    tiles are compared by slide and grid place."""
    from PIL import Image

    from biscuit_torch.models.xception import build_model
    from biscuit_torch.train.trainer import init_model, save_checkpoint
    from biscuit_tpu.cli import results as jax_results

    train_P, eval_P, tmp, _ = cli_tree
    hp = tiny_hp(uq=True)
    model = save_checkpoint(
        str(tmp_path / "models"), init_model(
            build_model(hp), hp, torch.Generator().manual_seed(0)), hp,
        epoch=1, outcome="cohort", label="EXP_AA_FULL", kfold=None)
    for mod in (port_utils, jax_utils):
        monkeypatch.setattr(mod, "find_model", lambda *a, **k: model)
    for cls in (port_experiment.Experiment, jax_experiment.Experiment):
        monkeypatch.setattr(cls, "thresholds_from_nested_cv",
                            lambda self, label: (None, {"tile_uq": 0.02}))
    slide = str(tmp_path / "hs.png")
    img = np.random.default_rng(1).integers(40, 200, (96, 96, 3),
                                            dtype=np.uint8)
    Image.fromarray(img).save(slide)
    files = {}
    for name, cmd, extra in (
            ("port", port_results.show_results, ["--device", "cpu"]),
            ("jax", jax_results.show_results, [])):
        out = tmp_path / name
        res = CliRunner().invoke(cmd, [
            "--train_project", train_P.root, "--eval_project", eval_P.root,
            "--outdir", str(out), "--reg", "False", "--heatmap_slide",
            slide, flag, "True"] + extra)
        assert res.exit_code == 0, (res.output, res.exception)
        files[name] = sorted(
            os.path.relpath(join(d, f), out).rsplit("-", 1)[0]
            if "uq_" in d else os.path.relpath(join(d, f), out)
            for d, _, fs in os.walk(out) for f in fs)
    assert files["port"] == files["jax"]
    want = (["feature_cache.npz", "mosaic.png", "umap_logits.png",
             "umap_slide.png", "umap_uncertainty.png"] if flag == "--umap"
            else 9)
    if flag == "--umap":
        assert files["port"] == want
    else:
        assert sum(f.startswith("tiles/uq_") for f in files["port"]) == want
        assert {f for f in files["port"] if not f.startswith("tiles/")} == {
            f"heatmap_{k}/hs-{m}.png" for k in ("raw", "masked")
            for m in ("preds", "uncertainty")}


def test_train_cli_refuses_submeshes_and_needs_a_card(cli_tree, tmp_path):
    """Without a card and without ``--device`` the CLI raises before it
    trains; ``--submeshes 2 --device cpu`` trains step 3's folds on two
    CPU threads."""
    train_P, eval_P, tmp, _ = cli_tree
    root = shutil.copytree(train_P.root, str(tmp_path / "copy"))
    args = ["--train_project", root, "--eval_project", eval_P.root,
            "--subset", "ZD", "--steps", "3", "--ratio", "False",
            "--orderings", "False"]
    if not torch.cuda.is_available():
        res = CliRunner().invoke(port_train.train_models, args)
        assert isinstance(res.exception, RuntimeError)
        assert "device='cpu'" in str(res.exception)
    assert not any("EXP_ZD_UQ" in d for d in os.listdir(join(root,
                                                              "models")))
    res = CliRunner().invoke(port_train.train_models, args + [
        "--submeshes", "2", "--device", "cpu",
        "--hp_json", str(tmp / "tiny.json")])
    assert res.exit_code == 0, (res.output, res.exception)
    uq = sorted(d[6:] for d in os.listdir(join(root, "models"))
                if "EXP_ZD_UQ" in d)
    assert uq == [f"cohort-EXP_ZD_UQ-HP0-kfold{k}" for k in (1, 2, 3)]


def test_console_scripts_name_the_port_clis():
    """pyproject.toml gives each of the port's six CLIs a console script,
    biscuit-torch-<name> beside the JAX package's biscuit-<name>, bound to
    the port's click command of the same name."""
    import click
    import importlib
    import tomllib
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    scripts = tomllib.loads((root / "pyproject.toml").read_text())[
        "project"]["scripts"]
    port = {k: v for k, v in scripts.items() if k.startswith("biscuit-torch-")}
    assert sorted(port) == sorted(
        "biscuit-torch-" + k.removeprefix("biscuit-") for k in scripts
        if not k.startswith("biscuit-torch-"))
    for name, target in port.items():
        module, attr = target.split(":")
        assert module.startswith("biscuit_torch.cli.")
        jax_module, jax_attr = scripts[
            "biscuit-" + name.removeprefix("biscuit-torch-")].split(":")
        assert (module.rsplit(".", 1)[1], attr) == (
            jax_module.rsplit(".", 1)[1], jax_attr)
        assert isinstance(getattr(importlib.import_module(module), attr),
                          click.Command)

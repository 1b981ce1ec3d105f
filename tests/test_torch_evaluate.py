"""External evaluation of the port against the JAX package's, on one
synthetic project (12 slides x 16 PNG tiles of 32 px, as
tests/test_model_trainer.py builds one) and one checkpoint saved by the
JAX package (``xception_tiny``, live parameters, no normalizer, dropout
0), each package's ``evaluate_project`` on its own copy of the project
root.

A random head predicts about 0.5 for every tile, where a bf16 rounding
decides on which side of 0.5 a tile falls. So the checkpoint's logits
layer is set from the JAX model's own last hidden layer on the tiles
(``_decisive``): it separates the two classes as a trained head does,
and no tile lies near 0.5.

Tolerances, at dropout 0:
- tile ``y_pred`` within 2e-2: both trunks compute in bf16, the bound
  tests/test_torch_uq.py holds the serving path to;
- uncertainty within 1e-3 (the std of K equal passes is 0 on both);
- the slide and patient CSVs equal: their ``percent_tiles_positive1``
  counts tiles with ``y_pred >= 0.5``, and no JAX tile lies within 2e-2
  of 0.5 (asserted), so no tile can cross;
- the slide and patient AUC/AP equal, computed from those equal CSVs;
- the tile AUC within n / (P * N), and the tile AP within n / P, where n
  counts the (positive, negative) tile pairs whose JAX scores lie within
  4e-2 (twice the y_pred tolerance) of each other: only such a pair can
  change order, a change of order moves the AUC by exactly 1 / (P * N),
  and it moves one positive's precision, so the AP, by at most 1 / P.
"""

import io
import os
import shutil
from os.path import basename, join

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from flax.core import unfreeze
from pandas.testing import assert_frame_equal
from PIL import Image

from biscuit_torch.project import Project as PortProject
from biscuit_torch.train.evaluate import evaluate_project as port_evaluate
from biscuit_torch.utils import rename_cols
from biscuit_tpu import utils as jax_utils
from biscuit_tpu.data.normalize import inference_preprocess
from biscuit_tpu.data.tfrecord import TFRecordWriter
from biscuit_tpu.hp import ModelParams
from biscuit_tpu.models.xception import build_model
from biscuit_tpu.project import Project as JaxProject
from biscuit_tpu.train.evaluate import evaluate_project as jax_evaluate
from biscuit_tpu.train.trainer import init_model, save_checkpoint
from test_model_trainer import make_tile
from test_torch_uq import _live_params

torch.set_num_threads(1)
OUTCOME = "cohort"
FILES = {"results_log.csv", "tile_predictions_eval.csv",
         f"slide_predictions_{OUTCOME}_eval.csv",
         f"patient_predictions_{OUTCOME}_eval.csv"}


def _project(tmp):
    """12 slides of 16 class-separable 32-px PNG tiles, two slides a
    patient, and an eval Project rooted in tmp/"root"; returns its root,
    the tiles and their labels."""
    rng = np.random.default_rng(0)
    tiles = []
    ann = pd.DataFrame([dict(patient=f"TCGA-{i // 2:02d}-P", slide=f"sl{i}",
                             cohort="LUAD" if i % 4 < 2 else "LUSC")
                        for i in range(12)])
    ann.to_csv(tmp / "ann.csv", index=False)
    (tmp / "tfr").mkdir()
    for i in range(12):
        with TFRecordWriter(str(tmp / "tfr" / f"sl{i}.tfrecords")) as w:
            for t in range(16):
                tiles.append(make_tile(i % 4 >= 2, rng))
                buf = io.BytesIO()
                Image.fromarray(tiles[-1]).save(buf, format="PNG")
                w.write_tile(f"sl{i}", buf.getvalue(), loc_x=t, loc_y=i)
    project = JaxProject(str(tmp / "root"), annotations=str(tmp / "ann.csv"),
                         name="eval", create=True)
    project.add_source("SRC", tfrecords=str(tmp / "tfr"))
    labels = np.repeat(np.arange(12) % 4 >= 2, 16)
    return project.root, np.stack(tiles), labels


def _hp(uq: bool) -> ModelParams:
    return ModelParams(model="xception_tiny", tile_px=32, tile_um=32,
                       hidden_layer_width=32, dropout=0.0, uq=uq,
                       uq_samples=4, normalizer=None)


def _decisive(tiles, labels):
    """Live parameters of the tiny model with the logits layer set from
    the JAX model's last hidden layer h on ``tiles``: the logit
    difference is s * (h . w - c), w the difference of the two classes'
    mean h, c halfway between the classes' scores h . w, and s putting
    the nearest tile at a logit difference of 0.4 (probability 0.4 or
    0.6)."""
    hp = _hp(True)
    model = build_model(hp)
    params, stats = init_model(model, hp, jax.random.PRNGKey(0))
    params = _live_params(params)
    stats = jax.tree_util.tree_map(np.asarray, unfreeze(stats))
    h = np.asarray(model.apply(
        {"params": params, "batch_stats": stats},
        inference_preprocess(jnp.asarray(tiles), None), train=False,
        method="features"), np.float64)
    head = params["head"]
    for name in sorted(set(head) - {"logits"}):
        h = np.maximum(h @ head[name]["kernel"] + head[name]["bias"], 0)
    w = h[labels].mean(0) - h[~labels].mean(0)
    score = h @ w
    lo, hi = score[~labels].max(), score[labels].min()
    assert lo < hi, "the classes' scores overlap"
    s, c = 0.4 / ((hi - lo) / 2), (hi + lo) / 2
    head["logits"]["kernel"] = np.stack([-w, w], 1).astype(np.float32) * s / 2
    head["logits"]["bias"] = np.array([c, -c], np.float32) * s / 2
    return params, stats


def _checkpoint(tmp, uq: bool, params, stats):
    return save_checkpoint(str(tmp / f"models_uq{int(uq)}"), params, stats,
                           _hp(uq), epoch=1, outcome=OUTCOME,
                           label=f"UQ{int(uq)}", kfold=None)


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    """uq -> (JAX results, port results, the port's project root opened
    by the JAX package, the checkpoint), each package evaluating on its
    own copy of the project root."""
    tmp = tmp_path_factory.mktemp("eval")
    root, tiles, labels = _project(tmp)
    params, stats = _decisive(tiles, labels)
    roots = {pkg: shutil.copytree(root, str(tmp / pkg))
             for pkg in ("jax", "port")}
    jax_proj, port_proj = JaxProject(roots["jax"]), PortProject(roots["port"])
    out = {}
    for uq in (True, False):
        path = _checkpoint(tmp, uq, params, stats)
        out[uq] = (jax_evaluate(jax_proj, path, OUTCOME),
                   port_evaluate(port_proj, path, OUTCOME, device="cpu"),
                   JaxProject(roots["port"]), path)
    return out


def _read(results, name):
    return pd.read_csv(join(results["eval_dir"], name))


@pytest.mark.parametrize("uq", [True, False])
def test_eval_dirs_match(evals, uq):
    want, got, _, _ = evals[uq]
    assert basename(got["eval_dir"]) == basename(want["eval_dir"])
    assert basename(got["eval_dir"]).startswith(f"{int(not uq):05d}-eval-")
    assert set(os.listdir(got["eval_dir"])) == FILES
    assert set(os.listdir(want["eval_dir"])) == FILES


@pytest.mark.parametrize("uq", [True, False])
def test_tile_predictions_match(evals, uq):
    want_res, got_res, _, _ = evals[uq]
    want = _read(want_res, "tile_predictions_eval.csv")
    got = _read(got_res, "tile_predictions_eval.csv")
    assert list(got.columns) == list(want.columns)
    assert (f"{OUTCOME}_uncertainty0" in want.columns) is uq
    assert len(want) == 12 * 16
    ids = ["slide", "loc_x", "loc_y", f"{OUTCOME}_y_true0"]
    assert_frame_equal(got[ids], want[ids])
    pred = [c for c in want.columns if "_y_pred" in c]
    y = want[pred].to_numpy()
    assert np.ptp(y[:, 1]) > 0.2            # predictions vary by tile
    assert np.abs(y[:, 1] - 0.5).min() > 2e-2
    np.testing.assert_allclose(got[pred], y, rtol=0, atol=2e-2)
    unc = [c for c in want.columns if "_uncertainty" in c]
    np.testing.assert_allclose(got[unc], want[unc], rtol=0, atol=1e-3)


@pytest.mark.parametrize("uq", [True, False])
@pytest.mark.parametrize("level", ["slide", "patient"])
def test_group_predictions_match(evals, uq, level):
    want, got, _, _ = evals[uq]
    name = f"{level}_predictions_{OUTCOME}_eval.csv"
    assert_frame_equal(_read(got, name), _read(want, name), check_exact=True)


@pytest.mark.parametrize("uq", [True, False])
def test_metrics_match(evals, uq):
    want, got, _, _ = evals[uq]
    for level in ("slide", "patient"):
        assert got[level] == want[level]
    tiles = _read(want, "tile_predictions_eval.csv")
    y = tiles[f"{OUTCOME}_y_true0"].to_numpy()
    score = tiles[f"{OUTCOME}_y_pred1"].to_numpy()
    pos, neg = score[y == 1], score[y == 0]
    close = int((np.abs(pos[:, None] - neg[None, :]) <= 4e-2).sum())
    auc_tol = close / (len(pos) * len(neg))
    assert abs(got["tile"][0] - want["tile"][0]) <= auc_tol
    assert abs(got["tile"][1] - want["tile"][1]) <= close / len(pos)
    got_log = _read(got, "results_log.csv")
    want_log = _read(want, "results_log.csv")
    for k in ("model_name", "slide_auc", "slide_ap", "patient_auc",
              "patient_ap"):
        assert got_log[k][0] == want_log[k][0]


@pytest.mark.parametrize("uq", [True, False])
def test_jax_readers_read_the_port_eval_dir(evals, uq):
    _, got, port_as_jax, _ = evals[uq]
    label = f"UQ{int(uq)}"
    found = jax_utils.find_eval(port_as_jax, label, OUTCOME, epoch=1)
    assert found == got["eval_dir"]
    res = jax_utils.get_eval_results(found, OUTCOME)
    assert res["slide_auc"] == got["slide"][0]
    assert res["pt_ap"] == got["patient"][1]
    assert res["tile_auc"] == pytest.approx(got["tile"][0], abs=1e-12)
    y_true, y_pred = jax_utils.read_group_predictions(
        join(found, f"slide_predictions_{OUTCOME}_eval.csv"))
    assert len(y_true) == len(y_pred) == 12


def test_tile_frame_renames_for_the_thresholds(evals):
    tiles = _read(evals[True][1], "tile_predictions_eval.csv")
    rename_cols(tiles, OUTCOME)
    assert {"y_true", "y_pred", "uncertainty"} <= set(tiles.columns)


def test_evaluate_needs_a_card_unless_cpu(evals):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, port_as_jax, path = evals[True]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_evaluate(PortProject(port_as_jax.root), path, OUTCOME)


def test_evaluate_with_fused_blocks(evals, tmp_path):
    """``fuse_blocks=True`` reaches the trunk: on the CPU its blocks run
    the fused strided block's plain version (bf16), so the tile
    predictions differ from the default composition's, within the 2e-2
    that the tile CSVs of the two packages are held to."""
    _, got, port_as_jax, path = evals[True]
    root = shutil.copytree(port_as_jax.root, str(tmp_path / "root"))
    fused = port_evaluate(PortProject(root), path, OUTCOME, device="cpu",
                          fuse_blocks=True)
    assert basename(fused["eval_dir"]) == "00002-eval-" + basename(
        got["eval_dir"])[11:]
    want = _read(got, "tile_predictions_eval.csv")
    have = _read(fused, "tile_predictions_eval.csv")
    assert_frame_equal(have.iloc[:, :4], want.iloc[:, :4])
    pred = [c for c in want.columns if "_y_pred" in c]
    diff = np.abs(have[pred].to_numpy() - want[pred].to_numpy())
    assert 0 < diff.max() <= 2e-2       # another trunk, the same scores

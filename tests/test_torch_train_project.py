"""The port's training loop (biscuit_torch/train/trainer.py
``train_project``, ``train/splits.py``, ``train/checkpoint.py``) against
the JAX package's, on one synthetic project: 12 slides of 16
class-separable 32-px PNG tiles, two slides (one of each class) a site,
as tests/test_model_trainer.py builds one.

One module fixture trains fold 1 of 3 with each package, each on its own
copy of the project root: ``xception_tiny`` in f32, augment off, dropout
0, ``uq=True`` with K=4, batch 16, 5 steps an epoch, epochs [1, 2] (10
steps, so that ``train_log.csv`` has a row in epoch 2, after the
predictions of epoch 1 put the model in eval mode), ``save_model=True``.
Both start from the same weights: the test replaces each package's
``init_model`` with one that loads the same numpy parameters, a trained
start (``init_params``). The two tile streams shuffle identically (the
same numpy generator), so both steps see the same batches.

Tolerances. A single f32 step of the module path agrees with Flax's to
1e-5 in the loss and 1e-3 in the gradients (tests/test_torch_trainer.py);
Adam turns a gradient into a step of about the learning rate (1e-4) in
each coordinate whatever its size, so where a gradient is near zero and
its sign differs by rounding, a weight moves 2e-4 apart a step: every
trained weight within 2e-3 of JAX's (ten such steps; measured 1.5e-4).
The loss within 1e-5 (measured 4e-7); the tile probabilities within
1e-3 (measured 3.3e-4: the eval-mode forward reads the running
statistics, which follow rounding of the batch statistics); the
uncertainty, the std of K equal passes at dropout 0, within 1e-6 of 0
on both; the tile AUC/AP within 1e-3; the slide and patient CSVs and
their metrics equal, since they count tiles at ``y_pred >= 0.5`` and no
JAX tile probability lies within 1e-3 of 0.5 (asserted; measured 2e-3).
"""

import io
import json
import os
import shutil
from os.path import join

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from flax.core import freeze, unfreeze
from pandas.testing import assert_frame_equal
from PIL import Image

from biscuit_torch.data.augment import jpeg_augment_host as port_jpeg_host
from biscuit_torch.data.pipeline import TileBatcher as PortTileBatcher
from biscuit_torch.hp import ModelParams as PortModelParams
from biscuit_torch.models.convert import from_flax, to_flax
from biscuit_torch.models.xception import build_model as port_build_model
from biscuit_torch.project import Project as PortProject
from biscuit_torch.train import checkpoint as port_ckpt
from biscuit_torch.train import splits as port_splits
from biscuit_torch.train import trainer as ptr
from biscuit_tpu import utils as jax_utils
from biscuit_tpu.data.augment import jpeg_augment_host as jax_jpeg_host
from biscuit_tpu.data.pipeline import TileBatcher as JaxTileBatcher
from biscuit_tpu.data.tfrecord import TFRecordWriter
from biscuit_tpu.hp import ModelParams
from biscuit_tpu.models.xception import build_model
from biscuit_tpu.project import Project as JaxProject
from biscuit_tpu.train import splits as jax_splits
from biscuit_tpu.train import trainer as jtr
from test_model_trainer import make_tile

torch.set_num_threads(1)
OUTCOME, LABEL = "cohort", "TP"
STEPS = 5                  # steps an epoch (steps_per_epoch_override)
W_TOL, LOSS_TOL, P_TOL = 2e-3, 1e-5, 1e-3


def _hp(**kw) -> ModelParams:
    base = dict(model="xception_tiny", tile_px=32, tile_um=32,
                batch_size=16, epochs=[1, 2], early_stop=False, dropout=0.0,
                uq=True, uq_samples=4, hidden_layer_width=32,
                hidden_layers=2, normalizer=None, augment="",
                compute_dtype="float32")
    base.update(kw)
    return ModelParams(**base)


def _port_hp(hp: ModelParams) -> PortModelParams:
    return PortModelParams(**hp.to_dict())


def _project(tmp, tiles=None):
    """The synthetic project's root (a JAX Project: both packages read
    the same settings.json); its tiles are appended to ``tiles``."""
    rng = np.random.default_rng(0)
    tiles = [] if tiles is None else tiles
    ann = pd.DataFrame([dict(patient=f"TCGA-{i:02d}-P", slide=f"sl{i}",
                             cohort="LUAD" if i % 2 == 0 else "LUSC",
                             site=f"{i // 2}") for i in range(12)])
    ann.to_csv(tmp / "ann.csv", index=False)
    (tmp / "tfr").mkdir()
    for i in range(12):
        with TFRecordWriter(str(tmp / "tfr" / f"sl{i}.tfrecords")) as w:
            for t in range(16):
                tiles.append(make_tile(i % 2, rng))
                buf = io.BytesIO()
                Image.fromarray(tiles[-1]).save(buf, format="PNG")
                w.write_tile(f"sl{i}", buf.getvalue(), loc_x=t, loc_y=0)
    project = JaxProject(str(tmp / "root"), annotations=str(tmp / "ann.csv"),
                         name="synth", create=True)
    project.add_source("SRC", tfrecords=str(tmp / "tfr"))
    return project.root


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  unfreeze(tree))


@pytest.fixture(scope="module")
def init_params(tmp_path_factory):
    """A trained start for both packages: the port's own initialization
    of the tiny model (seed 0), 30 Adam steps at 1e-3 on batches of the
    project's tiles, then 200 train-mode forwards without gradients, so
    that the running statistics follow the trained weights and the
    eval-mode probabilities spread over the tiles as a trained model's
    do. From there the parity run trains in a well-conditioned regime
    (from a random start the loss is large and rounding differences grow
    step by step)."""
    tiles = []
    _project(tmp_path_factory.mktemp("tiles"), tiles)
    tiles = torch.from_numpy(np.stack(tiles))
    labels = torch.from_numpy(np.repeat(np.arange(12) % 2, 16))
    hp = _port_hp(_hp(learning_rate=1e-3))
    model = ptr.init_model(port_build_model(hp), hp,
                           torch.Generator().manual_seed(0))
    step = ptr.make_train_step(model, ptr.make_optimizer(
        hp, model.parameters()), hp, None, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for i in range(230):
        idx = torch.randperm(len(tiles), generator=gen)[:16]
        if i < 30:
            step(tiles[idx], labels[idx], torch.ones(16))
        else:
            with torch.no_grad():
                model(ptr.preprocess(tiles[idx], None))
    return tuple(_np_tree(t) for t in to_flax(model.state_dict()))


def _same_init(mp, init_params):
    """Both packages' init_model load the same numpy parameters."""
    params, stats = init_params
    mp.setattr(jtr, "init_model",
               lambda model, hp, rng: (freeze(params), freeze(stats)))

    def port_init(model, hp, generator):
        model.load_state_dict(from_flax(params, stats))
        return model

    mp.setattr(ptr, "init_model", port_init)


def _copy(root, tmp, name):
    return shutil.copytree(root, str(tmp / name))


@pytest.fixture(scope="module")
def trained(tmp_path_factory, init_params):
    """(JAX model dir, port model dir, the port's project root opened by
    the JAX package)."""
    tmp = tmp_path_factory.mktemp("train")
    root = _project(tmp)
    hp = _hp()
    kw = dict(params=hp, val_k=[1], steps_per_epoch_override=STEPS,
              save_model=True)
    with pytest.MonkeyPatch.context() as mp:
        _same_init(mp, init_params)
        (want,) = JaxProject(_copy(root, tmp, "jax")).train(
            OUTCOME, LABEL, **kw)
        (got,) = PortProject(_copy(root, tmp, "port")).train(
            OUTCOME, LABEL, **{**kw, "params": _port_hp(hp)}, device="cpu")
    return want, got, JaxProject(str(tmp / "port"))


def _csv(d, name):
    return pd.read_csv(join(d, name))


def test_model_dirs_and_files_match(trained):
    want, got, _ = trained
    assert os.path.basename(got) == os.path.basename(want) == (
        f"00000-{OUTCOME}-{LABEL}-HP0-kfold1")
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    for root in (want, got):
        models = os.path.dirname(root)
        assert os.listdir(models) == [os.path.basename(root)]


@pytest.mark.parametrize("name", ["slide_manifest.csv", "params.json",
                                  "../../splits_TP.json"])
def test_contract_files_equal(trained, name):
    want, got, _ = trained
    with open(join(want, name), "rb") as a, open(join(got, name), "rb") as b:
        assert a.read() == b.read()


def test_params_json_holds_the_fold_and_labels(trained):
    _, got, _ = trained
    with open(join(got, "params.json")) as f:
        meta = json.load(f)
    assert meta["kfold"] == 1 and meta["outcome_labels"] == ["LUAD", "LUSC"]
    assert meta["hp"] == _hp().to_dict()


def test_train_log_matches(trained):
    want, got, _ = trained
    w, g = _csv(want, "train_log.csv"), _csv(got, "train_log.csv")
    assert list(g.columns) == list(w.columns)
    assert list(g["step"]) == [1, 10]
    assert_frame_equal(g[["step", "epoch", "lr"]], w[["step", "epoch", "lr"]])
    # Step 10 runs after epoch 1's predictions put the model in eval mode:
    # its loss matches only if the step trains in train mode again.
    np.testing.assert_allclose(g["loss"], w["loss"], rtol=0, atol=LOSS_TOL)
    assert (g["tiles_per_s"] > 0).all()


@pytest.mark.parametrize("epoch", [1, 2])
def test_tile_predictions_match(trained, epoch):
    want, got, _ = trained
    name = f"tile_predictions_val_epoch{epoch}.csv"
    w, g = _csv(want, name), _csv(got, name)
    assert list(g.columns) == list(w.columns)
    assert len(w) == 4 * 16
    ids = ["slide", "loc_x", "loc_y", f"{OUTCOME}_y_true0"]
    assert_frame_equal(g[ids], w[ids])
    pred = [c for c in w.columns if "_y_pred" in c]
    assert np.abs(w[pred[1]] - 0.5).min() > P_TOL
    np.testing.assert_allclose(g[pred], w[pred], rtol=0, atol=P_TOL)
    unc = [c for c in w.columns if "_uncertainty" in c]
    assert len(unc) == 2
    np.testing.assert_allclose(g[unc], 0, atol=1e-6)
    np.testing.assert_allclose(w[unc], 0, atol=1e-6)


@pytest.mark.parametrize("epoch", [1, 2])
@pytest.mark.parametrize("level", ["slide", "patient"])
def test_group_predictions_equal(trained, epoch, level):
    want, got, _ = trained
    name = f"{level}_predictions_{OUTCOME}_val_epoch{epoch}.csv"
    assert_frame_equal(_csv(got, name), _csv(want, name), check_exact=True)


def test_results_log_matches(trained):
    want, got, _ = trained
    w, g = _csv(want, "results_log.csv"), _csv(got, "results_log.csv")
    assert list(g.columns) == list(w.columns)
    assert list(g["model_name"]) == [f"{OUTCOME}-{LABEL}-HP0_epoch{e}"
                                     for e in (1, 2)]
    for col in g.columns[1:]:
        for a, b in zip(g[col], w[col]):
            (va,), (vb,) = json.loads(a)[OUTCOME], json.loads(b)[OUTCOME]
            if col.startswith("tile"):
                assert abs(va - vb) <= P_TOL, col
            else:
                assert va == vb, col


@pytest.mark.parametrize("epoch", [1, 2])
def test_epoch_checkpoints_load_in_jax(trained, epoch):
    want, got, _ = trained
    sub = f"{OUTCOME}-{LABEL}-HP0-kfold1_epoch{epoch}"
    _, p_got, s_got, hp, meta = jtr.load_checkpoint(join(got, sub))
    _, p_want, s_want, _, meta_want = jtr.load_checkpoint(join(want, sub))
    assert meta == meta_want and hp.to_dict() == _hp().to_dict()
    flat = dict(jax.tree_util.tree_leaves_with_path(_np_tree(p_want)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(_np_tree(p_got)):
        np.testing.assert_allclose(leaf, flat[path], rtol=0, atol=W_TOL,
                                   err_msg=str(path))
    for a, b in zip(jax.tree_util.tree_leaves(_np_tree(s_got)),
                    jax.tree_util.tree_leaves(_np_tree(s_want))):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_jax_readers_read_the_port_project(trained):
    _, got, port_as_jax = trained
    assert jax_utils.find_model(port_as_jax, LABEL, OUTCOME, kfold=1) == got
    assert jax_utils.find_cv(port_as_jax, LABEL, OUTCOME, k=1) == [got]
    (df,) = jax_utils.df_from_cv(port_as_jax, LABEL, OUTCOME, k=1)
    assert {"y_true", "y_pred", "uncertainty", "patient"} <= set(df.columns)
    assert len(df) == 4 * 16
    res = jax_utils.get_model_results(got, 2, OUTCOME)
    row = _csv(got, "results_log.csv").iloc[1]
    assert res["slide_auc"] == json.loads(row["slide_auc"])[OUTCOME][0]
    assert res["opt_thresh"] is not None
    assert jax_utils.find_cv_early_stop(port_as_jax, LABEL, OUTCOME,
                                        k=1) is None


# ------------------------------------------------------------ early stop

ES_ACCS = [0.5, 0.6, 0.7, 0.8, 0.5]     # the EMA worsens at the 5th check


def _scripted(accs):
    """A validation step that ignores its batch and returns the next
    scripted accuracy as (correct, total) out of 100."""
    it = iter(accs)

    def step(*_):
        return float(round(100 * next(it, 0.5))), 100.0

    return step


@pytest.fixture(scope="module")
def early_stopped(tmp_path_factory, init_params):
    """Both packages under ES_ACCS: checks every 2 steps of 2 steps an
    epoch, the EMA from the first 2 checks, epochs [8]."""
    tmp = tmp_path_factory.mktemp("es")
    root = _project(tmp)
    hp = _hp(epochs=[8], early_stop=True, ema_observations=2)
    kw = dict(params=hp, val_k=[1], steps_per_epoch_override=2,
              validate_on_batch=2, validation_steps=1)
    with pytest.MonkeyPatch.context() as mp:
        _same_init(mp, init_params)
        mp.setattr(jtr, "_cached_val_metrics_step",
                   lambda *a: _scripted(ES_ACCS))
        mp.setattr(ptr, "make_val_metrics_step",
                   lambda *a: _scripted(ES_ACCS))
        (want,) = JaxProject(_copy(root, tmp, "jax")).train(
            OUTCOME, "ES", **kw)
        (got,) = PortProject(_copy(root, tmp, "port")).train(
            OUTCOME, "ES", **{**kw, "params": _port_hp(hp)}, device="cpu")
    return want, got, JaxProject(str(tmp / "port"))


def test_early_stop_at_the_same_batch(early_stopped):
    want, got, port_as_jax = early_stopped
    w, g = _csv(want, "results_log.csv"), _csv(got, "results_log.csv")
    assert list(w["early_stop_batch"]) == list(g["early_stop_batch"]) == [10]
    assert list(g["model_name"]) == [f"{OUTCOME}-ES-HP0_epoch8"]
    assert os.path.exists(join(got, "tile_predictions_val_epoch8.csv"))
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    assert jax_utils.find_cv_early_stop(port_as_jax, "ES", OUTCOME, k=1) == 10


def test_patience_beyond_the_budget_never_stops(tmp_path, init_params):
    root = _project(tmp_path)
    hp = _port_hp(_hp(epochs=[8], early_stop=True, ema_observations=2,
                      early_stop_patience=8))
    calls = []

    def counted(*a):
        step = _scripted([0.9] + [0.1] * 20)

        def run(*b):
            calls.append(1)
            return step(*b)

        return run

    with pytest.MonkeyPatch.context() as mp:
        _same_init(mp, init_params)
        mp.setattr(ptr, "make_val_metrics_step", counted)
        (got,) = PortProject(root).train(
            OUTCOME, "NS", params=hp, val_k=[1], steps_per_epoch_override=2,
            validate_on_batch=2, validation_steps=1, device="cpu")
    log = _csv(got, "results_log.csv")
    assert "early_stop_batch" not in log.columns
    assert list(log["model_name"]) == [f"{OUTCOME}-NS-HP0_epoch8"]
    assert len(calls) == 8          # a check every 2 of the 16 steps


# ---------------------------------------------------------------- resume


@pytest.mark.parametrize("every, epochs_after", [(4, [1, 2]), (5, [2])])
def test_checkpoint_resume(tmp_path, init_params, every, epochs_after):
    """checkpoint_every over 2 epochs of 5 steps: a run that dies at step
    ``every + 2`` leaves checkpoint ``every`` equal bit for bit to the
    state after that step, and no results_log.csv; the relaunch reuses
    the directory, restores that step, runs the remaining steps and
    completes. It records epoch 1 again unless the checkpoint covers
    epoch 1 (step 5), whose predictions the first run wrote."""
    root = _project(tmp_path)
    hp = _port_hp(_hp())
    made = []
    real = ptr.make_train_step

    def watched(model, tx, *a, **kw):
        step_fn = real(model, tx, *a, **kw)
        rec = {"tx": tx, "calls": 0, "crash_at": every + 2 if not made
               else None}
        made.append(rec)

        def run(images, labels, mask, generator=None):
            rec["calls"] += 1
            if rec["calls"] == rec["crash_at"]:
                raise RuntimeError("killed")
            out = step_fn(images, labels, mask, generator)
            if rec["calls"] == every:
                rec["saved"] = {
                    "model": {k: v.clone()
                              for k, v in model.state_dict().items()},
                    "exp_avg_sq": [tx.opt.state[p]["exp_avg_sq"].clone()
                                   for p in model.parameters()],
                    "count": tx.count,
                    "generator": generator.get_state().clone()}
            return out

        return run

    kw = dict(params=hp, val_k=[1], steps_per_epoch_override=STEPS,
              checkpoint_every=every, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        _same_init(mp, init_params)
        mp.setattr(ptr, "make_train_step", watched)
        with pytest.raises(RuntimeError, match="killed"):
            PortProject(root).train(OUTCOME, "R", **kw)
        (model_dir,) = os.listdir(join(root, "models"))
        model_dir = join(root, "models", model_dir)
        assert not os.path.exists(join(model_dir, "results_log.csv"))
        assert os.path.exists(join(model_dir,
                                   "tile_predictions_val_epoch1.csv"))
        assert os.listdir(join(model_dir, "ckpt")) == [str(every)]

        # The saved state, restored into a fresh model, bit for bit.
        saved = made[0]["saved"]
        model = port_build_model(hp)
        tx = ptr.make_optimizer(hp, model.parameters())
        gen = torch.Generator()
        ck = port_ckpt.RunCheckpointer(model_dir, every=every)
        assert ck.latest() == every
        *_, step = ck.maybe_restore(model, tx, gen)
        assert step == tx.count == saved["count"] == every
        for k, v in model.state_dict().items():
            assert torch.equal(v, saved["model"][k]), k
        for p, m in zip(model.parameters(), saved["exp_avg_sq"]):
            assert torch.equal(tx.opt.state[p]["exp_avg_sq"], m)
        assert torch.equal(gen.get_state(), saved["generator"])

        (again,) = PortProject(root).train(OUTCOME, "R", **kw)
    assert again == model_dir
    assert made[1]["calls"] == 2 * STEPS - every
    assert made[1]["tx"].count == 2 * STEPS
    log = _csv(model_dir, "results_log.csv")
    assert list(log["model_name"]) == [f"{OUTCOME}-R-HP0_epoch{e}"
                                       for e in epochs_after]
    assert sorted(os.listdir(join(model_dir, "ckpt")), key=int) == [
        str(every), str(2 * every)]


def test_forced_save_and_keep_two(tmp_path):
    hp = _port_hp(_hp())
    model = port_build_model(hp)
    tx = ptr.make_optimizer(hp, model.parameters())
    gen = torch.Generator()
    ck = port_ckpt.RunCheckpointer(str(tmp_path), every=3)
    for step in range(1, 10):
        ck.save(step, model, tx, gen)
    assert ck.steps() == [6, 9]
    ck.save(10, model, tx, gen, force=True)
    ck.save(9, model, tx, gen, force=True)       # covered by the cadence
    assert ck.steps() == [9, 10]
    assert not [d for d in os.listdir(ck.dir) if not d.isdigit()]
    assert port_ckpt.RunCheckpointer(str(tmp_path)).maybe_restore(
        model, tx, gen)[-1] == 0


# ---------------------------------------------------------------- splits


def _split_inputs(n_slides, n_sites, seed):
    rng = np.random.default_rng(seed)
    slides = [f"s{i:03d}" for i in range(n_slides)]
    labels = {s: int(rng.integers(0, 2)) for s in slides}
    sites = {s: f"site{int(rng.integers(0, n_sites))}" for s in slides}
    return slides, labels, sites


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n_sites", [None, 2, 9])
def test_kfold_split_matches_jax(tmp_path, seed, n_sites):
    """The same folds and a byte-identical cache file, with sites, without,
    and with fewer sites than folds (the slide-level fallback)."""
    slides, labels, sites = _split_inputs(40, n_sites or 1, seed)
    sites = sites if n_sites else None
    paths = {pkg: str(tmp_path / pkg / "splits.json")
             for pkg in ("jax", "port")}
    want = jax_splits.kfold_split(slides, labels, sites, k=3, seed=seed,
                                  splits_path=paths["jax"])
    got = port_splits.kfold_split(slides, labels, sites, k=3, seed=seed,
                                  splits_path=paths["port"])
    assert got == want
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    for k in (1, 2, 3):
        assert (port_splits.train_val_slides(got, k)
                == jax_splits.train_val_slides(want, k))


def test_kfold_cache_hit_and_miss_rule(tmp_path):
    """A cache with the same k and slide set is returned as it is (even
    for another seed); another k or slide set is a miss, rewritten."""
    slides, labels, sites = _split_inputs(30, 6, 0)
    for mod, name in ((jax_splits, "jax"), (port_splits, "port")):
        path = str(tmp_path / f"{name}.json")
        first = mod.kfold_split(slides, labels, sites, k=3, seed=0,
                                splits_path=path)
        assert mod.kfold_split(slides, labels, sites, k=3, seed=5,
                               splits_path=path) == first
        assert len(mod.kfold_split(slides, labels, sites, k=4, seed=0,
                                   splits_path=path)) == 4
        fewer = mod.kfold_split(slides[:-1], labels, sites, k=4, seed=0,
                                splits_path=path)
        assert sorted(sum(fewer.values(), [])) == sorted(slides[:-1])
    with open(tmp_path / "jax.json", "rb") as a, \
            open(tmp_path / "port.json", "rb") as b:
        assert a.read() == b.read()


def test_dataset_kfold_split_matches_jax(tmp_path):
    root = _project(tmp_path)
    got = PortProject(root).dataset(32, 32).kfold_split(
        3, OUTCOME, seed=2, splits_path=str(tmp_path / "p.json"))
    want = JaxProject(root).dataset(32, 32).kfold_split(
        3, OUTCOME, seed=2, splits_path=str(tmp_path / "j.json"))
    assert got == want
    assert all(len(f) == 4 for f in got.values())


# -------------------------------------------------------- init, JPEG, device


def test_init_model_is_flax_lecun_normal(tmp_path, monkeypatch):
    """The port's init has Flax's distribution: conv and dense kernels
    times sqrt(fan_in) a truncated normal of unit variance (within its
    standard error) bounded by 2 / 0.8796, zero biases, identity
    BatchNorm; the same seed gives the same weights. With hp.pretrained
    it grafts the staged Keras trunk and keeps the fresh head."""
    hp = _port_hp(_hp())
    a = ptr.init_model(port_build_model(hp), hp,
                       torch.Generator().manual_seed(3))
    b = ptr.init_model(port_build_model(hp), hp,
                       torch.Generator().manual_seed(3))
    ours = to_flax(a.state_dict())
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k

    def scaled(params):
        out = []
        for path, leaf in jax.tree_util.tree_leaves_with_path(params):
            name = jax.tree_util.keystr(path)
            if name.endswith("['kernel']"):
                out.append(np.asarray(leaf).ravel()
                           * np.sqrt(np.prod(leaf.shape[:-1])))
            elif name.endswith("['bias']") and "bn" not in name:
                assert not np.any(leaf), name
        return np.concatenate(out)

    z_port = scaled(ours[0])
    jhp = _hp()
    z_jax = scaled(_np_tree(jtr.init_model(build_model(jhp), jhp,
                                           jax.random.PRNGKey(3))[0]))
    for z in (z_port, z_jax):
        assert np.abs(z).max() <= 2 / 0.87962566103423978 + 1e-5
        assert abs(z.std() - 1) < 5 / np.sqrt(len(z))
        assert abs(z.mean()) < 5 / np.sqrt(len(z))
    for leaf in jax.tree_util.tree_leaves(ours[1]):
        assert set(np.unique(leaf)) <= {0.0, 1.0}
    from test_torch_pretrained import _to_keras

    donor = to_flax(ptr.init_model(port_build_model(hp), hp,
                                   torch.Generator().manual_seed(4))
                    .state_dict())
    np.savez(tmp_path / "xception_imagenet.npz", **{
        f"{layer}/{w}": arr
        for layer, ws in _to_keras(*donor, hp.model).items()
        for w, arr in ws.items()})
    monkeypatch.setenv("BISCUIT_PRETRAINED_DIR", str(tmp_path))
    hp.pretrained = "imagenet"
    grafted = to_flax(ptr.init_model(port_build_model(hp), hp,
                                     torch.Generator().manual_seed(3))
                      .state_dict())
    for tree, want, fresh in zip(grafted, donor, ours):
        for (path, got), (_, w), (_, f) in zip(
                *(jax.tree_util.tree_leaves_with_path(t)
                  for t in (tree, want, fresh))):
            name = jax.tree_util.keystr(path)
            if name.startswith("['head']"):
                np.testing.assert_array_equal(got, f, err_msg=name)
            elif name.endswith("['var']"):
                np.testing.assert_array_max_ulp(got, w, maxulp=1)
            else:
                np.testing.assert_array_equal(got, w, err_msg=name)


def test_jpeg_augment_host_matches_jax():
    rng = np.random.default_rng(0)
    imgs = [make_tile(i % 2, rng) for i in range(12)]
    ga, gb = np.random.default_rng(5), np.random.default_rng(5)
    applied = 0
    for img in imgs:
        got, want = port_jpeg_host(img, ga), jax_jpeg_host(img, gb)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        applied += got is not img
    assert 0 < applied < len(imgs)
    assert ga.random() == gb.random()


def test_tile_batcher_jpeg_aug_matches_jax(tmp_path):
    root = _project(tmp_path)
    paths = sorted(str(p) for p in (tmp_path / "tfr").glob("*.tfrecords"))
    kw = dict(batch_size=16, shuffle=True, infinite=False, seed=3,
              jpeg_aug=True, tile_px=32)
    got = list(PortTileBatcher(paths[:3], **kw))
    want = list(JaxTileBatcher(paths[:3], use_native=False, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g["image"], w["image"])
        assert g["slide"] == w["slide"]
    assert os.path.isdir(root)


def test_host_jpeg_switch_leaves_the_step_jpeg_out(monkeypatch):
    """Under BISCUIT_JPEG_HOST=1 the step draws no JPEG decisions: from
    the same generator, its augmented step equals a step of the same
    hp without 'j'."""
    hp = _port_hp(_hp(augment="xyj"))
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3),
                                           dtype=np.uint8))
    labels, mask = torch.tensor([0, 1, 0, 1]), torch.ones(4)
    losses = {}
    for env, aug in (("1", "xyj"), ("0", "xy")):
        monkeypatch.setenv("BISCUIT_JPEG_HOST", env)
        hp.augment = aug
        model = ptr.init_model(port_build_model(hp), hp,
                               torch.Generator().manual_seed(0))
        step = ptr.make_train_step(model, ptr.make_optimizer(
            hp, model.parameters()), hp, None, device="cpu")
        losses[env] = float(step(images, labels, mask,
                                 torch.Generator().manual_seed(1))["loss"])
    assert losses["1"] == losses["0"]


def test_train_project_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = _project(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PortProject(root).train(OUTCOME, "D", params=_port_hp(_hp()))
    assert os.listdir(join(root, "models")) == []


_PREEMPT = """
import os, signal, sys
import torch
torch.set_num_threads(1)
from biscuit_torch.hp import ModelParams
from biscuit_torch.project import Project
from biscuit_torch.train import trainer

real = trainer.make_train_step

def make(*a, **kw):
    step = real(*a, **kw)
    calls = [0]

    def run(*b):
        calls[0] += 1
        if calls[0] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*b)

    return run

trainer.make_train_step = make
hp = ModelParams(**{hp!r})
Project(sys.argv[1]).train("cohort", "P", params=hp, val_k=[1],
                           steps_per_epoch_override=5, checkpoint_every=4,
                           device="cpu")
"""


def test_sigterm_checkpoints_at_the_step_boundary(tmp_path):
    """A SIGTERM during step 3 of a run with checkpoint_every=4: the run
    saves checkpoint 3 at that step's end, then dies of the signal; the
    relaunch resumes at step 3."""
    import signal
    import subprocess
    import sys

    root = _project(tmp_path)
    code = _PREEMPT.format(hp=_hp().to_dict())
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo}
    proc = subprocess.run([sys.executable, "-c", code, root], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == -signal.SIGTERM, proc.stderr[-2000:]
    assert "preemption checkpoint committed at step 3" in proc.stderr
    (name,) = os.listdir(join(root, "models"))
    model_dir = join(root, "models", name)
    assert os.listdir(join(model_dir, "ckpt")) == ["3"]
    assert not os.path.exists(join(model_dir, "results_log.csv"))
    ck = port_ckpt.RunCheckpointer(model_dir, every=4)
    hp = _port_hp(_hp())
    model = port_build_model(hp)
    tx = ptr.make_optimizer(hp, model.parameters())
    assert ck.maybe_restore(model, tx, torch.Generator())[-1] == 3
    assert tx.count == 3

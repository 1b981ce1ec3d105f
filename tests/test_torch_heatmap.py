"""The port's consumers of a trained model against the JAX package's, on
the CPU: ``Heatmap`` and ``export_tiles_by_uncertainty`` (over a tiled
JPEG slide), ``umap_lite``, ``generate_features`` / ``generate_mosaic`` /
``SlideMap``, the GAN path (``resize_batch``, ``score_gan_tiles``,
``add_gan_annotations``) and ``utils.truncate_colormap``; and the
heatmap, tile export and feature dump from a servable artifact against
the model dir's.

One set of weights for both packages: an ``xception_tiny`` model in f32
(32 px, 2 x 32 head, K=4, reinhard_fast), initialized by the port, its BN
shifts made positive and its head doubled so features survive the relus
and predictions differ from tile to tile, saved once as a model dir that
both packages load. Tolerances:

- heatmap grids, GAN and feature-dump outputs within 1e-4 at dropout 0:
  the same f32 arithmetic in another order (XLA's and torch's convs);
- the heatmap's -99 mask exact: it is the QC mask, computed by the same
  numpy on the same pixels;
- at dropout > 0 the two packages draw different dropout streams, so the
  port is held to the mask and to std > 0 on every scored tile;
- ``umap_embed``, the mosaic and the SlideMap labels bit for bit: the same
  numpy on the same features;
- ``resize_batch`` within 1e-3 on the 0-255 scale: the same f32 weights,
  contracted in f64 by the port and in f32 by XLA.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from biscuit_torch import gan as port_gan
from biscuit_torch import heatmap as port_heatmap
from biscuit_torch import mosaic as port_mosaic
from biscuit_torch import utils as port_utils
from biscuit_torch.data.native_loader import write_tiled_tiff
from biscuit_torch.data.slide import WSI
from biscuit_torch.data.tfrecord import TFRecordWriter
from biscuit_torch.hp import ModelParams
from biscuit_torch.models.xception import BatchNorm, build_model
from biscuit_torch.stats import umap_lite as port_umap
from biscuit_torch.train.trainer import init_model, save_checkpoint
from biscuit_tpu import gan as jax_gan
from biscuit_tpu import heatmap as jax_heatmap
from biscuit_tpu import mosaic as jax_mosaic
from biscuit_tpu import utils as jax_utils
from biscuit_tpu.stats import umap_lite as jax_umap
from chip_smoke import encode_png

torch.set_num_threads(1)
TOL = 1e-4


def _saved_model(root, dropout):
    hp = ModelParams(model="xception_tiny", tile_px=32, tile_um=32,
                     hidden_layer_width=32, dropout=dropout, uq=True,
                     uq_samples=4, normalizer="reinhard_fast",
                     compute_dtype="float32")
    model = init_model(build_model(hp), hp,
                       torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.bias.copy_(torch.from_numpy(rng.uniform(
                    0.1, 0.3, mod.bias.shape).astype(np.float32)))
        for lin in (model.head.hidden0, model.head.hidden1,
                    model.head.logits):
            lin.weight.mul_(2)
    return save_checkpoint(str(root / f"models_d{dropout}"), model, hp,
                           epoch=1, outcome="cohort", label="HM", kfold=None)


def _slide_rgb(size, seed):
    """Left two thirds noisy pink tissue, right third near-white
    background (never constant: the stain normalizer divides by each
    tile's spread)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(236, 253, (size, size, 3), dtype=np.uint8)
    w = size * 2 // 3
    img[:, :w] = np.clip(np.array([170, 90, 140]) + rng.normal(
        0, 30, (size, w, 3)), 0, 255).astype(np.uint8)
    return img


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Model dirs at dropout 0 and 0.5, a 192-px JPEG tiled slide (36 grid
    positions, 24 of them tissue), the tfrecord of its tissue tiles, and
    two GAN tfrecords of 64-px tiles. The extraction's Otsu QC drops the
    near-white tiles, as the pipeline does: the stain normalizer divides
    by a tile's spread, so on a near-flat tile it magnifies f32 rounding
    differences past the tolerance (to ~1e-4 in the features here)."""
    tmp = tmp_path_factory.mktemp("hm")
    models = {d: _saved_model(tmp, d) for d in (0.0, 0.5)}
    slide = str(tmp / "hs.svs")
    write_tiled_tiff(slide, _slide_rgb(192, 0), tile=64, jpeg=True)
    wsi = WSI(slide, 32, 32, mpp=1.0, qc="otsu")
    tfr = str(tmp / "hs.tfrecords")
    assert wsi.extract_tiles(tfr) == 24
    rng = np.random.default_rng(1)
    gan = []
    for s in range(2):
        gan.append(str(tmp / f"gan{s}.tfrecords"))
        with TFRecordWriter(gan[-1]) as w:
            for t in range(5):
                img = np.clip(_slide_rgb(64, 10 * s + t) + rng.integers(
                    -20, 21, (64, 64, 3)), 0, 255).astype(np.uint8)
                w.write_tile(f"gan{s}", encode_png(img), loc_x=t, loc_y=s)
    return tmp, models, slide, [tfr], gan


def _heatmaps(env, dropout):
    _, models, slide, _, _ = env
    kw = dict(batch_size=16, qc="otsu")
    return (port_heatmap.Heatmap(slide, models[dropout], device="cpu", **kw),
            jax_heatmap.Heatmap(slide, models[dropout], **kw))


def test_heatmap_matches_jax_at_dropout_0(env, tmp_path):
    got, want = _heatmaps(env, 0.0)
    assert got.logits.shape == want.logits.shape == (6, 6, 2)
    unscored = got.logits[..., 1] == -99.0
    np.testing.assert_array_equal(unscored, want.logits[..., 1] == -99.0)
    np.testing.assert_array_equal(unscored,
                                  got.uncertainty[..., 0] == -99.0)
    # The -99 cells are the QC mask's rejections, and nothing else.
    tissue = np.zeros((6, 6), bool)
    for i, j, x, y in got.wsi.coords():
        tissue[j, i] = got.wsi._tile_is_tissue(x, y)
    np.testing.assert_array_equal(~unscored, tissue)
    assert tissue.sum() == 24
    np.testing.assert_allclose(got.logits, want.logits, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.uncertainty, want.uncertainty, rtol=0,
                               atol=TOL)
    assert np.ptp(got.logits[~unscored, 1]) > 1e-3
    assert got.timings["tiles"] == 24 and got.timings["batches"] == 2
    got.save(str(tmp_path / "out"))
    assert sorted(os.listdir(tmp_path / "out")) == ["hs-preds.png",
                                                    "hs-uncertainty.png"]


def test_heatmap_at_dropout_keeps_the_mask_and_spreads(env):
    got, want = _heatmaps(env, 0.5)
    unscored = got.uncertainty[..., 0] == -99.0
    np.testing.assert_array_equal(unscored,
                                  want.uncertainty[..., 0] == -99.0)
    assert (got.uncertainty[~unscored, 0] > 0).all()
    np.testing.assert_allclose(got.logits[~unscored].sum(-1), 1, atol=1e-5)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_export_tiles_by_uncertainty(env, dropout):
    """At dropout 0 the port exports the JAX package's files, byte for
    byte; at dropout 0.5 its split is its own heatmap's threshold split
    (the same seed stream, one call a batch)."""
    tmp, models, slide, _, _ = env
    out = tmp / f"export_d{dropout}"
    hm = port_heatmap.Heatmap(slide, models[dropout], batch_size=16,
                              qc="otsu", device="cpu")
    unc = hm.uncertainty[..., 0]
    tile_uq = float(np.median(unc[unc > -99])) if dropout else 0.5
    n = port_heatmap.export_tiles_by_uncertainty(
        slide, models[dropout], tile_uq, str(out / "port"), batch_size=16,
        qc="otsu", device="cpu")
    files = {d: sorted(os.listdir(out / "port" / d))
             for d in ("uq_incl", "uq_excl")}
    assert n == (len(files["uq_incl"]), len(files["uq_excl"]))
    assert sum(n) == 24
    want_incl = sorted(f"hs-{i}-{j}-{unc[j, i]:.5f}.png"
                       for j, i in zip(*np.where((unc > -99)
                                                 & (unc < tile_uq))))
    assert files["uq_incl"] == want_incl
    if dropout:
        assert 0 < n[0] < 24
        return
    assert n == jax_heatmap.export_tiles_by_uncertainty(
        slide, models[dropout], tile_uq, str(out / "jax"), batch_size=16,
        qc="otsu")
    for d, names in files.items():
        assert sorted(os.listdir(out / "jax" / d)) == names
        for name in names:
            assert ((out / "port" / d / name).read_bytes()
                    == (out / "jax" / d / name).read_bytes())


def test_servable_paths_raise_naming_item_6(env, tmp_path):
    """Servable artifacts are ported (ROADMAP.md Queue 1 item 6): the
    heatmap, the tile export and the feature dump from a portable artifact
    of the dropout-0 model give the model dir's results. The artifact's
    preprocess and trunk are the model dir's f32 path, so the features
    are equal; its head is the MC head's plain version, whose bf16
    operands move the probabilities by up to 1e-3 here, hence 2e-3 (one
    flipped bf16 rounding, as ``tests/test_torch_mcd_head.py``); at
    dropout 0 both uncertainties are 0."""
    from biscuit_torch import serve

    _, models, slide, tfrs, _ = env
    art = serve.export_servable(models[0.0], str(tmp_path / "m.bin"),
                                batch_size=16, use_kernels=False,
                                device="cpu")
    assert not art.endswith(".biscuit")       # found by its magic
    kw = dict(qc="otsu", device="cpu")
    got = port_heatmap.Heatmap(slide, art, **kw)
    want = port_heatmap.Heatmap(slide, models[0.0], batch_size=16, **kw)
    assert got.timings["batches"] == want.timings["batches"] == 2
    np.testing.assert_array_equal(got.logits == -99, want.logits == -99)
    np.testing.assert_allclose(got.logits, want.logits, rtol=0, atol=2e-3)
    np.testing.assert_allclose(got.uncertainty, want.uncertainty, rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="bakes K=4"):
        port_heatmap.Heatmap(slide, art, k=8, **kw)

    n = [port_heatmap.export_tiles_by_uncertainty(
        slide, src, 0.01, str(tmp_path / name), **kw)
        for name, src in (("art", art), ("dir", models[0.0]))]
    assert n[0] == n[1] == (24, 0)
    assert (sorted(os.listdir(tmp_path / "art" / "uq_incl"))
            == sorted(os.listdir(tmp_path / "dir" / "uq_incl")))

    f, meta, _ = port_mosaic.generate_features(art, tfrs, max_tiles=20,
                                               device="cpu")
    jf, jmeta, _ = port_mosaic.generate_features(
        models[0.0], tfrs, max_tiles=20, batch_size=16, k=8, device="cpu")
    assert f.shape == jf.shape == (20, 128)
    np.testing.assert_array_equal(f, jf)
    for m, j in zip(meta, jmeta):
        assert (m["slide"], m["loc"]) == (j["slide"], j["loc"])
        np.testing.assert_allclose(m["probs"], j["probs"], rtol=0,
                                   atol=2e-3)


@pytest.mark.parametrize("n,dim", [(2, 8), (40, 12), (90, 64)])
def test_umap_embed_bit_equal(n, dim):
    feats = np.random.default_rng(n).normal(size=(n, dim)).astype(np.float32)
    feats[: n // 2] += 2.0
    np.testing.assert_array_equal(port_umap.umap_embed(feats, seed=3),
                                  jax_umap.umap_embed(feats, seed=3))
    assert port_umap.fit_ab(1.0, 0.1) == jax_umap.fit_ab(1.0, 0.1)


@pytest.fixture(scope="module")
def features(env):
    tmp, models, _, tfrs, _ = env
    kw = dict(max_tiles=20, batch_size=16, keep_tiles=True, k=4)
    got = port_mosaic.generate_features(
        models[0.0], tfrs, cache=str(tmp / "port_cache.npz"), device="cpu",
        **kw)
    want = jax_mosaic.generate_features(models[0.0], tfrs, **kw)
    return got, want


def test_generate_features_within_tolerance(env, features):
    (f, meta, tiles), (jf, jmeta, jtiles) = features
    assert f.shape == jf.shape == (20, 128)
    np.testing.assert_allclose(f, jf, rtol=0, atol=TOL)
    np.testing.assert_array_equal(tiles, jtiles)
    assert len(meta) == len(jmeta) == 20
    for m, j in zip(meta, jmeta):
        assert m["slide"] == j["slide"] == "hs"
        assert tuple(map(int, m["loc"])) == tuple(map(int, j["loc"]))
        np.testing.assert_allclose(m["probs"], j["probs"], rtol=0, atol=TOL)
        np.testing.assert_allclose(m["uncertainty"], j["uncertainty"],
                                   rtol=0, atol=TOL)
    # The cache returns what was dumped.
    tmp, models, _, tfrs, _ = env
    f2, meta2, tiles2 = port_mosaic.generate_features(
        models[0.0], tfrs, cache=str(tmp / "port_cache.npz"))
    np.testing.assert_array_equal(f2, f)
    np.testing.assert_array_equal(tiles2, tiles)
    assert [m["slide"] for m in meta2] == [m["slide"] for m in meta]


def test_mosaic_and_slide_map_equal_jax(features, tmp_path):
    _, (f, meta, tiles) = features
    np.testing.assert_array_equal(
        port_mosaic.generate_mosaic(f, meta, tiles, grid=5),
        jax_mosaic.generate_mosaic(f, meta, tiles, grid=5))
    got = port_mosaic.slide_map_from_features(f, meta, tiles)
    want = jax_mosaic.slide_map_from_features(f, meta, tiles)
    np.testing.assert_array_equal(got.coords, want.coords)
    assert got.embed_method == want.embed_method == "umap_lite"
    for label in ("label_by_logits", "label_by_uncertainty",
                  "label_by_slide"):
        getattr(got, label)()
        getattr(want, label)()
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.label_name == want.label_name
    assert got.save(str(tmp_path / "map.png")) == str(tmp_path / "map.png")
    assert os.path.exists(tmp_path / "map.png")


@pytest.mark.parametrize("n,size,out", [(2, 512, 299), (3, 64, 32),
                                        (2, 20, 32)])
def test_resize_batch_within_1e_3(n, size, out):
    imgs = np.random.default_rng(size).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)
    got = port_gan.resize_batch(imgs, out)
    assert got.dtype == torch.float32 and got.shape == (n, out, out, 3)
    want = np.asarray(jax_gan.resize_batch(imgs, out))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_score_gan_tiles_within_tolerance(env):
    tmp, models, _, _, gan = env
    kw = dict(outcome="cohort", batch_size=8, gan_px=64)
    got = port_gan.score_gan_tiles(models[0.0], gan, device="cpu",
                                   out_csv=str(tmp / "gan" / "port.csv"),
                                   **kw)
    want = jax_gan.score_gan_tiles(models[0.0], gan, **kw)
    assert list(got.columns) == list(want.columns)
    assert len(got) == 10
    num = [c for c in got.columns if c.startswith("cohort_y_pred")
           or c.startswith("cohort_uncertainty")]
    assert len(num) == 4
    for c in got.columns:
        if c in num:
            np.testing.assert_allclose(got[c], want[c], rtol=0, atol=TOL)
        else:
            assert list(got[c]) == list(want[c])
    assert np.ptp(got["cohort_y_pred1"]) > 1e-3
    pd.testing.assert_frame_equal(pd.read_csv(tmp / "gan" / "port.csv"),
                                  got, check_exact=False, check_dtype=False,
                                  atol=1e-6)


def test_add_gan_annotations_equal(tmp_path):
    ann = pd.DataFrame({"patient": ["p0", "p1"], "slide": ["s0", "s1"],
                        "cohort": ["LUAD", "LUSC"]})
    for name, mod in (("port", port_gan), ("jax", jax_gan)):
        path = str(tmp_path / f"{name}.csv")
        ann.to_csv(path, index=False)
        mod.add_gan_annotations(path, {"g1": "LUSC", "g0": "LUAD",
                                       "s1": "LUSC"})
        mod.add_gan_annotations(path, {"g2": "LUAD"})
    got = (tmp_path / "port.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes()
    assert pd.read_csv(tmp_path / "port.csv")["gan"].tolist() == [
        0, 0, 1, 1, 1]


def test_truncate_colormap_equal_jax():
    import matplotlib

    cmap = matplotlib.colormaps["inferno"]
    got = port_utils.truncate_colormap(cmap, 0.1, 0.8, n=50)
    want = jax_utils.truncate_colormap(cmap, 0.1, 0.8, n=50)
    assert got.name == want.name == "trunc(inferno,0.10,0.80)"
    x = np.linspace(0, 1, 97)
    np.testing.assert_array_equal(got(x), want(x))

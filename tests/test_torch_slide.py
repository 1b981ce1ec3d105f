"""The port's whole-slide reader and tile extraction
(``biscuit_torch/data/slide.py``) against the JAX package's, on slides
made from seeds: PNG slides (read through PIL by both), and tiled TIFF
slides written by the port's native writer (read through ``TiledTiff`` by
both), raw and JPEG, with a pyramid level.

Exact comparisons throughout: the QC statistics are the same numpy
arithmetic, the tile reads the same library or PIL calls, and the
extracted tfrecords are the same bytes (PIL's PNG encoder, the same
framing and CRC32C).
"""

import os
from os.path import join

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from biscuit_torch.data import slide as port_slide
from biscuit_torch.data.native_loader import write_tiled_tiff
from biscuit_torch.project import Project as PortProject
from biscuit_tpu.data import slide as jax_slide
from biscuit_tpu.project import Project as JaxProject

torch.set_num_threads(1)


def _he_like(size, seed, blobs=6):
    """White background with dark pink noisy 'tissue' blobs."""
    rng = np.random.default_rng(seed)
    img = np.full((size, size, 3), 245, np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(blobs):
        cy, cx = rng.integers(size // 6, size - size // 6, 2)
        r = rng.integers(size // 10, size // 5)
        m = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        img[m] = np.clip(np.array([170, 90, 140]) + rng.normal(
            0, 25, (int(m.sum()), 3)), 0, 255).astype(np.uint8)
    return img


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    """name -> path: a PNG slide, a raw tiled TIFF and a JPEG tiled .svs
    with a half-resolution level (256 px each)."""
    tmp = tmp_path_factory.mktemp("slides")
    img = _he_like(256, 0)
    paths = {"png": str(tmp / "sp.png"), "tiff": str(tmp / "st.tiff"),
             "svs": str(tmp / "ss.svs")}
    Image.fromarray(img).save(paths["png"])
    write_tiled_tiff(paths["tiff"], img, tile=64)
    write_tiled_tiff(paths["svs"], img, tile=64, jpeg=True)
    lvl1 = img.reshape(128, 2, 128, 2, 3).mean((1, 3)).astype(np.uint8)
    write_tiled_tiff(paths["svs"], lvl1, tile=64, jpeg=True, append=True)
    return paths


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_qc_statistics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    gray = rng.integers(0, 256, (40, 50), dtype=np.uint8)
    gray[:20] //= 3
    assert (port_slide.otsu_threshold(gray)
            == jax_slide.otsu_threshold(gray))
    assert (port_slide.laplacian_variance(gray)
            == jax_slide.laplacian_variance(gray))
    pts = rng.uniform(-10, 110, (200, 2))
    poly = rng.uniform(0, 100, (7, 2))
    np.testing.assert_array_equal(port_slide.points_in_polygon(pts, poly),
                                  jax_slide.points_in_polygon(pts, poly))


def test_roi_csv_equal_jax(tmp_path):
    path = str(tmp_path / "roi.csv")
    pd.DataFrame({"ROI_Name": ["a"] * 4 + ["b"] * 3 + ["c"] * 2,
                  "X_base": np.arange(9.0) * 3,
                  "Y_base": np.arange(9.0) ** 2}).to_csv(path, index=False)
    got, want = port_slide.load_roi_csv(path), jax_slide.load_roi_csv(path)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _wsis(path, *args, **kw):
    return port_slide.WSI(path, *args, **kw), jax_slide.WSI(path, *args,
                                                            **kw)


def _same_tiles(p, j, **kw):
    got = list(p.build_generator(**kw)())
    want = list(j.build_generator(**kw)())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["loc"] == w["loc"]
        np.testing.assert_array_equal(g["image"], w["image"])
    return len(got)


@pytest.mark.parametrize("kind", ["png", "tiff", "svs"])
@pytest.mark.parametrize("qc", [None, "otsu", "blur", "both"])
def test_wsi_grid_qc_and_tiles_equal_jax(slides, kind, qc):
    p, j = _wsis(slides[kind], 32, 32, mpp=1.0, qc=qc)
    assert (p._tiled is None) == (kind == "png")
    assert (p.grid_x, p.grid_y, p.extract_px, p.stride, p.mpp) == (
        j.grid_x, j.grid_y, j.extract_px, j.stride, j.mpp) == (8, 8, 32, 32,
                                                              1.0)
    if qc in ("otsu", "both"):
        np.testing.assert_array_equal(p._tissue_mask, j._tissue_mask)
        assert p._thumb_scale == j._thumb_scale
    n = _same_tiles(p, j, shuffle=True, seed=3, include_loc="xy")
    assert (n == 64) == (qc is None)
    p.close()
    j.close()


def test_wsi_reads_the_pyramid_level_as_jax(slides):
    """64-um windows at 1 mpp into 32-px tiles: both read level 1."""
    p, j = _wsis(slides["svs"], 32, 64, mpp=1.0, stride_div=2)
    assert p._read_level is not None and p._level_ds == j._level_ds == 2.0
    assert (p.grid_x, p.stride) == (j.grid_x, j.stride) == (7, 32)
    for x, y in [(0, 0), (64, 128), (192, 192), (31, 17)]:
        np.testing.assert_array_equal(p.read_tile(x, y), j.read_tile(x, y))
    _same_tiles(p, j)


@pytest.mark.parametrize("method", ["inside", "outside", "ignore"])
def test_roi_filtering_equal_jax(slides, tmp_path, method):
    roi_csv = str(tmp_path / "roi.csv")
    pd.DataFrame({"roi_name": ["r1"] * 4 + ["r2"] * 3,
                  "x_base": [0, 128, 128, 0, 200, 250, 220],
                  "y_base": [0, 0, 256, 256, 10, 40, 90]}).to_csv(
                      roi_csv, index=False)
    p, j = _wsis(slides["tiff"], 32, 32, mpp=1.0, rois=roi_csv,
                 roi_method=method)
    assert p.coords() == j.coords()
    assert (len(p.coords()) == 64) == (method == "ignore")


def test_mpp_from_the_description_equals_jax(tmp_path):
    path = str(tmp_path / "ap.svs")
    write_tiled_tiff(path, _he_like(128, 4), tile=64)
    p, j = _wsis(path, 32, 32)
    assert p.mpp == j.mpp == port_slide.DEFAULT_MPP
    desc = {270: "Aperio Format\n|AppMag = 20|MPP = 0.4963|"}
    for w in (p, j):
        w._img = type("Fake", (), {"tag_v2": desc, "size": (128, 128)})()
    assert p._detect_mpp() == j._detect_mpp() == 0.4963


def test_striped_tiff_is_read_through_pil_as_jax(tmp_path):
    path = str(tmp_path / "striped.tiff")
    Image.fromarray(_he_like(128, 5)).save(path)
    p, j = _wsis(path, 32, 32, mpp=1.0, qc="otsu")
    assert p._tiled is None and j._tiled is None
    _same_tiles(p, j)


@pytest.mark.parametrize("kind", ["png", "svs"])
def test_extract_tiles_writes_jax_bytes(slides, tmp_path, kind):
    p, j = _wsis(slides[kind], 32, 32, mpp=1.0, qc="both")
    n = p.extract_tiles(str(tmp_path / "port.tfrecords"))
    assert n == j.extract_tiles(str(tmp_path / "jax.tfrecords")) > 0
    for suffix in ("", ".index.npy"):
        assert ((tmp_path / f"port.tfrecords{suffix}").read_bytes()
                == (tmp_path / f"jax.tfrecords{suffix}").read_bytes())


def _annotated_project(mod, root, slides_dir, names):
    ann = os.path.join(os.path.dirname(root), "ann.csv")
    os.makedirs(os.path.dirname(root), exist_ok=True)
    pd.DataFrame({"patient": [f"P{i}" for i in range(len(names))],
                  "slide": names,
                  "cohort": ["LUAD", "LUSC"] * (len(names) // 2)}).to_csv(
                      ann, index=False)
    project = mod(root, annotations=ann, name="wsi", create=True)
    project.add_source("S", slides=slides_dir,
                       tfrecords=join(root, "tfrecords"))
    return project


def test_project_extract_tiles_equals_jax(tmp_path):
    slides_dir = tmp_path / "slides"
    slides_dir.mkdir()
    names = ["w0", "w1", "w2", "w3"]
    Image.fromarray(_he_like(128, 10)).save(slides_dir / "w0.png")
    write_tiled_tiff(str(slides_dir / "w1.tiff"), _he_like(128, 11),
                     tile=64, jpeg=True)
    write_tiled_tiff(str(slides_dir / "w2.svs"), _he_like(128, 12), tile=64)
    Image.fromarray(_he_like(128, 13)).save(slides_dir / "w3.jpg")
    Image.fromarray(_he_like(128, 14)).save(slides_dir / "other.png")
    reports = {}
    for name, mod in (("port", PortProject), ("jax", JaxProject)):
        project = _annotated_project(mod, str(tmp_path / name / "proj"),
                                     str(slides_dir), names)
        reports[name] = project.extract_tiles(tile_px=32, tile_um=32,
                                              qc="otsu", mpp=1.0)
        assert os.path.exists(join(project.root,
                                   "tile_extraction_report_32px_32um.pdf"))
        assert project.extract_tiles(tile_px=32, tile_um=32, qc="otsu",
                                     mpp=1.0) == []
    assert reports["port"] == reports["jax"]
    assert [r["slide"] for r in reports["port"]] == names
    for rel in ["extraction_report_32px.csv"] + [
            f"tfrecords/32px_32um/{s}.tfrecords" for s in names]:
        assert ((tmp_path / "port" / "proj" / rel).read_bytes()
                == (tmp_path / "jax" / "proj" / rel).read_bytes()), rel

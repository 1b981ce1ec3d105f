"""Project bootstrap CLI: build training/eval projects and extract tiles.

Counterpart of ``biscuit_tpu/cli/configure.py`` (reference configure.py):
creates the training
(TCGA) and evaluation (CPTAC) projects with their annotation files and tile
sources, registers the GAN tfrecord source, extracts tiles at 299px/302um
(and optionally 512px/400um for GAN training), and writes gan_config.json
(configure.py:62-149).

Deliberate fix (SURVEY.md §2.1 configure row): the reference overwrites the
eval slides path with the train path (`val_slides = abspath(train_slides)`,
configure.py:50); here each project keeps its own slide dir.

``--extract True`` reaches ``Project.extract_tiles`` (``data/slide.py``),
which builds the native data plane at first use.
"""

from __future__ import annotations

import os
from os.path import abspath, join

import click

from ..project import Project
from ..utils_log import write_json


@click.command()
@click.option("--train_slides", default="slides/train",
              help="Directory with training (TCGA) whole-slide images.")
@click.option("--val_slides", default="slides/val",
              help="Directory with evaluation (CPTAC) whole-slide images.")
@click.option("--train_anns", default="annotations/tcga.csv",
              help="Training annotations CSV.")
@click.option("--val_anns", default="annotations/cptac.csv",
              help="Evaluation annotations CSV.")
@click.option("--train_roi", default=None,
              help="Directory with training ROI CSVs (optional).")
@click.option("--out", default="projects",
              help="Output directory for projects.")
@click.option("--extract", default=True, type=bool,
              help="Extract tiles after configuring projects.")
@click.option("--tile_px", default=299, help="Tile size (pixels).")
@click.option("--tile_um", default=302, help="Tile size (microns).")
@click.option("--mpp", default=None, type=float,
              help="Microns per pixel override for slides without metadata.")
@click.option("--qc", default="both",
              type=click.Choice(["both", "otsu", "blur", "none"]),
              help="Tile quality control (configure.py:118: qc='both').")
@click.option("--gan_px", default=512, help="GAN tile size (pixels).")
@click.option("--gan_um", default=400, help="GAN tile size (microns).")
@click.option("--gan_extract", default=True, type=bool,
              help="Also extract high-res tiles for GAN training.")
def configure_projects(train_slides, val_slides, train_anns, val_anns,
                       train_roi, out, extract, tile_px, tile_um, mpp, qc,
                       gan_px, gan_um, gan_extract):
    """Configure training + evaluation projects (configure.py:20-149)."""
    qc = None if qc == "none" else qc
    train_root = join(out, "training")
    eval_root = join(out, "evaluation")

    tP = Project(
        train_root, annotations=abspath(train_anns), name="TCGA", create=True
    )
    tP.add_source(
        "Training",
        slides=abspath(train_slides),
        roi=abspath(train_roi) if train_roi else "",
        tiles=join(train_root, "tiles"),
        tfrecords=join(train_root, "tfrecords"),
    )
    # GAN-intermediate synthetic tile source (SURVEY.md §2.3 E13).
    tP.add_source("LUNG_GAN", tfrecords=join(train_root, "gan_tfrecords"))

    vP = Project(
        eval_root, annotations=abspath(val_anns), name="CPTAC", create=True
    )
    vP.add_source(
        "Evaluation",
        slides=abspath(val_slides),
        tiles=join(eval_root, "tiles"),
        tfrecords=join(eval_root, "tfrecords"),
    )

    if extract:
        extract_kw = {"qc": qc, "img_format": "png"}
        if mpp is not None:
            extract_kw["mpp"] = mpp
        for P in (tP, vP):
            P.extract_tiles(tile_px=tile_px, tile_um=tile_um, **extract_kw)
        if gan_extract:
            # High-resolution tiles for GAN training (configure.py:125-132).
            tP.extract_tiles(tile_px=gan_px, tile_um=gan_um, **extract_kw)

    write_json(
        {
            "project_path": abspath(train_root),
            "tile_px": gan_px,
            "tile_um": gan_um,
            "model_type": "categorical",
            "outcome_label_headers": "cohort",
            "resize": [299, 302],
        },
        join(out, "gan_config.json"),
    )
    click.echo(f"Configured projects at {out}")


if __name__ == "__main__":
    configure_projects()

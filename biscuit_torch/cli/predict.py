"""Servable batch-scoring CLI: artifact + tfrecords -> predictions CSV.

Counterpart of ``biscuit_tpu/cli/predict.py``: scores a tile corpus with
only the artifact file (``serve.export_servable``) and writes the
tile-prediction contract (slide, loc_x, loc_y,
``{outcome}_y_true0``/``_y_pred{i}``/``_uncertainty{i}``), which feeds
``threshold.from_cv``/``apply`` and the rest of the statistics.

    python -m biscuit_torch.cli.predict ARTIFACT tiles/*.tfrecords -o out.csv

It serves on the card when the artifact lists it (``--device cpu`` off
it). ``--sharded`` and ``--distributed`` (several cards, several hosts)
are not ported yet (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import os
import time
from glob import glob

import click

from ..utils_log import log

_SLIDE_EXTS = (".svs", ".tif", ".tiff", ".png", ".jpg", ".jpeg")


def _expand(paths, slides=False):
    pats = _SLIDE_EXTS if slides else (".tfrecords",)
    out = []
    for p in paths:
        if os.path.isdir(p):
            for ext in pats:
                out.extend(sorted(glob(os.path.join(p, f"*{ext}"))))
        else:
            out.append(p)
    if not out:
        raise click.UsageError(
            f"no {'slides' if slides else 'tfrecords'} found")
    return out


def _labels_from_annotations(annotations, outcome, classes=None):
    """slide -> int label by the Dataset.labels convention (sorted unique
    outcome values, read as strings).

    ``classes`` pins the training-time class order (from --classes or the
    artifact's ``outcome_labels``). Without it, annotations holding a
    subset or a superset of the training outcomes would remap the class
    indices, so a mismatch is an error, not a reindex."""
    import pandas as pd

    # dtype=str, as the project reads annotations: numeric-looking slide
    # ids join the tfrecords' string names, and numeric outcome codes sort
    # as strings, the order the model was trained with.
    df = pd.read_csv(annotations, dtype=str)
    if "slide" not in df.columns or outcome not in df.columns:
        raise click.UsageError(
            f"annotations must have 'slide' and {outcome!r} columns")
    sub = df[["slide", outcome]].dropna()
    seen = sorted(sub[outcome].unique().tolist())
    if classes is not None:
        classes = [str(c) for c in classes]
        extra = [v for v in seen if v not in classes]
        if extra:
            raise click.UsageError(
                f"annotations carry outcome values {extra} not in the "
                f"training class order {classes}: wrong annotations file "
                "or wrong --outcome column")
        unique = classes
    else:
        unique = seen
        if len(seen) < 2:
            raise click.UsageError(
                f"annotations contain only one outcome value ({seen}); "
                "class indices derived from them would not match training "
                "— pass --classes with the training label order (or use an "
                "artifact exported with outcome_labels metadata)")
    index = {name: i for i, name in enumerate(unique)}
    return {s: index[v] for s, v in zip(sub["slide"], sub[outcome])}, unique


_ITEM_9 = ("is not ported yet (ROADMAP.md Queue 1 item 9, parallelism); "
           "score in one process")


@click.command()
@click.argument("artifact")
@click.argument("tfrecords", nargs=-1, required=True)
@click.option("-o", "--out", default="tile_predictions.csv",
              show_default=True, help="Output CSV (or .parquet.gzip with "
                                      "--parquet).")
@click.option("--annotations", default=None,
              help="Annotations CSV supplying y_true (slide + outcome "
                   "columns); without it y_true0 is -1.")
@click.option("--outcome", default="cohort", show_default=True,
              help="Outcome name (column prefix + annotations column).")
@click.option("--sharded/--no-sharded", default=None,
              help="Fan the artifact over several cards: not ported yet "
                   "(ROADMAP.md Queue 1 item 9).")
@click.option("--max-tiles", default=None, type=int,
              help="Per-tfrecord (or, with --slides, per-slide) tile cap.")
@click.option("--classes", default=None,
              help="Comma-separated training class order (overrides the "
                   "artifact's outcome_labels header); y_true indices are "
                   "validated against it instead of being derived from "
                   "whatever values the annotations happen to contain.")
@click.option("--seed", default=None, type=int,
              help="Seed pinning the MC-dropout streams (batch b draws from "
                   "(seed << 32) | b); default: the servable's internal "
                   "stream, which a fresh process repeats.")
@click.option("--parquet", is_flag=True,
              help="Write parquet.gzip instead of CSV.")
@click.option("--slides", is_flag=True,
              help="Inputs are whole-slide images (.svs/.tif/...), scored "
                   "directly off the tile grid, with no extraction step.")
@click.option("--tile-um", default=None, type=int,
              help="Tile microns for --slides (default: the artifact's).")
@click.option("--mpp", default=None, type=float,
              help="Microns/pixel for --slides inputs without resolution "
                   "metadata (plain PNG/JPEG).")
@click.option("--qc", default="both", show_default=True,
              help="--slides tile QC: both|otsu|blur|none.")
@click.option("--distributed", "dist_workdir", default=None,
              help="Fleet scoring over several hosts: not ported yet "
                   "(ROADMAP.md Queue 1 item 9).")
@click.option("--device", default=None,
              help="Serving device (default: the card when the artifact "
                   "lists it).")
def main(artifact, tfrecords, out, annotations, outcome, sharded, max_tiles,
         classes, seed, parquet, slides, tile_um, mpp, qc, dist_workdir,
         device):
    """Score TFRECORDS (files or directories of {slide}.tfrecords, or
    slide images with --slides) with ARTIFACT and write a tile
    predictions frame."""
    from ..serve import load_servable, predict_slides, predict_tfrecords

    if sharded:
        raise NotImplementedError(f"--sharded {_ITEM_9}")
    if dist_workdir is not None:
        raise NotImplementedError(f"--distributed {_ITEM_9}")
    paths = _expand(tfrecords, slides=slides)
    sv = load_servable(artifact, device=device)
    log.info(f"servable: {sv.tile_px}px, K={sv.k}, {sv.batch_size} "
             f"tiles/dispatch, platforms={sv.platforms}, on {sv.device}")

    labels = {}
    if annotations is not None:
        if slides:
            raise click.UsageError(
                "--annotations applies to tfrecord scoring (slides carry "
                "no tile labels)")
        # Training class order: --classes wins, else the artifact's
        # outcome_labels; without either, the annotations must hold at
        # least two classes (_labels_from_annotations).
        pinned = (classes.split(",") if classes
                  else sv.header.get("outcome_labels"))
        labels, unique = _labels_from_annotations(annotations, outcome,
                                                  classes=pinned)
        src = ("--classes" if classes else
               "artifact" if pinned else "annotations")
        log.info(f"labels: {unique} (order from {src})")

    t0 = time.perf_counter()
    if slides:
        df = predict_slides(sv, paths, tile_um=tile_um, mpp=mpp,
                            qc=None if qc == "none" else qc,
                            outcome=outcome, max_tiles=max_tiles, seed=seed)
    else:
        df = predict_tfrecords(sv, paths, labels=labels, outcome=outcome,
                               max_tiles=max_tiles, seed=seed)
    dt = time.perf_counter() - t0
    if parquet:
        # Only an explicit .csv suffix (the default name among them) is
        # rewritten; any other -o value is written as given.
        if out.endswith(".csv"):
            out = out[:-len(".csv")] + ".parquet.gzip"
        df.to_parquet(out, compression="gzip")
    else:
        df.to_csv(out, index=False)
    log.info(f"{len(df)} tiles from {len(paths)} inputs in {dt:.1f}s "
             f"({len(df) / max(dt, 1e-9):.0f} tiles/s incl. host decode)")
    click.echo(out)


if __name__ == "__main__":
    main()

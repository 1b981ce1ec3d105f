"""Servable batch-scoring CLI: artifact + tfrecords -> predictions CSV.

Counterpart of ``biscuit_tpu/cli/predict.py``: scores a tile corpus with
only the artifact file (``serve.export_servable``) and writes the
tile-prediction contract (slide, loc_x, loc_y,
``{outcome}_y_true0``/``_y_pred{i}``/``_uncertainty{i}``), which feeds
``threshold.from_cv``/``apply`` and the rest of the statistics.

    python -m biscuit_torch.cli.predict ARTIFACT tiles/*.tfrecords -o out.csv

It serves on the card when the artifact lists it (``--device cpu`` off
it). ``--sharded`` fans the artifact over every card of the process
(the default when it has more than one; with ``--device`` over that
device alone). ``--distributed WORKDIR`` scores across processes: run
the command in every process of a runtime that torchrun's variables
describe (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``);
the processes claim the inputs through the store on ``MASTER_ADDR``,
their shards meet in WORKDIR, and main writes the output.
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
              help="Fan the artifact over every card of this process "
                   "(default: when it has more than one).")
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
              help="Score across the processes of a torchrun-style runtime: "
                   "run this command in every process; they claim inputs "
                   "through the store and their shards merge through this "
                   "SHARED directory. Main alone writes the output.")
@click.option("--device", default=None,
              help="Serving device (default: the card when the artifact "
                   "lists it).")
def main(artifact, tfrecords, out, annotations, outcome, sharded, max_tiles,
         classes, seed, parquet, slides, tile_um, mpp, qc, dist_workdir,
         device):
    """Score TFRECORDS (files or directories of {slide}.tfrecords, or
    slide images with --slides) with ARTIFACT and write a tile
    predictions frame."""
    from ..parallel import distributed
    from ..parallel.mesh import data_parallel_mesh, local_devices
    from ..serve import (
        load_servable,
        load_sharded_servable,
        predict_slides,
        predict_slides_distributed,
        predict_tfrecords,
        predict_tfrecords_distributed,
    )

    if dist_workdir is not None:
        distributed.initialize()
    paths = _expand(tfrecords, slides=slides)
    if sharded is None:
        sharded = device is None and len(local_devices()) > 1
    if sharded:
        # A process-local mesh: claims are independent per process.
        sv = load_sharded_servable(artifact, mesh=data_parallel_mesh(
            None if device is None else [device]))
    else:
        sv = load_servable(artifact, device=device)
    step = getattr(sv, "global_batch", sv.batch_size)
    log.info(f"{'sharded ' if sharded else ''}servable: {sv.tile_px}px, "
             f"K={sv.k}, {step} tiles/dispatch, platforms={sv.platforms}, "
             f"on {sv.device}")

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
    slide_kw = dict(tile_um=tile_um, mpp=mpp, qc=None if qc == "none" else qc,
                    outcome=outcome, max_tiles=max_tiles, seed=seed)
    tfr_kw = dict(labels=labels, outcome=outcome, max_tiles=max_tiles,
                  seed=seed)
    if slides and dist_workdir is not None:
        df = predict_slides_distributed(sv, paths, dist_workdir, **slide_kw)
    elif slides:
        df = predict_slides(sv, paths, **slide_kw)
    elif dist_workdir is not None:
        df = predict_tfrecords_distributed(sv, paths, dist_workdir, **tfr_kw)
    else:
        df = predict_tfrecords(sv, paths, **tfr_kw)
    dt = time.perf_counter() - t0
    if dist_workdir is not None and not distributed.is_main():
        # Every process holds the same merged frame; main writes it.
        log.info(f"{len(df)} tiles merged; main writes {out}")
        return
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

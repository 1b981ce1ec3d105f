"""Results/figures CLI: regenerate the paper figures.

Counterpart of ``biscuit_tpu/cli/results.py`` (reference results.py):
cross-validation curves (Figs 2-4 data), class-ratio comparisons and GAN
results (Fig 7, results.py:310-347), from the trees ``Experiment.run``
writes, and the UQ heatmaps with their tile export (Fig 5,
``--heatmap``) and the UMAP mosaics (Fig 6, ``--umap``), whose inference
runs on ``--device`` (the card by default).
"""

from __future__ import annotations

import os
from os.path import join

import click
import numpy as np

from ..experiment import Experiment, published_matrix
from ..utils_log import log


@click.command()
@click.option("--train_project", default="projects/training")
@click.option("--eval_project", "eval_projects", multiple=True,
              default=("projects/evaluation",))
@click.option("--outcome", default="cohort")
@click.option("--outdir", default="results")
@click.option("--reg", default=True, type=bool,
              help="Assemble regular cross-val/eval results + figures.")
@click.option("--ratio", default=False, type=bool,
              help="Assemble class-ratio experiment results.")
@click.option("--umap", "umaps", default=False, type=bool,
              help="Generate UMAP mosaics (Figure 6).")
@click.option("--heatmap", "heatmaps", default=False, type=bool,
              help="Generate UQ heatmaps (Figure 5).")
@click.option("--heatmap_slide", default=None,
              help="Slide image path for the heatmap figure.")
@click.option("--gan", default=False, type=bool,
              help="Assemble GAN-fraction results (Figure 7).")
@click.option("--subset", default=None,
              help="Comma-separated experiment IDs (default: full ladder).")
@click.option("--device", default=None,
              help="Where the heatmap and UMAP models run (default: the "
                   "card; 'cpu' asks for the CPU).")
def show_results(train_project, eval_projects, outcome, outdir, reg, ratio,
                 umaps, heatmaps, heatmap_slide, gan, subset, device):
    """Assemble results and regenerate figures (results.py:33-267)."""
    import pandas as pd

    exp = Experiment(
        train_project, eval_projects=list(eval_projects),
        outcome=outcome, outdir=outdir,
    )
    os.makedirs(outdir, exist_ok=True)
    ladder = None if subset is None else subset.split(",")
    matrix = published_matrix(ladder=ladder)

    if reg:
        # Figures 1, 2, 4 data: the full regular grid over both orderings
        # (results.py:94-99, 125-128).
        all_reg = dict(matrix["reg1"])
        for grp in ("rev1", "reg2", "rev2"):
            all_reg.update(matrix.get(grp, {}))
        df, eval_dfs = exp.results(list(all_reg), uq=True, eval=True)
        if len(df):
            exp.display(df, eval_dfs, hue="uq", prefix="reg_")
            click.echo(f"Cross-val results: {len(df)} rows -> "
                       f"{join(outdir, 'crossval_results.csv')}")

    if ratio:
        # Figure 3: 1:1 vs 3:1 vs 10:1 comparison restricted to the sizes
        # present in the 10:1 arm, plus per-ratio UQ displays
        # (results.py:133-167).
        r1_df, _ = exp.results(list(matrix["reg1"]), uq=True, eval=False)
        r3_df, _ = exp.results(list(matrix["ratio_3"]), uq=True, eval=False)
        r10_df, _ = exp.results(list(matrix["ratio_10"]), uq=True,
                                eval=False)
        r1_df["ratio"] = "1"
        r3_df["ratio"] = "3"
        r10_df["ratio"] = "10"
        rdf = pd.concat([r1_df, r3_df, r10_df], join="outer",
                        ignore_index=True)
        if not len(r10_df):
            click.echo("Ratio training not yet done - unable to show "
                       "results")
        else:
            n_in_r10 = np.unique(r10_df["n_slides"].to_numpy())
            rdf = rdf.loc[rdf["n_slides"].isin(n_in_r10)]
            exp.display(rdf.loc[rdf["uq"] != "include"], None, hue="ratio",
                        palette="Set1", prefix="ratio_comparison_")
            exp.display(r3_df, None, hue="uq", prefix="ratio3_")
            exp.display(r10_df, None, hue="uq", prefix="ratio10_")
            rdf.to_csv(join(outdir, "ratio_results.csv"), index=False)
            click.echo(f"Ratio results -> {join(outdir, 'ratio_results.csv')}")

    if gan:
        # Figure 7: GAN-fraction overview vs the regular arm, then the
        # n=500 UQ comparison (results.py:310-347).
        gan_df, _ = exp.results(list(matrix["gan"]), uq=True, eval=False)
        if not len(gan_df):
            click.echo("Unable to find GAN results.")
        else:
            reg_df, _ = exp.results(list(matrix["reg1"]), uq=True,
                                    eval=False)
            reg_df = reg_df.loc[(reg_df["uq"] != "include")
                                & (reg_df["n_slides"] <= 500)].copy()
            reg_df["gan_exp"] = "none"
            gdf = gan_df.copy()
            gdf["gan_exp"] = gdf["id"].str[-3:]
            gdf = gdf.loc[gdf["uq"] != "include"]
            gdf = pd.concat([gdf, reg_df], join="outer", ignore_index=True)
            exp.display(gdf, None, hue="gan_exp", relplot_uq_compare=False,
                        prefix="gan_")
            # n=500 (R) with UQ thresholding.
            r_exp = Experiment.config("{}", ["R"], 1, order="f")
            r_exp.update(Experiment.config("{}_R", ["R"], 1, order="r"))
            r_df, _ = exp.results(list(r_exp), uq=True, eval=False)
            uq_df, _ = exp.results(list(matrix["gan"]), uq=True, eval=False)
            uq_df = uq_df.loc[uq_df["id"].str[0] == "R"]
            uq_df = pd.concat([uq_df, r_df], join="outer",
                              ignore_index=True)
            uq_df = uq_df.loc[uq_df["uq"].isin(["all", "include"])]
            exp.display(uq_df, None, boxplot_uq_compare=False,
                        ttest_uq_groups=("all", "include"),
                        prefix="gan_uq_")
            gan_df["gan_fraction"] = (
                gan_df["id"].str[-2:].astype(int))
            gan_df.to_csv(join(outdir, "gan_results.csv"), index=False)
            click.echo(f"GAN results -> {join(outdir, 'gan_results.csv')}")

    if heatmaps:
        _generate_uq_heatmaps(exp, heatmap_slide, outdir, device)

    if umaps:
        _generate_umap_mosaics(exp, outdir, device)


def _generate_uq_heatmaps(exp, slide_path, outdir, device=None):
    """Figure 5: whole-slide heatmap with high-confidence masking
    (results.py:179-227): recompute the tile-UQ threshold from nested CV,
    run grid inference, mask uncertain tiles to [-1, -1]."""
    from .. import utils
    from ..heatmap import Heatmap, export_tiles_by_uncertainty

    if slide_path is None:
        slides = exp.train_project.dataset().slide_paths()
        if not slides:
            log.warning("No slide images registered; skipping heatmaps")
            return
        slide_path = slides[0]

    _, thresh = exp.thresholds_from_nested_cv("EXP_AA_UQ")
    if thresh["tile_uq"] is None:
        log.warning("No nested-CV thresholds for EXP_AA_UQ; skipping heatmap")
        return
    model = utils.find_model(
        exp.train_project, "EXP_AA_FULL", outcome=exp.outcome, epoch=1
    )
    hm = Heatmap(slide_path, model, stride_div=1, device=device)
    hm.save(join(outdir, "heatmap_raw"))
    # High-confidence masking (results.py:222-227).
    uq_mask = hm.uncertainty[:, :, 0] > thresh["tile_uq"]
    hm.logits[uq_mask, :] = [-1, -1]
    hm.save(join(outdir, "heatmap_masked"))
    # Per-tile UQ inference + export by uncertainty (results.py:234-265),
    # batched.
    export_tiles_by_uncertainty(
        slide_path, model, tile_uq=thresh["tile_uq"],
        outdir=join(outdir, "tiles"), device=device,
    )
    click.echo(f"Heatmaps + UQ tile export -> {outdir}")


def _generate_umap_mosaics(exp, outdir, device=None):
    """Figure 6: UMAP of penultimate features labeled by logits /
    uncertainty / slide + tile mosaic (results.py:269-306)."""
    from PIL import Image

    from .. import utils
    from ..mosaic import (
        generate_features,
        generate_mosaic,
        slide_map_from_features,
    )

    model = utils.find_model(
        exp.train_project, "EXP_AA_FULL", outcome=exp.outcome, epoch=1
    )
    tfrecords = exp.train_project.dataset().tfrecords()
    if not tfrecords:
        log.warning("No tfrecords found; skipping UMAP")
        return
    features, meta, tiles = generate_features(
        model, tfrecords, max_tiles=100, keep_tiles=True,
        cache=join(outdir, "feature_cache.npz"), device=device,
    )
    smap = slide_map_from_features(features, meta, tiles)
    smap.label_by_logits(1)
    smap.save(join(outdir, "umap_logits.png"))
    smap.label_by_uncertainty(1)
    smap.save(join(outdir, "umap_uncertainty.png"))
    smap.label_by_slide()
    smap.save(join(outdir, "umap_slide.png"))
    if tiles is not None:
        mosaic_img = generate_mosaic(features, meta, tiles)
        Image.fromarray(mosaic_img).save(join(outdir, "mosaic.png"))
    click.echo(f"UMAP figures -> {outdir}")


if __name__ == "__main__":
    show_results()

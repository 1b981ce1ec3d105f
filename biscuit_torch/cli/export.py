"""Servable-export CLI: saved model dir -> single-file artifact.

Counterpart of ``biscuit_tpu/cli/export.py``, the command-line face of
:mod:`biscuit_torch.serve`: export once, ship the artifact.

    python -m biscuit_torch.cli.export MODEL_DIR [-o artifact] [-b 256]
"""

from __future__ import annotations

import os

import click

from ..utils_log import log


@click.command()
@click.argument("model_dir")
@click.option("-o", "--out", default=None,
              help="Artifact path (default MODEL_DIR/servable.biscuit).")
@click.option("-b", "--batch-size", default=256, show_default=True,
              help="Static batch of the exported program (256, the batch "
                   "chip_smoke.py serves and times on an NVIDIA H100 80GB "
                   "HBM3; smaller for latency-sensitive serving).")
@click.option("-k", default=None, type=int,
              help="MC-dropout samples (default: the model's hp.uq_samples).")
@click.option("--platform", "platforms", multiple=True,
              type=click.Choice(["cuda", "cpu"]),
              help="Device type(s) the artifact runs on, e.g. --platform "
                   "cuda --platform cpu. Default: the export device's. "
                   "More than one needs --no-fused.")
@click.option("--fused/--no-fused", "use_kernels", default=None,
              help="Put the serving kernels in the program (default: when "
                   "exporting on the card). --no-fused exports a portable "
                   "program with no custom op.")
@click.option("--fuse-blocks", is_flag=True,
              help="Run the strided blocks through their kernel too "
                   "(needs the kernels).")
@click.option("--features/--no-features", "with_features", default=True,
              show_default=True,
              help="Also export the feature program (trunk features + "
                   "K-pass head), so that mosaics run off the artifact.")
@click.option("--features-k", default=8, show_default=True, type=int,
              help="MC-dropout samples of the feature program's head.")
@click.option("--device", default=None,
              help="Export device (default: the card; 'cpu' off it).")
def main(model_dir, out, batch_size, k, platforms, use_kernels, fuse_blocks,
         with_features, features_k, device):
    """Export MODEL_DIR (params.json + model.msgpack) to a servable."""
    from ..serve import export_servable

    path = export_servable(
        model_dir,
        out_path=out,
        batch_size=batch_size,
        k=k,
        platforms=list(platforms) or None,
        use_kernels=use_kernels,
        fuse_blocks=fuse_blocks,
        with_features=with_features,
        features_k=features_k,
        device=device,
    )
    log.info(f"exported {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
    click.echo(path)


if __name__ == "__main__":
    main()

"""Full-model import CLI: staged Keras weights -> the port's model dir.

Counterpart of ``biscuit_tpu/cli/import_model.py``, with the same options
and defaults: the way to bring the published model (the reference README
points at huggingface.co/jamesdolezal/lung-adeno-squam-v1, a slideflow
tf.keras model: Xception trunk, 2x1024 hidden head, 2-class logits) into
the port. Stage its weights on a machine with egress, walking
``m.layers`` in graph order (the order the head matcher relies on):

    import numpy as np, tensorflow as tf
    m = tf.keras.models.load_model("lung-adeno-squam-v1")
    flat = {}
    for layer in m.layers:
        for w in layer.weights:
            wname = w.name.split("/")[-1].split(":")[0]
            flat[f"{layer.name}/{wname}"] = np.asarray(w)
    np.savez("lung_adeno_squam.npz", **flat)

then:

    python -m biscuit_torch.cli.import_model lung_adeno_squam.npz models/
    python -m biscuit_torch.cli.export <printed model dir>     # -> servable
    python -m biscuit_torch.cli.predict <artifact> tiles/      # -> CSVs

The model is built on the CPU and written with the port's
``save_checkpoint`` (params.json + model.msgpack), a model dir that both
packages load. The hyperparameter flags must describe the exported
architecture (defaults: the published nature2022 config); a mismatch
fails at shape validation and never loads sideways.
"""

from __future__ import annotations

import click

from ..utils_log import log


@click.command()
@click.argument("weights")
@click.argument("out_dir")
@click.option("--arch", default="xception", show_default=True,
              help="Backbone arch (ARCHS registry).")
@click.option("--tile-px", default=299, show_default=True)
@click.option("--tile-um", default=302, show_default=True)
@click.option("--hidden-layers", default=2, show_default=True)
@click.option("--hidden-width", default=1024, show_default=True)
@click.option("--normalizer", default="reinhard_fast", show_default=True,
              help="Stain normalizer baked into serving preprocess "
                   "('none' to disable).")
@click.option("--outcome", default="cohort", show_default=True)
@click.option("--label", default="imported", show_default=True)
@click.option("--uq-samples", default=30, show_default=True,
              help="MC-dropout samples K for UQ serving.")
@click.option("--dropout", default=0.1, show_default=True)
def main(weights, out_dir, arch, tile_px, tile_um, hidden_layers,
         hidden_width, normalizer, outcome, label, uq_samples, dropout):
    """Import WEIGHTS (.h5/.npz full-model export) into OUT_DIR as a
    model dir (printed on success)."""
    import torch

    from ..hp import nature2022_params
    from ..models.pretrained import load_pretrained_full
    from ..models.xception import build_model
    from ..train.trainer import init_model, save_checkpoint

    hp = nature2022_params()
    hp.model = arch
    hp.tile_px = tile_px
    hp.tile_um = tile_um
    hp.hidden_layers = hidden_layers
    hp.hidden_layer_width = hidden_width
    hp.normalizer = None if normalizer in ("none", "") else normalizer
    hp.dropout = dropout
    hp.uq = True
    hp.uq_samples = uq_samples
    # Imported weights are inference artifacts; pretrained='imagenet'
    # would graft staged trunk weights on any retrain from this dir.
    hp.pretrained = None

    model = init_model(build_model(hp), hp, torch.Generator().manual_seed(0))
    load_pretrained_full(model, weights)
    sub = save_checkpoint(out_dir, model, hp, epoch=1, outcome=outcome,
                          label=label, kfold=None)
    log.info(f"imported {weights} -> {sub}")
    click.echo(sub)


if __name__ == "__main__":
    main()

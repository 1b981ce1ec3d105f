"""GAN-intermediate synthetic-tile consumption path.

The port's counterpart of ``biscuit_tpu/gan.py``. The reference study
trains a class-conditional StyleGAN2 in a separate repo and consumes its
output: 512px/400um synthetic tiles packed as tfrecords in a ``LUNG_GAN``
source, resized to 299px, mixed into training at a ``gan`` fraction
(experiment.py:103-143, configure.py:77-83,135-149), and scored through
the UQ threshold pipeline. This module is the consumption path:

* :func:`resize_batch` — bilinear 512->299 resize on the tiles' device,
  with ``jax.image.resize``'s weights (antialiased where it downsamples);
* :func:`score_gan_tiles` — K-pass MC-dropout UQ scoring of synthetic
  tiles with the tile-prediction CSV contract, so GAN tiles flow through
  threshold.detect/apply unchanged. The resized float tiles take the
  plain normalizer and standardization (the preprocess kernel takes
  uint8 tiles); on the card the trunk's middle flow and the MC head run
  their kernels;
* :func:`add_gan_annotations` — annotation rows with site='GAN' and gan=1,
  the schema Experiment.add's GAN fraction selects on.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import pandas as pd
import torch

from .utils_log import log


def _weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) f32 weights of ``jax.image.resize``'s "bilinear"
    (``scale_and_translate`` with the triangle kernel, antialiased),
    computed as it computes them, in f32: the kernel widened by the scale
    where it downsamples, each column normalized, columns whose sample
    lies outside the input zeroed."""
    f32 = torch.float32
    inv_scale = torch.tensor(1.0, dtype=f32) / torch.tensor(n_out / n_in,
                                                            dtype=f32)
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() \
        / kernel_scale
    w = torch.clamp_min(1.0 - x.abs(), 0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros((), dtype=f32))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros((), dtype=f32)).to(
        device)


def resize_batch(images, out_px: int) -> torch.Tensor:
    """Bilinear resize (N, H, W, C) -> (N, out_px, out_px, C) f32 on the
    images' device (numpy input goes to the CPU): half-pixel centres and,
    where it downsamples, a triangle filter widened by the scale, with
    ``jax.image.resize(..., "bilinear")``'s f32 weights. The two separable
    contractions run in f64, so the card and the CPU give the same f32
    result whatever the process's TF32 setting."""
    x = torch.as_tensor(images)
    n, h, w, c = x.shape
    wh = _weights(h, out_px, x.device).double()
    ww = _weights(w, out_px, x.device).double()
    y = torch.einsum("nhwc,hp,wq->npqc", x.double(), wh, ww)
    return y.float().contiguous()


def score_gan_tiles(
    model_path: str,
    gan_tfrecords: List[str],
    outcome: str = "cohort",
    out_csv: Optional[str] = None,
    batch_size: int = 64,
    k: Optional[int] = None,
    max_tiles: Optional[int] = None,
    gan_px: int = 512,
    device=None,
):
    """Score synthetic tiles through the UQ pipeline.

    Reads gan_px tiles, resizes them on ``device`` (the card unless
    ``device="cpu"``) to the model's tile_px, runs stain norm +
    standardization + K-pass MC dropout, and returns (and optionally
    writes) a tile-predictions frame with the standard column contract
    (slide, {outcome}_y_true0, {outcome}_y_pred*, {outcome}_uncertainty*),
    ready for threshold.detect/apply. Each batch draws its dropout from
    the interface's per-call seed stream.
    """
    from .data.pipeline import TileBatcher
    from .train.trainer import load_checkpoint
    from .train.uq import UncertaintyInterface
    from .utils import tile_predictions_frame

    model, hp, _ = load_checkpoint(model_path, device)
    dev = next(model.parameters()).device
    interface = UncertaintyInterface.from_model(
        model, hp, k=k if k is not None else hp.uq_samples, device=dev)

    batcher = TileBatcher(
        gan_tfrecords, {}, batch_size=batch_size, shuffle=False,
        infinite=False, max_tiles=max_tiles, tile_px=gan_px,
    )
    rows = {"slide": [], "loc_x": [], "loc_y": [], "y_true": []}
    probs_all, unc_all = [], []
    try:
        for batch in batcher:
            x = resize_batch(torch.from_numpy(batch["image"]).to(dev),
                             hp.tile_px)
            mean, std = interface(x)
            m = np.asarray(batch["mask"])
            probs_all.append(mean.float().cpu().numpy()[m])
            unc_all.append(std.float().cpu().numpy()[m])
            for i in np.where(m)[0]:
                rows["slide"].append(batch["slide"][i])
                rows["loc_x"].append(int(batch["loc"][i, 0]))
                rows["loc_y"].append(int(batch["loc"][i, 1]))
                rows["y_true"].append(int(batch["label"][i]))
    finally:
        batcher.close()
    probs = (np.concatenate(probs_all) if probs_all
             else np.zeros((0, 2), np.float32))
    unc = np.concatenate(unc_all) if unc_all else None
    df = tile_predictions_frame(outcome, pd.DataFrame(rows), probs, unc)
    if out_csv:
        os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
        df.to_csv(out_csv, index=False)
        log.info(f"GAN tile predictions -> {out_csv}")
    return df


def add_gan_annotations(
    annotations_path: str,
    gan_slides: Dict[str, str],
    outcome: str = "cohort",
) -> None:
    """Append GAN synthetic-slide rows (site='GAN', gan=1) to an annotations
    file — the schema Experiment.add's GAN fraction machinery selects on.

    Args:
        gan_slides: {slide_name: outcome_label} for the synthetic tfrecords.
    """
    ann = pd.read_csv(annotations_path, dtype=str)
    if "gan" not in ann.columns:
        ann["gan"] = "0"
    if "site" not in ann.columns:
        ann["site"] = "?"
    if "order" not in ann.columns:
        ann["order"] = [str(i) for i in range(len(ann))]
    new_rows = []
    existing = set(ann["slide"])
    max_order = pd.to_numeric(ann["order"]).max()
    for i, (slide, label) in enumerate(sorted(gan_slides.items())):
        if slide in existing:
            continue
        new_rows.append(
            {
                "patient": slide,
                "slide": slide,
                outcome: label,
                "site": "GAN",
                "gan": "1",
                "order": str(int(max_order) + 1 + i),
            }
        )
    if new_rows:
        ann = pd.concat([ann, pd.DataFrame(new_rows)], ignore_index=True)
        ann.to_csv(annotations_path, index=False)
        log.info(f"Added {len(new_rows)} GAN rows to {annotations_path}")

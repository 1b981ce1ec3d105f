"""Whole-slide prediction/uncertainty heatmaps via batched grid inference.

The port's counterpart of ``biscuit_tpu/heatmap.py`` (the stand-in for
sf.Heatmap; reference call sites results.py:216-227): runs the UQ
interface over the slide's tile grid and exposes ``logits`` (y, x,
classes) and ``uncertainty`` (y, x, 1) arrays, -99 where no tile was
scored (QC or ROI), the attributes the reference masks for Figure 5
(``hm.logits[uq_mask, :] = [-1, -1]``, results.py:222-223), plus
``save()`` with a configurable colormap.

Tiles are read on the host (``data/slide.py``) and stream in batches
through the port's ``UncertaintyInterface`` on ``device`` (the card
unless ``device="cpu"``): on the card the preprocess, middle-flow and MC
head kernels, once a batch. ``model`` may also be a servable artifact
(``serve.py``), which then scores the batches at its exported batch size.
Each batch draws its dropout from the interface's per-call seed stream,
where the JAX package splits a key a batch.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from .data.slide import WSI
from .utils_log import log

def _load_interface(model: str, k: Optional[int], device):
    """(callable, tile_px, tile_um) from a model dir or a servable
    artifact (``serve.py``; sniffed by its magic, whatever its name). Both
    keep the ``UncertaintyInterface`` call contract, so grid inference
    runs from either."""
    from .serve import is_servable_artifact

    if is_servable_artifact(model):
        from .serve import load_servable

        sv = load_servable(model, device=device)
        if k is not None and k != sv.k:
            raise ValueError(
                f"k={k} requested but the artifact bakes K={sv.k}; "
                "re-export with the wanted k")
        if sv.tile_um is None:
            raise ValueError(
                "the artifact records no tile_um; re-export it (or use a "
                "model dir)")
        return sv, sv.tile_px, sv.tile_um
    from .train.uq import UncertaintyInterface

    interface = UncertaintyInterface(model, k=k, device=device)
    return interface, interface.hp.tile_px, interface.hp.tile_um


def _auto_batch(batch_size, interface, default: int = 64) -> int:
    """``batch_size=None``: an artifact's exported static batch (a smaller
    one would pad every call up to it), else ``default``."""
    if batch_size is not None:
        return batch_size
    exported = getattr(interface, "batch_size", None)
    return int(exported) if exported else default


class _GridScorer:
    """Batches a slide's tiles through an interface, padding the last
    batch, and keeps the host read and the scoring times apart."""

    def __init__(self, interface, batch_size: int):
        self.interface = interface
        self.batch_size = batch_size
        self.timings = {"tiles": 0, "batches": 0, "read_s": 0.0,
                        "score_s": 0.0}

    def batches(self, wsi: WSI, max_tiles: Optional[int] = None):
        """Yield (images, locs, probs (n, C), unc (n, C)) numpy a batch."""
        imgs, locs = [], []
        gen = wsi.build_generator(include_loc="grid")()
        t = time.perf_counter()
        for idx, item in enumerate(gen):
            if max_tiles is not None and idx >= max_tiles:
                break
            imgs.append(item["image"])
            locs.append(item["loc"])
            if len(imgs) == self.batch_size:
                self.timings["read_s"] += time.perf_counter() - t
                yield self._score(imgs, locs)
                imgs, locs = [], []
                t = time.perf_counter()
        self.timings["read_s"] += time.perf_counter() - t
        if imgs:
            yield self._score(imgs, locs)

    def _score(self, imgs, locs):
        t = time.perf_counter()
        n_valid = len(imgs)
        batch = np.zeros((self.batch_size,) + imgs[0].shape, np.uint8)
        batch[:n_valid] = np.stack(imgs)
        probs, unc = self.interface(batch)
        probs = probs.float().cpu().numpy()[:n_valid]
        unc = unc.float().cpu().numpy()[:n_valid]
        self.timings["score_s"] += time.perf_counter() - t
        self.timings["tiles"] += n_valid
        self.timings["batches"] += 1
        return imgs, locs, probs, unc


def export_tiles_by_uncertainty(
    slide: str,
    model: str,
    tile_uq: float,
    outdir: str,
    batch_size: Optional[int] = None,
    k: Optional[int] = None,
    max_tiles: Optional[int] = None,
    qc: Optional[str] = None,
    device=None,
):
    """Per-tile UQ inference over a slide, exporting tile PNGs into
    ``uq_incl/`` (uncertainty < threshold) and ``uq_excl/`` directories.

    This is the reference's Figure-5 tile loop (results.py:234-265):
    normalizer -> standardization -> K-pass MC dropout -> route by the
    tile uncertainty threshold, in batches of ``batch_size`` (64 by
    default, an artifact's own batch for an artifact) on ``device``.

    Returns (n_included, n_excluded).
    """
    from PIL import Image

    interface, tile_px, tile_um = _load_interface(model, k, device)
    wsi = WSI(slide, tile_px, tile_um, qc=qc)
    incl_dir = os.path.join(outdir, "uq_incl")
    excl_dir = os.path.join(outdir, "uq_excl")
    os.makedirs(incl_dir, exist_ok=True)
    os.makedirs(excl_dir, exist_ok=True)

    n_incl = n_excl = 0
    scorer = _GridScorer(interface, _auto_batch(batch_size, interface))
    try:
        for imgs, locs, _probs, unc in scorer.batches(wsi, max_tiles):
            for img, (i, j), u in zip(imgs, locs, unc[:, 1]):
                dest = incl_dir if u < tile_uq else excl_dir
                Image.fromarray(img).save(
                    os.path.join(dest, f"{wsi.name}-{i}-{j}-{u:.5f}.png")
                )
                if u < tile_uq:
                    n_incl += 1
                else:
                    n_excl += 1
    finally:
        wsi.close()
    log.info(
        f"Exported {n_incl} high-confidence / {n_excl} uncertain tiles "
        f"from {wsi.name}"
    )
    return n_incl, n_excl


class Heatmap:
    def __init__(
        self,
        slide: str,
        model: str,
        stride_div: int = 1,
        batch_size: Optional[int] = None,
        uq: bool = True,
        k: Optional[int] = None,
        qc: Optional[str] = None,
        device=None,
    ):
        """Compute grid predictions for one slide.

        Args:
            slide: path to the whole-slide image.
            model: path to a saved `..._epoch{E}` model dir, or a servable
                artifact (``serve.export_servable``).
            stride_div: grid stride divisor (1 = non-overlapping).
            batch_size: tiles a batch (64 by default, an artifact's own
                batch for an artifact); the last batch is padded with
                zero tiles.
            device: where the model runs (the card unless "cpu").

        ``timings`` holds the tiles, the batches, and in seconds the
        model's load (``load_s``), the slide's open with its QC mask
        (``open_s``), the host's tile reads (``read_s``) and the scoring
        of the batches, the copy back included (``score_s``).
        """
        t0 = time.perf_counter()
        self.interface, tile_px, tile_um = _load_interface(model, k, device)
        t1 = time.perf_counter()
        self.wsi = WSI(
            slide, tile_px, tile_um, stride_div=stride_div, qc=qc
        )
        t2 = time.perf_counter()
        gx, gy = self.wsi.grid_x, self.wsi.grid_y
        n_classes = 2
        self.logits = np.full((gy, gx, n_classes), -99.0, np.float32)
        self.uncertainty = np.full((gy, gx, 1), -99.0, np.float32)

        scorer = _GridScorer(self.interface,
                             _auto_batch(batch_size, self.interface))
        for _imgs, locs, probs, unc in scorer.batches(self.wsi):
            for (i, j), p, u in zip(locs, probs, unc):
                self.logits[j, i] = p
                self.uncertainty[j, i, 0] = u[1]
        self.timings = {"load_s": t1 - t0, "open_s": t2 - t1,
                        **scorer.timings}
        log.info(
            f"Heatmap computed for {self.wsi.name}: grid {gx}x{gy}"
        )

    def save(self, outdir: str, cmap="inferno", show_roi: bool = False):
        """Save prediction and uncertainty heatmap PNGs
        (hm.save contract, results.py:217-227)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(outdir, exist_ok=True)
        masked_logits = np.ma.masked_where(
            self.logits[:, :, 1] == -99.0, self.logits[:, :, 1]
        )
        masked_unc = np.ma.masked_where(
            self.uncertainty[:, :, 0] == -99.0, self.uncertainty[:, :, 0]
        )
        for arr, name, cm in (
            (masked_logits, "preds", cmap),
            (masked_unc, "uncertainty", "viridis"),
        ):
            fig, ax = plt.subplots(figsize=(10, 10))
            im = ax.imshow(arr, cmap=cm, vmin=None, vmax=None)
            fig.colorbar(im, ax=ax)
            ax.set_title(f"{self.wsi.name} {name}")
            ax.axis("off")
            fig.savefig(
                os.path.join(outdir, f"{self.wsi.name}-{name}.png"),
                bbox_inches="tight", dpi=150,
            )
            plt.close(fig)

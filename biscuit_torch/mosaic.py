"""Feature extraction, 2-D embedding maps, and tile mosaics.

The port's counterpart of ``biscuit_tpu/mosaic.py`` (the stand-in for
slideflow's generate_features / SlideMap / generate_mosaic; reference
call sites results.py:269-306): dump penultimate (pooled backbone)
activations for up to ``max_tiles`` tiles per slide, embed them in 2-D,
and render a mosaic of representative tiles. Label hooks match the
reference: ``label_by_logits``, ``label_by_uncertainty``,
``label_by_slide``.

``generate_features`` keeps the JAX package's routing: the module trunk
(no fused middle flow) and the module MC head, after the plain
preprocess chain, so it launches none of the port's kernels.

Embedding backend: umap-learn when importable, else the vendored minimal
UMAP (:mod:`biscuit_torch.stats.umap_lite`), with PCA as a loud last
resort — non-UMAP artifacts are suffixed ``_pca``. Servable artifacts
are not ported yet (ROADMAP.md Queue 1 item 6) and raise.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from .utils_log import log


class SlideMap:
    """2-D embedding of tile features with label/metadata channels."""

    def __init__(self, coords: np.ndarray, meta: List[dict],
                 tiles: Optional[np.ndarray] = None,
                 embed_method: str = "umap"):
        self.coords = coords          # (N, 2)
        self.meta = meta              # per-tile dicts: slide, loc, probs, unc
        self.tiles = tiles            # optional (N, H, W, 3) uint8
        self.labels = np.zeros(len(meta), np.float64)
        self.label_name = "none"
        self.embed_method = embed_method

    def label_by_logits(self, index: int = 1):
        self.labels = np.array([m["probs"][index] for m in self.meta])
        self.label_name = f"logit{index}"
        return self

    def label_by_uncertainty(self, index: int = 1):
        self.labels = np.array([m["uncertainty"][index] for m in self.meta])
        self.label_name = "uncertainty"
        return self

    def label_by_slide(self, slide_labels: Optional[Dict[str, int]] = None):
        if slide_labels is None:
            uniq = {m["slide"] for m in self.meta}
            slide_labels = {s: i for i, s in enumerate(sorted(uniq))}
        self.labels = np.array(
            [slide_labels.get(m["slide"], -1) for m in self.meta],
            np.float64,
        )
        self.label_name = "slide"
        return self

    def save(self, path: str, cmap="viridis", s: int = 4):
        """Scatter plot of the embedding colored by the active label.

        If the embedding is a PCA fallback (not UMAP), the filename is
        suffixed ``_pca`` so the artifact can't masquerade as Figure 6.
        Returns the actual path written.
        """
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if self.embed_method == "pca":
            root, ext = os.path.splitext(path)
            path = f"{root}_pca{ext}"
        fig, ax = plt.subplots(figsize=(8, 8))
        sc = ax.scatter(
            self.coords[:, 0], self.coords[:, 1], c=self.labels,
            cmap=cmap, s=s,
        )
        fig.colorbar(sc, ax=ax)
        ax.set_title(f"SlideMap ({self.label_name}, {self.embed_method})")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, bbox_inches="tight", dpi=150)
        plt.close(fig)
        return path


def embed_2d(features: np.ndarray, seed: int = 0):
    """2-D embedding: umap-learn -> vendored UMAP -> PCA.

    Returns (coords (N, 2), method) where method is one of 'umap',
    'umap_lite', 'pca'. Callers must surface non-UMAP methods in artifact
    names.
    """
    try:
        import umap

        return umap.UMAP(random_state=seed).fit_transform(features), "umap"
    except ImportError:
        pass
    try:
        from .stats.umap_lite import umap_embed

        log.info("umap-learn unavailable; using vendored minimal UMAP")
        return umap_embed(features, seed=seed), "umap_lite"
    except Exception as e:  # pragma: no cover — PCA last resort
        log.warning(f"UMAP embedding failed ({e}); falling back to PCA")
        x = features - features.mean(axis=0, keepdims=True)
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        return x @ vt[:2].T, "pca"


def generate_features(
    model_path,
    tfrecords: List[str],
    max_tiles: int = 100,
    cache: Optional[str] = None,
    batch_size: int = 64,
    keep_tiles: bool = False,
    k: int = 8,
    device=None,
):
    """Penultimate-activation dump + per-tile UQ predictions of a saved
    model directory, on ``device`` (the card unless ``device="cpu"``).

    Returns (features (N, F), meta list, tiles or None). Features come from
    the deterministic trunk; probs/uncertainty from the K-pass MC head,
    each batch's dropout from seed = its index.
    """
    import torch

    from .data.normalize import make_normalizer, per_image_standardization
    from .data.pipeline import TileBatcher
    from .heatmap import refuse_servable
    from .train.trainer import load_checkpoint
    from .train.uq import mc_dropout_head

    if cache and os.path.exists(cache):
        blob = np.load(cache, allow_pickle=True)
        return blob["features"], list(blob["meta"]), (
            blob["tiles"] if "tiles" in blob.files else None
        )

    refuse_servable(model_path)
    model, hp, _meta = load_checkpoint(model_path, device)
    dev = next(model.parameters()).device
    normalizer = make_normalizer(hp.normalizer)

    def step(imgs, seed):
        with torch.inference_mode():
            x = torch.from_numpy(imgs).to(dev).float()
            if normalizer is not None:
                x = normalizer(x)
            x = per_image_standardization(x)
            feats = model.features(x)
            mean, std = mc_dropout_head(model, feats, seed, k=k,
                                        use_kernel=False)
            return (feats.float().cpu().numpy(),
                    mean.float().cpu().numpy(), std.float().cpu().numpy())

    batcher = TileBatcher(
        tfrecords, {}, batch_size=batch_size, shuffle=False, infinite=False,
        max_tiles=max_tiles, tile_px=hp.tile_px,
    )
    feats_all, meta, tiles_all = [], [], []
    try:
        for b, batch in enumerate(batcher):
            feats, mean, std = step(batch["image"], seed=b)
            m = np.asarray(batch["mask"])
            feats, mean, std = feats[m], mean[m], std[m]
            feats_all.append(feats)
            for row, i in enumerate(np.where(m)[0]):
                meta.append(
                    {
                        "slide": batch["slide"][i],
                        "loc": tuple(batch["loc"][i]),
                        "probs": mean[row],
                        "uncertainty": std[row],
                    }
                )
                if keep_tiles:
                    tiles_all.append(batch["image"][i])
    finally:
        batcher.close()
    features = (
        np.concatenate(feats_all) if feats_all else np.zeros((0, 1))
    )
    tiles = np.stack(tiles_all) if tiles_all else None
    if cache:
        np.savez_compressed(
            cache, features=features, meta=np.asarray(meta, dtype=object),
            **({"tiles": tiles} if tiles is not None else {}),
        )
    return features, meta, tiles


def generate_mosaic(
    features: np.ndarray,
    meta: List[dict],
    tiles: np.ndarray,
    grid: int = 20,
    seed: int = 0,
) -> np.ndarray:
    """Mosaic image: embed features in 2-D, bucket into a grid, render the
    tile nearest each bucket center (sf mosaic contract, results.py:281)."""
    coords, _method = embed_2d(features, seed=seed)
    lo = coords.min(axis=0)
    hi = coords.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    cell = ((coords - lo) / span * (grid - 1e-6)).astype(int)

    th, tw = tiles.shape[1:3]
    canvas = np.full((grid * th, grid * tw, 3), 255, np.uint8)
    for gy in range(grid):
        for gx in range(grid):
            in_cell = np.where((cell[:, 0] == gx) & (cell[:, 1] == gy))[0]
            if not len(in_cell):
                continue
            # Representative: nearest to the cell center.
            center = lo + (np.array([gx, gy]) + 0.5) / grid * span
            d = np.linalg.norm(coords[in_cell] - center, axis=1)
            pick = in_cell[int(np.argmin(d))]
            canvas[
                gy * th:(gy + 1) * th, gx * tw:(gx + 1) * tw
            ] = tiles[pick]
    return canvas


def slide_map_from_features(features, meta, tiles=None, seed=0) -> SlideMap:
    coords, method = embed_2d(features, seed=seed)
    return SlideMap(coords, meta, tiles, embed_method=method)

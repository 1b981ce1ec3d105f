"""Minimal UMAP (McInnes, Healy & Melville 2018), NumPy-only.

The port's copy of ``biscuit_tpu/stats/umap_lite.py``: the same numpy
arithmetic in the same order, so the same features and seed give the
same embedding bit for bit. It stands in for umap-learn, where that is
not installed, for the Figure-6 embeddings (reference results.py:269-306).
The core UMAP algorithm, implemented from the published paper, not
copied from umap-learn:

1. kNN graph (brute-force Euclidean, chunked; inputs are first reduced to
   <=50 PCA dims for speed, the standard preprocessing used by e.g. scanpy),
2. fuzzy simplicial set: per-point ``rho`` (distance to nearest neighbor)
   and ``sigma`` via binary search so that
   ``sum_j exp(-(d_ij - rho)/sigma) = log2(k)``,
3. symmetrization by probabilistic t-conorm ``W + W' - W o W'``,
4. PCA initialization (umap-learn defaults to spectral; PCA init is its
   documented alternative and avoids a sparse eigensolver dependency),
5. SGD layout: per epoch each edge attracts with probability ``w / w_max``
   (equal in expectation to umap-learn's epochs_per_sample scheme), with 5
   uniform negative samples per attraction; gradients of the
   ``1 / (1 + a d^{2b})`` kernel, clipped to [-4, 4], learning rate
   annealed linearly to 0.

Deterministic for a fixed seed.
"""

from __future__ import annotations

import numpy as np

__all__ = ["umap_embed", "fit_ab"]


def fit_ab(spread: float = 1.0, min_dist: float = 0.1):
    """Least-squares fit of the (a, b) kernel parameters so that
    ``1/(1 + a x^{2b})`` approximates the target membership curve
    ``exp(-(x - min_dist)/spread)`` for x > min_dist (1.0 below)."""
    from scipy.optimize import curve_fit

    x = np.linspace(0, spread * 3, 300)
    y = np.where(x < min_dist, 1.0, np.exp(-(x - min_dist) / spread))

    def kernel(x, a, b):
        return 1.0 / (1.0 + a * x ** (2.0 * b))

    (a, b), _ = curve_fit(kernel, x, y, p0=(1.0, 1.0), maxfev=10000)
    return float(a), float(b)


def _pca(x: np.ndarray, dim: int) -> np.ndarray:
    x = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:dim].T


def _knn(x: np.ndarray, k: int, chunk: int = 512):
    """Brute-force k-nearest neighbors (excluding self): (indices, dists)."""
    n = x.shape[0]
    sq = (x * x).sum(axis=1)
    idx = np.empty((n, k), np.int64)
    dst = np.empty((n, k), np.float64)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d2 = sq[s:e, None] + sq[None, :] - 2.0 * (x[s:e] @ x.T)
        np.maximum(d2, 0.0, out=d2)
        rows = np.arange(s, e)
        d2[rows - s, rows] = np.inf  # exclude self
        part = np.argpartition(d2, k - 1, axis=1)[:, :k]
        pd = np.take_along_axis(d2, part, axis=1)
        order = np.argsort(pd, axis=1, kind="stable")
        idx[s:e] = np.take_along_axis(part, order, axis=1)
        dst[s:e] = np.sqrt(np.take_along_axis(pd, order, axis=1))
    return idx, dst


def _smooth_knn(dists: np.ndarray, k: int, n_iter: int = 64,
                bandwidth: float = 1.0):
    """Per-point (rho, sigma): rho is the nearest-neighbor distance; sigma
    solves sum_j exp(-max(0, d_j - rho)/sigma) = log2(k) by bisection."""
    target = np.log2(k) * bandwidth
    rho = dists[:, 0].copy()
    lo = np.zeros(len(dists))
    hi = np.full(len(dists), np.inf)
    sigma = np.ones(len(dists))
    adj = np.maximum(dists - rho[:, None], 0.0)
    for _ in range(n_iter):
        psum = np.exp(-adj / sigma[:, None]).sum(axis=1)
        too_big = psum > target
        hi = np.where(too_big, sigma, hi)
        lo = np.where(too_big, lo, sigma)
        sigma = np.where(
            np.isinf(hi), sigma * 2.0, (lo + hi) / 2.0
        )
    # Guard degenerate rows (all-equal distances).
    mean_d = dists.mean()
    sigma = np.maximum(sigma, 1e-3 * max(mean_d, 1e-12))
    return rho, sigma


def _fuzzy_graph(x: np.ndarray, k: int):
    """Symmetrized fuzzy simplicial set as COO edge arrays (i, j, w)."""
    idx, dst = _knn(x, k)
    rho, sigma = _smooth_knn(dst, k)
    w = np.exp(-np.maximum(dst - rho[:, None], 0.0) / sigma[:, None])
    n = x.shape[0]
    rows = np.repeat(np.arange(n), k)
    cols = idx.ravel()
    vals = w.ravel()
    # Dense-free symmetrization: accumulate into a dict-of-pairs via sorting.
    key = rows * n + cols
    tkey = cols * n + rows
    both = np.concatenate([key, tkey])
    bval = np.concatenate([vals, vals])
    order = np.argsort(both, kind="stable")
    both, bval = both[order], bval[order]
    uniq, start = np.unique(both, return_index=True)
    counts = np.diff(np.r_[start, len(both)])
    # For pairs present in both directions: w1 + w2 - w1*w2; single: w.
    first = bval[start]
    second = np.where(counts == 2, bval[np.minimum(start + 1, len(bval) - 1)], 0.0)
    merged = first + second - first * second
    i = (uniq // n).astype(np.int64)
    j = (uniq % n).astype(np.int64)
    keep = i < j  # one undirected edge per pair
    return i[keep], j[keep], merged[keep]


def umap_embed(
    features: np.ndarray,
    n_neighbors: int = 15,
    n_epochs: int | None = None,
    min_dist: float = 0.1,
    spread: float = 1.0,
    seed: int = 0,
    negative_rate: int = 5,
    init_scale: float = 10.0,
    pca_dim: int = 50,
) -> np.ndarray:
    """2-D UMAP embedding of ``features`` (N, D). Deterministic per seed."""
    x = np.asarray(features, dtype=np.float64)
    n = x.shape[0]
    if n <= 2:
        return np.zeros((n, 2))
    k = min(n_neighbors, n - 1)
    if x.shape[1] > pca_dim:
        x = _pca(x, pca_dim)
    if n_epochs is None:
        n_epochs = 500 if n < 10_000 else 200

    ei, ej, ew = _fuzzy_graph(x, k)
    ew = ew / ew.max()

    a, b = fit_ab(spread, min_dist)
    rng = np.random.RandomState(seed)

    emb = _pca(x, 2)
    scale = np.abs(emb).max() or 1.0
    emb = emb / scale * init_scale
    emb += rng.normal(0, 1e-4, emb.shape)

    for epoch in range(n_epochs):
        alpha = 1.0 - epoch / n_epochs
        mask = rng.random_sample(len(ew)) < ew
        if not mask.any():
            continue
        src, dstn = ei[mask], ej[mask]

        # Attractive along sampled edges.
        diff = emb[src] - emb[dstn]
        d2 = (diff * diff).sum(axis=1)
        grad_coef = (-2.0 * a * b * d2 ** (b - 1.0)) / (a * d2 ** b + 1.0)
        grad_coef[d2 == 0.0] = 0.0
        g = np.clip(grad_coef[:, None] * diff, -4.0, 4.0)
        np.add.at(emb, src, alpha * g)
        np.add.at(emb, dstn, -alpha * g)

        # Repulsive against uniform negative samples (move src only, like
        # the reference optimizer).
        for _ in range(negative_rate):
            neg = rng.randint(0, n, len(src))
            diff = emb[src] - emb[neg]
            d2 = (diff * diff).sum(axis=1)
            grad_coef = (2.0 * b) / ((0.001 + d2) * (a * d2 ** b + 1.0))
            g = np.clip(grad_coef[:, None] * diff, -4.0, 4.0)
            g[d2 == 0.0] = 4.0  # strong push for coincident points
            same = neg == src
            g[same] = 0.0
            np.add.at(emb, src, alpha * g)
    return emb

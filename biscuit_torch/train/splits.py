"""Deterministic site-preserving k-fold splitting with a JSON cache (the
port's copy of ``biscuit_tpu/train/splits.py``; the same folds and the
same cache file from the same inputs).

The reference trains with ``val_strategy='k-fold'`` and a splits cache
``splits_{exp}.json`` (experiment.py:808-816, 834-843); slideflow implements
site-preserved cross-validation (Howard et al. 2021): all slides from one
contributing site land in the same fold, with folds balanced on outcome
composition. We use a greedy balanced bin-packing heuristic (largest site
first, assign to the fold that minimizes squared deviation from the target
per-class counts), which is deterministic given the seed and reproduces the
distributional properties the published study relied on.

Cache format (versioned JSON):
    {"version": 1, "k": 3, "strategy": "k-fold[-preserved-site]",
     "folds": {"1": [slides...], ...}}
"""

from __future__ import annotations

import json
import os
import threading
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

# Concurrent fold trainings in one process share one splits JSON per
# label; serialize read-or-create so the file is written once, atomically.
_SPLITS_LOCK = threading.Lock()


def kfold_split(
    slides: List[str],
    labels: Dict[str, int],
    sites: Optional[Dict[str, str]] = None,
    k: int = 3,
    seed: int = 0,
    splits_path: Optional[str] = None,
) -> Dict[int, List[str]]:
    """Split slides into k folds, optionally keeping sites intact.

    Returns {fold (1-based): [slides]}. If splits_path exists and matches
    (same k and same slide set), the cached split is returned — this is the
    idempotent-resume seam (SURVEY.md §5.3).
    """
    slides = [s for s in slides if s in labels]
    with _SPLITS_LOCK:
        return _kfold_split_locked(slides, labels, sites, k, seed, splits_path)


def _kfold_split_locked(slides, labels, sites, k, seed, splits_path):
    if splits_path and os.path.exists(splits_path):
        with open(splits_path) as f:
            cached = json.load(f)
        cached_slides = sorted(sum(cached["folds"].values(), []))
        if cached.get("k") == k and cached_slides == sorted(slides):
            return {int(i): v for i, v in cached["folds"].items()}

    rng = np.random.default_rng(seed)
    n_classes = max(labels.values()) + 1 if labels else 1

    # Group slides by site (or each slide is its own group).
    groups: Dict[str, List[str]] = defaultdict(list)
    for s in slides:
        site = sites.get(s, s) if sites else s
        groups[site].append(s)

    # Degenerate site structure (fewer sites than folds) would leave folds
    # empty; fall back to slide-level splitting, as slideflow does when
    # site preservation is infeasible.
    if len(groups) < k:
        groups = {s: [s] for s in slides}

    # Per-group class composition.
    def comp(members):
        c = np.zeros(n_classes)
        for m in members:
            c[labels[m]] += 1
        return c

    group_items = [(g, members, comp(members)) for g, members in groups.items()]
    # Largest group first; ties broken deterministically by name after a
    # seeded shuffle so equal-size sites don't always land in fold order.
    order = rng.permutation(len(group_items))
    group_items = [group_items[i] for i in order]
    group_items.sort(key=lambda t: -t[2].sum())

    fold_counts = np.zeros((k, n_classes))
    folds: Dict[int, List[str]] = {i + 1: [] for i in range(k)}

    for _g, members, c in group_items:
        # Greedy balanced partitioning: place the group where the resulting
        # per-class squared loads are smallest (classic least-loaded greedy,
        # which keeps both fold sizes and class mixes balanced).
        costs = ((fold_counts + c[None, :]) ** 2).sum(axis=1)
        best = int(np.argmin(costs))
        fold_counts[best] += c
        folds[best + 1].extend(members)

    for f in folds.values():
        f.sort()

    if splits_path:
        os.makedirs(os.path.dirname(splits_path) or ".", exist_ok=True)
        tmp = f"{splits_path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "version": 1,
                    "k": k,
                    "strategy": "k-fold-preserved-site" if sites else "k-fold",
                    "folds": {str(i): v for i, v in folds.items()},
                },
                f,
                indent=2,
            )
        os.replace(tmp, splits_path)
    return folds


def train_val_slides(folds: Dict[int, List[str]], val_k: int):
    """(train_slides, val_slides) for one fold index (1-based)."""
    val = folds[val_k]
    train = [s for i, f in folds.items() if i != val_k for s in f]
    return train, val

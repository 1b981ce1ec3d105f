"""Annotation-backed dataset registry: slides, patients, labels, filters,
tfrecords (the port's copy of ``biscuit_tpu/dataset.py``; SURVEY.md §2.3
E2; stand-in for slideflow's Dataset).

Reference call surface: ``dataset().patients()`` (experiment.py:466,703,933),
``dataset.labels('cohort')`` (results.py:304), patient-level ``filters``
(experiment.py:811,916), ``slide_paths()`` (results.py:199-208). Filters are
column predicates over the annotations frame, including the
``include_{label}`` columns written by Experiment.add (experiment.py:139-145).

On-disk layout follows slideflow: one ``{slide}.tfrecords`` file per slide
under the source's tfrecords dir.
"""

from __future__ import annotations

import os
from glob import glob
from os.path import basename, join, splitext
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from .utils_log import log


class Dataset:
    def __init__(
        self,
        annotations: pd.DataFrame,
        tfrecord_dirs: Optional[List[str]] = None,
        filters: Optional[Dict] = None,
        tile_px: Optional[int] = None,
        tile_um: Optional[int] = None,
        verify: Optional[str] = "tfrecords",
    ):
        self.annotations = annotations.copy()
        self.tfrecord_dirs = tfrecord_dirs or []
        self.tile_px = tile_px
        self.tile_um = tile_um
        self._filters = filters or {}
        self._verify = verify
        if "slide" not in self.annotations.columns:
            raise ValueError("Annotations must contain a 'slide' column")

    # --- filtering -------------------------------------------------------------

    def filter(self, filters: Dict) -> "Dataset":
        """New Dataset restricted to rows matching all column predicates."""
        merged = dict(self._filters)
        merged.update(filters)
        return Dataset(
            self.annotations,
            self.tfrecord_dirs,
            merged,
            self.tile_px,
            self.tile_um,
            self._verify,
        )

    def _filtered(self) -> pd.DataFrame:
        df = self.annotations
        for col, allowed in self._filters.items():
            if not isinstance(allowed, (list, tuple, set, np.ndarray)):
                allowed = [allowed]
            if col not in df.columns:
                raise KeyError(f"Filter column {col!r} not in annotations")
            df = df[df[col].isin([str(a) for a in allowed])]
        return df

    # --- core accessors ----------------------------------------------------------

    def patients(self) -> Dict[str, str]:
        """slide -> patient mapping (experiment.py:466 contract)."""
        df = self._filtered()
        if "patient" in df.columns:
            return dict(zip(df["slide"], df["patient"]))
        return dict(zip(df["slide"], df["slide"]))

    def slides(self) -> List[str]:
        return self._filtered()["slide"].dropna().tolist()

    def labels(self, outcome: str, use_float: bool = False):
        """(slide -> int label, [unique label names]) for a categorical
        outcome; names sorted for a stable class index (LUAD=0, LUSC=1 for
        the demonstration task, matching alphabetical TF behavior)."""
        df = self._filtered()
        if outcome not in df.columns:
            raise KeyError(f"Outcome column {outcome!r} not in annotations")
        sub = df[["slide", outcome]].dropna()
        if use_float:
            return (
                {s: float(v) for s, v in zip(sub["slide"], sub[outcome])},
                [],
            )
        unique = sorted(sub[outcome].unique().tolist())
        index = {name: i for i, name in enumerate(unique)}
        return {s: index[v] for s, v in zip(sub["slide"], sub[outcome])}, unique

    def sites(self) -> Dict[str, str]:
        """slide -> site. Uses the 'site' annotation column when present,
        else derives from the TCGA patient barcode (chars 5:7), which is how
        site-preserved cross-validation identifies contributing sites."""
        df = self._filtered()
        if "site" in df.columns:
            return dict(zip(df["slide"], df["site"].fillna("?")))
        pts = self.patients()
        return {s: (p[5:7] if isinstance(p, str) and len(p) >= 7 else "?")
                for s, p in pts.items()}

    # --- tfrecords ---------------------------------------------------------------

    def tfrecords(self) -> List[str]:
        """Per-slide tfrecord paths for the filtered slide set."""
        wanted = set(self.slides())
        out = []
        for d in self.tfrecord_dirs:
            for path in sorted(glob(join(d, "*.tfrecords"))):
                if splitext(basename(path))[0] in wanted:
                    out.append(path)
        return out

    def slide_paths(self) -> List[str]:
        """Paths to whole-slide images for the filtered slides (searches
        registered slide dirs for common WSI/image extensions)."""
        wanted = set(self.slides())
        out = []
        exts = (".svs", ".tif", ".tiff", ".png", ".jpg")
        for d in self.tfrecord_dirs:
            # slides live next to tfrecords in the test/synthetic layout
            parent = os.path.dirname(d.rstrip("/"))
            for sub in (join(parent, "slides"), d):
                if not os.path.isdir(sub):
                    continue
                for f in sorted(os.listdir(sub)):
                    name, ext = splitext(f)
                    if ext.lower() in exts and name in wanted:
                        out.append(join(sub, f))
        return out

    def num_tiles(self) -> Dict[str, int]:
        """slide -> tile count (from tfrecord indices)."""
        from .data.tfrecord import count_records

        return {
            splitext(basename(p))[0]: count_records(p) for p in self.tfrecords()
        }

    # --- splits --------------------------------------------------------------------

    def kfold_split(
        self,
        k: int,
        outcome: str,
        preserved_site: bool = True,
        seed: int = 0,
        splits_path: Optional[str] = None,
    ):
        """Deterministic (site-preserving) k-fold split; cached to JSON.

        See biscuit_torch.train.splits for the algorithm; the JSON cache is
        the `splits_{exp}.json` seam from experiment.py:813,839,866.
        """
        from .train.splits import kfold_split

        labels, _ = self.labels(outcome)
        return kfold_split(
            slides=self.slides(),
            labels=labels,
            sites=self.sites() if preserved_site else None,
            k=k,
            seed=seed,
            splits_path=splits_path,
        )

    def __len__(self) -> int:
        return len(self.slides())

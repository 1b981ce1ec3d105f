"""Project container: on-disk layout compatible with the reference stack
(the port's copy of ``biscuit_tpu/project.py``; a project written by
either package opens in the other).

Stand-in for ``sf.Project`` (SURVEY.md §2.3 E1; reference call sites
experiment.py:64-78, configure.py:62-113, utils.py:257-272, 331-341).
Layout per configure.py:63-87:

    root/
      settings.json        {name, annotations, sources, models_dir, eval_dir}
      datasets.json        source name -> {slides, roi, tiles, tfrecords}
      annotations.csv      patient-level ground truth
      models/              training output (contract in SURVEY.md §2.4)
      eval/                external-evaluation output
"""

from __future__ import annotations

import json
import os
from os.path import exists, join
from typing import Dict, List, Optional

import pandas as pd

from .dataset import Dataset
from .utils_log import log


class Project:
    """A training or evaluation project rooted at a directory."""

    def __init__(
        self,
        root: str,
        annotations: Optional[str] = None,
        sources: Optional[List[str]] = None,
        name: Optional[str] = None,
        create: bool = False,
    ):
        # All paths are absolute internally; settings.json stores paths
        # under root as root-relative so projects stay relocatable.
        self.root = os.path.abspath(root)
        settings_path = join(self.root, "settings.json")
        if exists(settings_path) and not create:
            with open(settings_path) as f:
                s = json.load(f)
            self.name = s.get("name", os.path.basename(self.root))
            self._annotations = self._resolve(s.get("annotations"))
            self.sources = s.get("sources", [])
            self.models_dir = self._resolve(s.get("models_dir", "models"))
            self.eval_dir = self._resolve(s.get("eval_dir", "eval"))
        else:
            if not create and annotations is None and name is None:
                raise FileNotFoundError(
                    f"No project found at {self.root} (missing "
                    "settings.json); pass create=True to make one."
                )
            os.makedirs(self.root, exist_ok=True)
            self.name = name or os.path.basename(self.root)
            self._annotations = (
                os.path.abspath(annotations) if annotations else None
            )
            self.sources = sources or []
            self.models_dir = join(self.root, "models")
            self.eval_dir = join(self.root, "eval")
            self.save()
        os.makedirs(self.models_dir, exist_ok=True)
        os.makedirs(self.eval_dir, exist_ok=True)

    def _resolve(self, path: Optional[str]) -> Optional[str]:
        """Resolve a settings.json path: relative means root-relative."""
        if path is None:
            return None
        if os.path.isabs(path):
            return path
        return join(self.root, path)

    def _relativize(self, path: Optional[str]) -> Optional[str]:
        """Store paths under root as root-relative (relocatable projects)."""
        if path is None:
            return None
        path = os.path.abspath(path)
        if path.startswith(self.root + os.sep):
            return os.path.relpath(path, self.root)
        return path

    # --- settings -------------------------------------------------------------

    @property
    def annotations(self) -> Optional[str]:
        return self._annotations

    @annotations.setter
    def annotations(self, path: str) -> None:
        self._annotations = os.path.abspath(path)
        self.save()

    def save(self) -> None:
        with open(join(self.root, "settings.json"), "w") as f:
            json.dump(
                {
                    "name": self.name,
                    "annotations": self._relativize(self._annotations),
                    "sources": self.sources,
                    "models_dir": self._relativize(self.models_dir),
                    "eval_dir": self._relativize(self.eval_dir),
                },
                f,
                indent=2,
            )

    # --- sources ---------------------------------------------------------------

    def _datasets_path(self) -> str:
        return join(self.root, "datasets.json")

    def add_source(
        self,
        name: str,
        slides: str = "",
        roi: str = "",
        tiles: str = "",
        tfrecords: str = "",
    ) -> None:
        """Register a tile/tfrecord source (configure.py:70-83 contract)."""
        path = self._datasets_path()
        config: Dict = {}
        if exists(path):
            with open(path) as f:
                config = json.load(f)
        config[name] = {
            "slides": self._relativize(slides) if slides else "",
            "roi": self._relativize(roi) if roi else "",
            "tiles": self._relativize(tiles) if tiles else "",
            "tfrecords": self._relativize(tfrecords) if tfrecords else "",
        }
        with open(path, "w") as f:
            json.dump(config, f, indent=2)
        if name not in self.sources:
            self.sources.append(name)
            self.save()

    def source_config(self, name: str) -> Dict:
        with open(self._datasets_path()) as f:
            cfg = json.load(f)[name]
        return {
            k: (self._resolve(v) if v else "") for k, v in cfg.items()
        }

    # --- dataset ---------------------------------------------------------------

    def dataset(
        self,
        tile_px: Optional[int] = None,
        tile_um: Optional[int] = None,
        filters: Optional[Dict] = None,
        verification: Optional[str] = "tfrecords",
        sources: Optional[List[str]] = None,
    ) -> Dataset:
        """Build a Dataset over this project's annotations and sources."""
        if self._annotations is None or not exists(self._annotations):
            raise FileNotFoundError(
                f"Project annotations not found: {self._annotations}"
            )
        ann = pd.read_csv(self._annotations, dtype=str)
        tfrecord_dirs = []
        for src in sources if sources is not None else self.sources:
            try:
                cfg = self.source_config(src)
            except (FileNotFoundError, KeyError):
                log.debug(f"Source {src} not configured; skipping")
                continue
            tfr = cfg.get("tfrecords", "")
            if tfr:
                # slideflow layout: tfrecords/<tile_px>px_<tile_um>um/*.tfrecords
                if tile_px and tile_um:
                    sub = join(tfr, f"{tile_px}px_{tile_um}um")
                    tfrecord_dirs.append(sub if os.path.isdir(sub) else tfr)
                else:
                    tfrecord_dirs.append(tfr)
        return Dataset(
            annotations=ann,
            tfrecord_dirs=tfrecord_dirs,
            filters=filters,
            tile_px=tile_px,
            tile_um=tile_um,
            verify=verification,
        )

    # --- training/eval entry points (implemented in train/) --------------------

    def train(self, outcome, exp_label, **kwargs):
        """Train model(s); see biscuit_torch.train.trainer.train_project.
        Mirrors sf.Project.train (experiment.py:1042-1051 call contract)."""
        from .train.trainer import train_project

        return train_project(self, outcome, exp_label, **kwargs)

    def evaluate(self, model, outcome, **kwargs):
        """Evaluate a saved model on this project's dataset; see
        biscuit_torch.train.evaluate.evaluate_project. Mirrors
        sf.Project.evaluate (experiment.py:917-922 call contract)."""
        from .train.evaluate import evaluate_project

        return evaluate_project(self, model, outcome, **kwargs)

    def extract_tiles(self, tile_px=299, tile_um=302, **kwargs):
        """Extract tiles from WSIs into per-slide tfrecords; see
        biscuit_torch.data.slide.extract_tiles_for_project
        (configure.py:115-133 contract)."""
        from .data.slide import extract_tiles_for_project

        return extract_tiles_for_project(self, tile_px=tile_px,
                                         tile_um=tile_um, **kwargs)

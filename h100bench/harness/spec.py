"""Everything of a cell is found by name: ``workloads/<cell>.json`` names
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``) and its correctness limits; the configuration's
``arch.family`` names its trunk family (``reference/families/
<family>.py``); ``BENCHMARK.json`` at the checkout's root says which
metrics the cell reports, and each metric's reader is
``metrics/<metric>.py``. A later cell, mix, configuration, family or
metric is a file added beside these."""

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

from ..reference import families
from . import check

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _load(kind: str, name: str, base: Path) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def entry(self) -> str:
        return self.traffic["entry"]

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_of_cell


def load_cell(name: str, base: Path = BENCH_DIR, bench: dict = None) -> Cell:
    """The cell ``name`` with its files and the metrics ``bench`` (the
    manifest, read from the checkout's root when None) gives it. The
    configuration keeps ``base`` as ``bench_dir``, where its family is
    looked for first. Raises where the family has no file, or the limits
    name a number that the cell's model cannot give."""
    workload = _load("workloads", name, base)
    config = _load("configs", workload["config"], base)
    config["bench_dir"] = str(base)
    families.of(config)
    cell = Cell(name, workload, config,
                _load("traffic", workload["traffic"], base))
    missing = sorted(set(cell.limits) - check.givable(cell.entry, config))
    if missing:
        raise ValueError(f"cell {name!r}: its limits name {missing}, which "
                         f"the model of {config['name']!r} cannot give")
    bench = manifest() if bench is None else bench
    cell.end_to_end = [m for m in bench["end_to_end"]
                       if "workloads" not in m or name in m["workloads"]]
    e2e = {m["name"] for m in cell.end_to_end}
    cell.per_layer = [m for m in bench["per_layer"]
                      if _reports(m, name, e2e)]
    return cell


def reader(metric: str, base: Path = BENCH_DIR):
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    path = base / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"h100bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_counts(base: Path = BENCH_DIR):
    """The modules of ``counts/`` that count a kernel wrapper: name ->
    module (each has ``TARGET`` and ``call_bound``)."""
    out = {}
    for path in sorted((base / "counts").glob("*.py")):
        mod = importlib.import_module(f"h100bench.counts.{path.stem}")
        if hasattr(mod, "TARGET"):
            out[getattr(mod, "NAME", path.stem)] = mod
    return out

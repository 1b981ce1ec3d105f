"""Trunk families, one module each, ``families/<family>.py``, chosen by the
configuration's ``arch.family``. A family module gives:

- ``param_specs(arch) -> (specs, feature_dim)``: the trunk's (name, shape,
  role) entries under the port's ``state_dict`` names, in a fixed order,
  and the width of its pooled features;
- ``features(x_nchw, p, arch, bn, q)``: the plain f32 trunk down to the
  pooled features; ``bn(h, name)`` is the BatchNorm of the caller's mode
  (a family with no BatchNorm never calls it), ``q`` the rounding of
  ``quant.py``;
- ``ROLES`` (optional): {role: (draw, scale, shift, fan_in)} of the
  weight roles it adds to ``harness/weights.py``'s table;
- ``port_arch(model_name, port)``: the port's architecture table for
  ``hp.model``, in the configuration's ``arch`` form, for the tests that
  hold the two together. The caller hands in the program's modules
  (``port('models.resnet')``): the reference imports none.

A later family is a file added here. A cell loaded from another directory
(``spec.load_cell``'s ``base``) finds its families under that directory's
``reference/families/`` first, then here."""

import hashlib
import importlib.util
import sys
from pathlib import Path

OWN = Path(__file__).resolve().parent


def lookup(family: str, base=None):
    """The module of trunk family ``family``: ``<base>/reference/families/
    <family>.py`` where ``base`` is given and holds one, else this
    directory's. Raises FileNotFoundError naming the files looked for."""
    paths = [OWN / f"{family}.py"]
    if base is not None:
        paths.insert(0, Path(base) / "reference" / "families"
                     / f"{family}.py")
    path = next((p for p in paths if p.is_file()), None)
    if path is None:
        raise FileNotFoundError(
            f"no trunk family {family!r}: looked for "
            + " and ".join(str(p) for p in paths))
    if path.resolve().parent == OWN:
        name = f"{__name__}.{family}"
    else:
        digest = hashlib.sha256(str(path.resolve()).encode()).hexdigest()
        name = f"{__name__}._{digest[:16]}"
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return mod


def of(config: dict):
    """The family module of ``config`` (from ``spec.load_cell``'s
    ``bench_dir`` where the cell was loaded from another directory)."""
    return lookup(config["arch"]["family"], config.get("bench_dir"))

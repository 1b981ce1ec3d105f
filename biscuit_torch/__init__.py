"""PyTorch/CUDA port of biscuit_tpu for NVIDIA Hopper (H100).

The package mirrors ``biscuit_tpu``'s layout so each module has a
counterpart under the same name. It imports ``torch``, numpy, msgpack,
the standard library and, for the prediction CSVs and the thresholds,
pandas (Pillow to decode a tile that is not a PNG and to read whole
slides); the JAX package stays the reference it is tested against.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
the hand-written kernels under ``csrc/`` are built at first use
(``ops/_build.py``), and so is the native data plane under
``csrc/native/``, with g++ (``data/native_loader.py``).

The public names are ``biscuit_tpu``'s (reference
``biscuit/__init__.py``: hp, experiment, utils, errors, delong, find_cv,
get_model_results, Experiment; then Project, Heatmap, serve and the
subpackages). All but ``hp``, ``errors`` and ``delong`` load on first
access, so that importing the package imports no pandas.
"""

from . import delong, errors, hp  # noqa: F401
from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"

_LAZY = {
    "threshold": ".threshold",
    "utils": ".utils",
    "find_cv": ".utils",
    "get_model_results": ".utils",
    "experiment": ".experiment",
    "Experiment": ".experiment",
    "project": ".project",
    "Project": ".project",
    "models": ".models",
    "ops": ".ops",
    "data": ".data",
    "train": ".train",
    "parallel": ".parallel",
    "heatmap": ".heatmap",
    "Heatmap": ".heatmap",
    "serve": ".serve",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name], __name__)
        return mod if _LAZY[name] == "." + name else getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

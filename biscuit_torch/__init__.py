"""PyTorch/CUDA port of biscuit_tpu for NVIDIA Hopper (H100).

The package mirrors ``biscuit_tpu``'s layout so each module has a
counterpart under the same name. It imports ``torch``, numpy, msgpack,
the standard library and, for the prediction CSVs and the thresholds,
pandas (Pillow only to decode a tile that is not a PNG); the JAX package
stays the reference it is tested against. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the hand-written kernels under ``csrc/`` are built at
first use (``ops/_build.py``). ``Experiment`` (the 6-step protocol,
``experiment.py``) loads on first access, so that importing the package
imports no pandas.
"""

from .device import resolve_device  # noqa: F401


def __getattr__(name):
    if name == "Experiment":
        from .experiment import Experiment

        return Experiment
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""PyTorch/CUDA port of biscuit_tpu for NVIDIA Hopper (H100).

The package mirrors ``biscuit_tpu``'s layout so each module has a
counterpart under the same name. It imports ``torch``, numpy, msgpack,
the standard library and, for the prediction CSVs and the thresholds,
pandas (Pillow to decode a tile that is not a PNG and to read whole
slides); the JAX package stays the reference it is tested against.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
the hand-written kernels under ``csrc/`` are built at first use
(``ops/_build.py``), and so is the native data plane under
``csrc/native/``, with g++ (``data/native_loader.py``). ``Experiment``
(the 6-step protocol, ``experiment.py``) and ``serve`` (the single-file
servables) load on first access, so that importing the package imports
no pandas.
"""

from .device import resolve_device  # noqa: F401


def __getattr__(name):
    if name == "Experiment":
        from .experiment import Experiment

        return Experiment
    if name == "serve":
        import importlib

        return importlib.import_module(".serve", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

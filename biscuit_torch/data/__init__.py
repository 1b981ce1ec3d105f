"""The host data plane: tfrecords, tile decode and batching, the native
library, whole-slide reading; stain normalization and standardization on
torch tensors."""

from . import proto, tfrecord  # noqa: F401


def __getattr__(name):
    if name in ("normalize", "augment", "pipeline", "slide"):
        import importlib

        return importlib.import_module("." + name, __name__)
    raise AttributeError(name)

"""Weight bridge between Flax parameter trees and the port's state_dict.

The port's modules carry the Flax module names (``models/xception.py``),
so a tree path joined with dots is a ``state_dict`` key. Leaves change
name and layout:

* conv ``kernel`` HWIO -> ``weight`` OIHW (a depthwise ``(3,3,1,C)``
  becomes ``(C,1,3,3)`` by the same transpose);
* Dense ``kernel`` ``(in, out)`` -> Linear ``weight`` ``(out, in)``;
* BatchNorm ``scale``/``bias`` and batch_stats ``mean``/``var`` ->
  ``weight``/``bias``/``running_mean``/``running_var``.

``read_msgpack`` decodes ``flax.serialization.to_bytes`` output with
``msgpack`` alone, and ``write_msgpack`` encodes it: ExtType 1 holds
``(shape, dtype_name, C-order bytes)``. The model's arrays are f32 and far
below flax's chunking size, so no other extension type occurs.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _walk(tree, path=()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, path + (name,))
        else:
            yield path + (name,), np.asarray(value)


def from_flax(params, batch_stats) -> "OrderedDict[str, torch.Tensor]":
    """Nested dicts of numpy arrays (Flax ``params`` and ``batch_stats``)
    -> a ``state_dict`` for ``XceptionClassifier``."""
    sd = OrderedDict()
    for path, arr in _walk(params):
        leaf = path[-1]
        if leaf == "kernel" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and arr.ndim == 2:
            arr = arr.T
        key = ".".join(path[:-1] + (_PARAM_LEAF[leaf],))
        sd[key] = torch.from_numpy(np.array(arr, np.float32))
    for path, arr in _walk(batch_stats):
        mod = ".".join(path[:-1])
        sd[f"{mod}.{_STAT_LEAF[path[-1]]}"] = torch.from_numpy(
            np.array(arr, np.float32))
        sd.setdefault(f"{mod}.num_batches_tracked",
                      torch.tensor(0, dtype=torch.long))
    return sd


def to_flax(state_dict):
    """Inverse of :func:`from_flax`: -> (params, batch_stats) nested dicts
    of float32 numpy arrays."""
    params, stats = {}, {}

    def put(tree, key, leaf, arr):
        node = tree
        for part in key.split("."):
            node = node.setdefault(part, {})
        node[leaf] = arr

    for key, t in state_dict.items():
        mod, _, leaf = key.rpartition(".")
        arr = t.detach().cpu().float().numpy()
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            put(stats, mod, leaf[len("running_"):], arr)
        elif leaf == "bias":
            put(params, mod, "bias", arr)
        elif arr.ndim == 4:
            put(params, mod, "kernel", arr.transpose(2, 3, 1, 0).copy())
        elif arr.ndim == 2:
            put(params, mod, "kernel", arr.T.copy())
        else:
            put(params, mod, "scale", arr)
    return params, stats


def read_msgpack(path: str):
    """Decode a ``model.msgpack`` written by ``flax.serialization`` into
    nested dicts of numpy arrays, without flax."""
    import msgpack

    def ext_hook(code, data):
        if code != 1:
            raise ValueError(f"{path}: unsupported msgpack extension {code}")
        shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
        return np.frombuffer(buf, np.dtype(dtype_name.decode())).reshape(shape)

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)


def write_msgpack(path: str, tree) -> None:
    """Encode nested dicts of numpy arrays as ``flax.serialization.
    to_bytes`` does (ExtType 1 per array), so ``flax.serialization.
    from_bytes`` and :func:`read_msgpack` read the file."""
    import msgpack

    def default(obj):
        if isinstance(obj, np.ndarray):
            arr = np.ascontiguousarray(obj)
            return msgpack.ExtType(1, msgpack.packb(
                (arr.shape, arr.dtype.name, arr.tobytes("C")),
                use_bin_type=True))
        raise TypeError(f"{path}: cannot encode {type(obj).__name__}")

    with open(path, "wb") as f:
        f.write(msgpack.packb(tree, default=default, strict_types=True))

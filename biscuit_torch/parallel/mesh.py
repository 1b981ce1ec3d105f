"""The devices a task runs on, and splitting a batch over them.

Counterpart of ``biscuit_tpu/parallel/mesh.py``. The JAX package's mesh
is a ``jax.sharding.Mesh``; here a ``Mesh`` is the ordered tuple of
``torch.device``s a task runs on, along one named axis, and whether it
spans processes. ``batch_sharding`` splits the leading axis of a tensor
over the mesh's devices in order, ``replicated`` copies it to each, and
``shard_batch`` does the former to every array of a host batch.

A mesh whose devices repeat (two entries of ``cuda:0``, or of ``cpu``)
is allowed: its shards then share that device (lockstep training refuses
a repeated card, ``lockstep.py``).

A mesh that spans processes lists this process's devices only; every
process of the runtime builds one with as many devices, and the global
rank of process p's device i is ``p * n_local + i``
(``lockstep.mesh_ranks``). Each entry is one rank of a lockstep
training, or one shard of a ``ShardedServable``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Ordered devices along one axis; ``spans_processes`` marks a mesh
    whose devices are this process's share of one that spans every
    process of the runtime."""

    def __init__(self, devices: Sequence, axis: str = "data",
                 spans_processes: bool = False):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        self.spans_processes = bool(spans_processes)

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        devs = ", ".join(str(d) for d in self.devices)
        span = ", spans_processes=True" if self.spans_processes else ""
        return f"Mesh([{devs}], axis={self.axis!r}{span})"


def local_devices() -> list:
    """Every CUDA card of this process, in index order ([] without one)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def data_parallel_mesh(devices: Optional[Sequence] = None,
                       axis: str = "data") -> Mesh:
    """1-D mesh over the given devices, by default every card of this
    process; without a card the caller must name the devices (e.g.
    ``["cpu", "cpu"]``)."""
    if devices is None:
        devices = local_devices()
        if not devices:
            raise RuntimeError("no CUDA device is available; pass "
                               "devices=[...] (e.g. ['cpu']) to build a mesh")
    return Mesh(devices, axis)


class Sharding:
    """How a tensor is placed on a mesh: its leading axis split over the
    devices in order (``split``), or a copy on each."""

    def __init__(self, mesh: Mesh, split: bool):
        self.mesh = mesh
        self.split = split

    def place(self, x) -> list:
        """One tensor a device of the mesh, in the mesh's order."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        devs = self.mesh.devices
        if not self.split:
            return [x.to(d) for d in devs]
        n = len(devs)
        if x.shape[0] % n:
            raise ValueError(f"leading axis {x.shape[0]} does not split "
                             f"evenly over {n} devices")
        return [part.to(d) for part, d in zip(torch.split(x, x.shape[0] // n),
                                              devs)]


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Split the leading (batch) axis over the mesh's devices."""
    return Sharding(mesh, True)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, False)


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """A host batch's arrays (numpy or tensors) as per-device lists, the
    batch axis split over the mesh; other leaves (e.g. the slide-name
    list) pass through."""
    sharding = batch_sharding(mesh, axis)
    return {k: sharding.place(v) if isinstance(v, (np.ndarray, torch.Tensor))
            else v for k, v in batch.items()}

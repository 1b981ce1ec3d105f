"""Parallelism: the devices a task runs on (``mesh.py``), independent
trainings on disjoint device groups (``scheduler.py``), the coordination
of several processes through a key-value store (``distributed.py``), and
one model trained by a group of ranks in lockstep (``lockstep.py``).
Counterpart of ``biscuit_tpu/parallel/``."""

from .mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    data_parallel_mesh,
    local_devices,
    replicated,
    shard_batch,
)

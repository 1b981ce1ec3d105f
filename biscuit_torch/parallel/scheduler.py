"""Experiment-level parallelism: independent trainings on disjoint
device groups.

Counterpart of ``biscuit_tpu/parallel/scheduler.py``. The published
study is embarrassingly parallel above the model level (23 dataset
sizes x 3 folds x {CV, UQ, 15 nested, FULL}, about 1000 independent
trainings). A ``SubmeshScheduler`` splits this process's devices into
disjoint submeshes and runs tasks on them from one thread a submesh;
each task is told its submesh and trains on its device explicitly.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Callable, List, Optional, Sequence

from ..utils_log import log
from .mesh import Mesh, local_devices


def partition_submeshes(n_submeshes: int,
                        devices: Optional[Sequence] = None,
                        axis: str = "data") -> List[Mesh]:
    """Split the device list (default: this process's cards) into n
    disjoint 1-D meshes."""
    if devices is None:
        devices = local_devices()
    if n_submeshes > len(devices):
        raise ValueError(
            f"Cannot build {n_submeshes} submeshes from {len(devices)} devices"
        )
    per = len(devices) // n_submeshes
    return [Mesh(devices[i * per:(i + 1) * per], axis)
            for i in range(n_submeshes)]


class SubmeshScheduler:
    """Run independent tasks concurrently, one worker thread per submesh.

    Each task is ``fn(mesh) -> result``; the scheduler passes the
    submesh through, so trainings run on their assigned devices.
    Exceptions are collected, not raised mid-run.
    """

    def __init__(self, n_submeshes: Optional[int] = None,
                 devices: Optional[Sequence] = None):
        from . import distributed

        if distributed.process_count() > 1 and devices is None:
            # Each process schedules over its own cards: a submesh that
            # spanned processes would need every process to run every
            # task together.
            raise ValueError(
                "SubmeshScheduler over the global device set is "
                "unsupported under a multi-process runtime; pass "
                "devices=local_devices() to schedule within this process")
        if devices is None:
            devices = local_devices()
        if n_submeshes is None:
            n_submeshes = len(devices)
        self.meshes = partition_submeshes(n_submeshes, devices)

    def run(self, tasks: Sequence[Callable[[Mesh], object]]):
        """Execute all tasks; returns results in task order (exceptions
        are returned in place of results)."""
        results = [None] * len(tasks)
        q: "queue.Queue[int]" = queue.Queue()
        for i in range(len(tasks)):
            q.put(i)

        def worker(mesh: Mesh):
            while True:
                try:
                    i = q.get_nowait()
                except queue.Empty:
                    return
                try:
                    results[i] = tasks[i](mesh)
                except Exception as e:  # collected, not fatal
                    log.error(f"Submesh task {i} failed: {e}")
                    traceback.print_exc()
                    results[i] = e

        threads = [threading.Thread(target=worker, args=(m,), daemon=True)
                   for m in self.meshes]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results

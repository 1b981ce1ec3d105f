"""Several processes coordinated through a key-value store.

Counterpart of ``biscuit_tpu/parallel/distributed.py``, whose primitives
run on the JAX coordination service. Here they run on one
``torch.distributed.TCPStore``, hosted by process 0: ``barrier``,
``broadcast_from_main``, ``try_claim`` (the store's atomic ``add``),
``exchange_ok`` and ``exchange_values``. None of them is a process-group
collective: a barrier may wait for hours while main writes CSVs, beyond
any NCCL or gloo op timeout, so each waits on store keys with its own
``timeout_ms``. Every process must make the same sequence of calls: a
per-call counter keys each exchange uniquely within the run.

``initialize`` connects this process. Without arguments it reads
torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and
``WORLD_SIZE``, and does nothing when they are not set, so the same
code runs in one process, where every primitive is a no-op. A process
that was asked to join and cannot reach the store raises after the
timeout; it never carries on alone.

Lockstep data parallelism over a mesh that spans processes
(``lockstep.py``) builds its process groups on this store, and
``global_batch`` places a process's rows of a global batch on its
devices.
"""

from __future__ import annotations

import atexit
import os
from datetime import timedelta
from typing import Optional

from ..utils_log import log

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
_state = {"store": None, "rank": 0, "world": 1}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: float = 300.0) -> None:
    """Join this process to a multi-process runtime: ``host:port`` of the
    store (process 0 hosts it), the number of processes and this one's
    index. No-op when already joined, and, without arguments, when
    torchrun's variables are not set."""
    if _state["store"] is not None:
        return
    if coordinator_address is None and num_processes is None:
        env = os.environ
        if not all(k in env for k in _TORCHRUN_ENV):
            log.debug("distributed.initialize: no torchrun variables; "
                      "running as a single process")
            return
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    if coordinator_address is None or num_processes is None or (
            process_id is None):
        raise ValueError("initialize needs coordinator_address, "
                         "num_processes and process_id together")
    num_processes, process_id = int(num_processes), int(process_id)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    if num_processes == 1:
        return
    from torch.distributed import TCPStore

    host, port = coordinator_address.rsplit(":", 1)
    store = TCPStore(host, int(port), world_size=num_processes,
                     is_master=process_id == 0,
                     timeout=timedelta(seconds=timeout_s),
                     wait_for_workers=True)
    _state.update(store=store, rank=process_id, world=num_processes)
    atexit.register(shutdown)


def shutdown(timeout_s: float = 30.0) -> None:
    """Leave the runtime. Process 0 hosts the store, so it waits (up to
    ``timeout_s``) until every other process has left before its store
    goes away with it."""
    store = _state["store"]
    if store is None:
        return
    try:
        if _state["rank"] == 0:
            store.wait(["biscuit_exit_all"], timedelta(seconds=timeout_s))
        elif store.add("biscuit_exit", 1) == _state["world"] - 1:
            store.set("biscuit_exit_all", "1")
    except Exception as e:  # a peer that died leaves nothing to wait for
        log.warning(f"distributed.shutdown: {e}")
    _state.update(store=None, rank=0, world=1)


def store():
    """The runtime's store (None in a single process)."""
    return _state["store"]


def process_index() -> int:
    return _state["rank"]


def process_count() -> int:
    return _state["world"]


def process_shard() -> tuple[int, int]:
    """(shard index, num shards) for the host data pipeline."""
    return process_index(), process_count()


def is_main() -> bool:
    """True on the process that owns shared-filesystem artifact writes
    (model dirs, CSVs, checkpoints). Trivially true single-process."""
    return process_index() == 0


def mesh_spans_processes(mesh) -> bool:
    """True when the mesh places devices on more than one process, the
    condition for lockstep training. A process-local mesh under a
    multi-process runtime is a single-process program."""
    return bool(getattr(mesh, "spans_processes", False))


def _wait(keys, timeout_ms: int) -> None:
    _state["store"].wait(list(keys), timedelta(milliseconds=timeout_ms))


def _get(key: str, timeout_ms: int) -> str:
    _wait([key], timeout_ms)
    return _state["store"].get(key).decode()


_BARRIER_SEQ = [0]


def barrier(name: str, timeout_ms: int = 600_000) -> None:
    """Block until every process reaches this point (no-op
    single-process). Each call gets a unique key; the last process to
    arrive releases the others."""
    if process_count() == 1:
        return
    _BARRIER_SEQ[0] += 1
    key = f"biscuit_{name}_{_BARRIER_SEQ[0]}"
    store = _state["store"]
    if store.add(f"{key}_arrived", 1) == process_count():
        store.set(f"{key}_done", "1")
    _wait([f"{key}_done"], timeout_ms)


_KV_SEQ = [0]


def broadcast_from_main(name: str, value: Optional[str],
                        timeout_ms: int = 600_000) -> str:
    """Main publishes a string; every other process blocks until it
    arrives. Single-process: returns value unchanged."""
    if process_count() == 1:
        return value
    _KV_SEQ[0] += 1
    key = f"biscuit_kv_{name}_{_KV_SEQ[0]}"
    if is_main():
        _state["store"].set(key, value)
        return value
    return _get(key, timeout_ms)


def try_claim(name: str) -> bool:
    """Atomically claim a work token across the processes: True on the
    single process whose claim landed first (trivially true
    single-process). The store's ``add`` is a fetch-and-increment, so no
    two processes can both win a token. Re-claiming a name within one
    store's lifetime always loses, so callers namespace names with a
    per-run nonce (see ``Experiment.run``)."""
    if process_count() == 1:
        return True
    return _state["store"].add(f"biscuit_claim_{name}", 1) == 1


def exchange_ok(name: str, ok: bool, timeout_ms: int = 600_000) -> bool:
    """Every process reports ``ok``, blocks until all have, and receives
    the conjunction, so that one process's failure aborts every process.
    Single-process: returns ok unchanged."""
    if process_count() == 1:
        return ok
    return all(v == "1" for v in _exchange("ok", name, "1" if ok else "0",
                                           timeout_ms))


def exchange_values(name: str, value: str,
                    timeout_ms: int = 600_000) -> list:
    """Every process posts ``value`` (str), blocks until all have, and
    receives the list in process order. Single-process: ``[value]``."""
    if process_count() == 1:
        return [value]
    return _exchange("val", name, str(value), timeout_ms)


def _exchange(kind: str, name: str, value: str, timeout_ms: int) -> list:
    _KV_SEQ[0] += 1
    base = f"biscuit_{kind}_{name}_{_KV_SEQ[0]}"
    _state["store"].set(f"{base}_{process_index()}", value)
    barrier(f"{kind}_{name}", timeout_ms)
    return [_get(f"{base}_{p}", timeout_ms) for p in range(process_count())]


def global_batch(local_batch: dict, mesh, axis: str = "data") -> dict:
    """This process's rows of a global batch, placed on its mesh devices:
    the counterpart of the JAX package's
    ``make_array_from_process_local_data``. The array leaves (numpy or
    tensors) split over the mesh's devices in order, as lists (the global
    rank of this process's device i is ``process_index() * mesh.size +
    i``); other leaves pass through. Over a mesh that spans processes,
    every process must pass as many rows, which is checked across them."""
    from .mesh import shard_batch

    rows = {int(v.shape[0]) for v in local_batch.values()
            if hasattr(v, "shape")}
    if len(rows) > 1:
        raise ValueError(f"the batch's arrays have different leading sizes "
                         f"{sorted(rows)}")
    n = rows.pop() if rows else 0
    if mesh_spans_processes(mesh):
        from .lockstep import mesh_ranks

        mesh_ranks(mesh)     # raises without a multi-process runtime
        counts = exchange_values("global_batch_rows", str(n))
        if len(set(counts)) != 1:
            raise ValueError(f"every process must feed as many rows to a "
                             f"global batch; they feed {counts}")
    return shard_batch(local_batch, mesh, axis)

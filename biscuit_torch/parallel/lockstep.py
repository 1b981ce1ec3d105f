"""Lockstep data parallelism: one model trained by a group of ranks.

Counterpart of what ``jit`` over a batch-sharded mesh gives the JAX
package (``biscuit_tpu/train/trainer.py`` ``_train_single`` over a mesh
of several devices, or one that spans processes). Each rank holds a
replica of the model and its optimizer, steps on its own rows of the
group's batch, and takes part in three kinds of collective:

* the train-mode BatchNorm statistics, forward and backward, over the
  group's batch (``ops/bn_train.bn_train``,
  ``ops/fused_unit_bwd.sep_bn_unit``), as the JAX package's BatchNorm
  takes them under ``jit`` with the batch sharded;
* the step's loss and accuracy over the group's mask;
* the gradients, summed in one flattened bucket (``all_reduce_grads``),
  so that every rank's optimizer makes the same update bit for bit.

So N ranks on a global batch compute what one rank computes on it.

**Ranks.** A ``parallel.mesh.Mesh`` lists this process's devices; each
entry is one rank. Under a multi-process runtime a mesh with
``spans_processes=True`` joins every process's mesh into one group: the
rank of this process's device i is ``p * n_local + i``, and every process
must list the same number of devices. ``run_ranks`` runs one thread a
local rank, each with its own ``Group``; the first one on the calling
thread. A mesh that repeats a card inside one process is refused: the
autograd engine runs one thread a card, so one rank's backward, waiting in
a collective for the other's, would hold that thread from it.

**Backend.** Each rank's ``Group`` holds its own ``torch.distributed``
process group, built on the runtime's ``TCPStore`` (``distributed.py``;
an in-process ``HashStore`` for a mesh of one process) under a
``PrefixStore`` of its own. The rule: **gloo** when a rank is on the CPU
or two ranks share a card (NCCL refuses two ranks on one device), and
then the tensors go through the host; **NCCL** when every rank has a card
of its own. There is no fallback: an unavailable backend, or a rank that
cannot join within the timeout, raises.

**Long waits stay on the store.** Only the step's tensors go through the
process group, whose op timeout (``TIMEOUT_S``) is short next to main's
epoch-end predictions and checkpoint writes; the ranks wait for those at
``Group.barrier``, on store keys with their own timeout, as the JAX
package waits at its coordination service. A rank of ``run_ranks`` that
raises publishes an abort key, and every store wait of the group raises
``GroupAborted`` when it sees it, so that the others do not sit at a
barrier that the failed rank will never reach.

``Group.collectives`` and ``Group.bytes`` count the collectives a rank
takes part in and the bytes it contributes to them; ``Group.seconds``
is the host time spent in them, waits for the card to finish what they
read included, and ``Group.bucket_seconds`` its share in the gradient
bucket.
"""

from __future__ import annotations

import socket
import threading
import time
import uuid
from datetime import timedelta
from typing import Callable, List, Optional

import torch

from . import distributed
from .mesh import Mesh

PREFIX = "biscuit_lockstep"
TIMEOUT_S = 600.0                  # a collective's, and joining the group
STORE_WAIT_MS = 24 * 3600 * 1000   # barriers that outlast main's writes
ABORT = "abort"                    # the group's key, set by a failed rank


class GroupAborted(RuntimeError):
    """Another rank of the group raised; the message says which and what."""


def device_key(device) -> str:
    """What identifies a rank's device across processes: 'cpu', or the
    host and the card (its UUID where PyTorch reports one)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    ident = getattr(props, "uuid", None)
    return f"cuda|{socket.gethostname()}|{ident or index}"


def choose_backend(keys: List[str]) -> str:
    """gloo when a rank is off the card or two ranks share a card, NCCL
    when every rank has a card of its own."""
    if all(k.startswith("cuda|") for k in keys) and (
            len(set(keys)) == len(keys)):
        return "nccl"
    return "gloo"


class Group:
    """One rank's handle on a group: its rank and size, its device, and
    the backend chosen by the rule of the module docstring. Built by every
    rank at once (``run_ranks`` does it); each exchanges its device over
    the store, so construction waits for the others. ``connect`` makes
    the process group, before the first collective."""

    def __init__(self, store, prefix: str, rank: int, size: int, device):
        from torch import distributed as td

        if not td.is_available():
            raise RuntimeError("this PyTorch has no torch.distributed")
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside [0, {size})")
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.store = td.PrefixStore(prefix, store)
        self.collectives = 0
        self.bytes = 0
        self.seconds = 0.0
        self.bucket_seconds = 0.0
        self._seq = 0
        self._pg = None
        self.store.set(f"dev/{self.rank}", device_key(self.device))
        keys = [self._get(f"dev/{r}", STORE_WAIT_MS) for r in range(size)]
        self.backend = choose_backend(keys)
        available = (td.is_nccl_available() if self.backend == "nccl"
                     else td.is_gloo_available())
        if not available:
            raise RuntimeError(f"the {self.backend} backend is not "
                               f"available in this PyTorch")

    def __repr__(self):
        return (f"Group(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend!r})")

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    # ------------------------------------------------- store primitives
    def _wait(self, key: str, timeout_ms: int) -> None:
        """Wait for ``key``; raise ``GroupAborted`` as soon as a rank has
        aborted the group, ``TimeoutError`` after ``timeout_ms``."""
        deadline = time.monotonic() + timeout_ms / 1000
        pause = 0.001
        while not self.store.check([key]):
            if self.store.check([ABORT]):
                raise GroupAborted(self.store.get(ABORT).decode())
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank {self.rank}: no {key!r} within "
                                   f"{timeout_ms / 1000:g} s")
            time.sleep(pause)
            pause = min(2 * pause, 0.1)

    def _get(self, key: str, timeout_ms: int) -> str:
        self._wait(key, timeout_ms)
        return self.store.get(key).decode()

    def barrier(self, name: str, timeout_ms: int = STORE_WAIT_MS) -> None:
        """Block until every rank reaches this point, on store keys (the
        long waits: main's predictions and writes)."""
        self._seq += 1
        key = f"b/{name}/{self._seq}"
        if self.store.add(f"{key}/n", 1) == self.size:
            self.store.set(f"{key}/done", "1")
        self._wait(f"{key}/done", timeout_ms)

    def broadcast_from_main(self, name: str, value: Optional[str],
                            timeout_ms: int = STORE_WAIT_MS) -> str:
        """Rank 0's string, on every rank."""
        self._seq += 1
        key = f"kv/{name}/{self._seq}"
        if self.is_main:
            self.store.set(key, value)
            return value
        return self._get(key, timeout_ms)

    # ----------------------------------------------------- collectives
    def connect(self) -> None:
        """Build this rank's process group (idempotent). Every rank must
        call it at about the same time: the ranks connect to each other
        within the timeout, so align them first (``barrier``)."""
        if self._pg is not None:
            return
        from torch import distributed as td

        store = td.PrefixStore("pg", self.store)
        timeout = timedelta(seconds=TIMEOUT_S)
        if self.backend == "gloo":
            self._pg = td.ProcessGroupGloo(store, self.rank, self.size,
                                           timeout)
        else:
            opts = td.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            self._pg = td.ProcessGroupNCCL(store, self.rank, self.size, opts)

    def all_reduce_sum(self, tensors: List[torch.Tensor]) -> list:
        """The group's elementwise sums of a list of tensors, in one
        collective over one flattened f32 buffer; new tensors, each of its
        input's shape and dtype, on its input's device. Every rank
        receives the same bits."""
        self.connect()
        t0 = time.perf_counter()
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        self.collectives += 1
        self.bytes += flat.numel() * 4
        if self.backend == "gloo":
            buf = flat.cpu() if flat.is_cuda else flat
            self._pg.allreduce([buf]).wait()
            flat = buf.to(flat.device)
        else:
            self._pg.allreduce([flat]).wait()
        self.seconds += time.perf_counter() - t0
        out, i = [], 0
        for t in tensors:
            n = t.numel()
            out.append(flat[i:i + n].reshape(t.shape).to(t.dtype))
            i += n
        return out

    def all_reduce_grads(self, params) -> None:
        """Sum the ``.grad`` of ``params`` over the group, in place, in one
        flattened bucket. Every rank must hold gradients for the same
        parameters."""
        grads = [p.grad for p in params if p.grad is not None]
        if grads:
            t0 = time.perf_counter()
            for g, s in zip(grads, self.all_reduce_sum(grads)):
                g.copy_(s)
            self.bucket_seconds += time.perf_counter() - t0

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (same shape on each), in rank order, on t's
        device; gathered on the host under gloo."""
        self.connect()
        self.collectives += 1
        self.bytes += t.numel() * t.element_size()
        src = t.detach().contiguous()
        if self.backend == "gloo" and src.is_cuda:
            src = src.cpu()
        out = [torch.empty_like(src) for _ in range(self.size)]
        self._pg.allgather([out], [src]).wait()
        return [o.to(t.device) for o in out]


def mesh_ranks(mesh: Mesh):
    """(first global rank of this process's devices, group size) of a
    mesh, by the rule of the module docstring."""
    n_local = mesh.size
    if not distributed.mesh_spans_processes(mesh):
        return 0, n_local
    if distributed.process_count() < 2:
        raise ValueError(f"{mesh} spans processes, but this process joined "
                         "no multi-process runtime (distributed.initialize)")
    return distributed.process_index() * n_local, (
        n_local * distributed.process_count())


def _check_mesh(mesh: Mesh) -> None:
    cards = [d for d in mesh.devices if d.type == "cuda"]
    if len(set(cards)) != len(cards):
        raise ValueError(
            f"{mesh} repeats a card inside one process: the autograd engine "
            f"runs one thread a card, so the ranks' backwards would wait on "
            f"each other in it; run one process a rank on a shared card")
    if distributed.mesh_spans_processes(mesh):
        mesh_ranks(mesh)
        sizes = distributed.exchange_values("lockstep_local_ranks",
                                            str(mesh.size))
        if len(set(sizes)) != 1:
            raise ValueError(f"every process of a spanning mesh must list "
                             f"as many devices; they list {sizes}")


def run_ranks(mesh: Mesh, fn: Callable[[Group], object], name: str = "run"):
    """Run ``fn(group)`` for each of this process's ranks of ``mesh``, one
    thread a rank (the first on the calling thread), on a fresh group;
    returns the first rank's result. A rank that raises aborts the group
    (the module docstring); the call then raises the first error that was
    not an abort. Every process of a spanning mesh calls it at the same
    point."""
    from torch import distributed as td

    _check_mesh(mesh)
    base, size = mesh_ranks(mesh)
    if distributed.mesh_spans_processes(mesh):
        store = distributed.store()
        nonce = distributed.broadcast_from_main(
            f"lockstep_{name}", uuid.uuid4().hex[:12]
            if distributed.is_main() else None)
    else:
        store, nonce = td.HashStore(), uuid.uuid4().hex[:12]
    prefix = f"{PREFIX}/{name}/{nonce}"
    shared = td.PrefixStore(prefix, store)
    results = [None] * mesh.size
    errors: List[Optional[BaseException]] = [None] * mesh.size

    def rank(i: int) -> None:
        try:
            group = Group(store, prefix, base + i, size, mesh.devices[i])
            if mesh.devices[i].type == "cuda":
                torch.cuda.set_device(mesh.devices[i])
            results[i] = fn(group)
        except BaseException as e:  # re-raised on the calling thread
            errors[i] = e
            if not isinstance(e, GroupAborted):
                shared.set(ABORT, f"rank {base + i} raised "
                                  f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=rank, args=(i,), daemon=True,
                                name=f"lockstep-rank{base + i}")
               for i in range(1, mesh.size)]
    for t in threads:
        t.start()
    rank(0)
    for t in threads:
        t.join()
    raised = [e for e in errors if e is not None]
    for e in sorted(raised, key=lambda e: isinstance(e, GroupAborted)):
        raise e
    return results[0]


_PROCESS_GROUPS: dict = {}


def process_group() -> Group:
    """A gloo group of this runtime's processes (rank = process index), on
    the host: for what a process-spanning ``ShardedServable`` gathers.
    Every process builds it at the same point; it is kept for the
    runtime's life."""
    key = id(distributed.store())
    if key not in _PROCESS_GROUPS:
        nonce = distributed.broadcast_from_main(
            "lockstep_processes",
            uuid.uuid4().hex[:12] if distributed.is_main() else None)
        group = Group(distributed.store(), f"{PREFIX}/processes/{nonce}",
                      distributed.process_index(),
                      distributed.process_count(), "cpu")
        group.connect()
        _PROCESS_GROUPS[key] = group
    return _PROCESS_GROUPS[key]

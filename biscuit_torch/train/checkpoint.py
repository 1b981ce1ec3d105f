"""In-run checkpointing and resume of one training run.

Counterpart of ``biscuit_tpu/train/checkpoint.py`` (single process), with
Orbax replaced by ``torch.save``. Layout: ``{model_dir}/ckpt/{step}/``
holding ``state.pt``; the latest 2 are kept. Each is written under a
temporary name in the same directory and renamed into place
(``os.replace``), so a run killed mid-save leaves the previous checkpoint
whole. The trainer calls ``maybe_restore`` once at start and ``save``
after every step (it saves on the ``every`` cadence, or when forced on
preemption); the final model save remains the msgpack epoch directory of
the model-dir contract.

A checkpoint holds the model's ``state_dict`` (parameters and BatchNorm
running statistics), the ``ScheduledOptimizer``'s optimizer state and
update count, and the state of the generator of the step's random draws.
The JAX package keeps its random stream aligned on resume by splitting
its key once for every skipped step; the port restores the generator's
state instead, so the resumed steps draw what the uninterrupted run
would have drawn after the same step. Both restart the tile stream from
its seed (the resumed steps see another shuffle than the original run).

In lockstep training (``parallel/lockstep.py``) the state is the same on
every rank, so main (``is_main``) alone saves it; on resume main names the
step to restore, and every rank reads those files read-only, as the JAX
package's ranks do.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional, Tuple

import torch

from ..utils_log import log

KEEP = 2


class RunCheckpointer:
    """Periodic checkpointing for one training run.

    Args:
        model_dir: the run's model directory; checkpoints go under
            ``{model_dir}/ckpt``.
        every: checkpoint every N steps (None or 0 disables).
        is_main: whether this rank saves; another rank of a lockstep
            training only restores the step it is given.
    """

    def __init__(self, model_dir: str, every: Optional[int] = None,
                 is_main: bool = True):
        self.every = every
        self.is_main = is_main
        self.dir = os.path.join(os.path.abspath(model_dir), "ckpt")
        if every and is_main:
            os.makedirs(self.dir, exist_ok=True)

    def steps(self) -> list:
        """The checkpointed steps, oldest first."""
        if not self.every or not os.path.isdir(self.dir):
            return []
        return sorted(int(d) for d in os.listdir(self.dir) if d.isdigit())

    def latest(self) -> Optional[int]:
        """Latest checkpointed step, or None."""
        steps = self.steps()
        return steps[-1] if steps else None

    def maybe_restore(self, model, tx, generator, step: Optional[int] = None
                      ) -> Tuple[Any, Any, Any, int]:
        """Restore the latest checkpoint (or ``step``) into ``model``,
        ``tx`` and ``generator`` in place, if there is one; returns them
        and the restored step, 0 when nothing was restored. A rank that is
        not main restores ``step`` only, never the latest it finds."""
        if not self.every:
            return model, tx, generator, 0
        if step is None and self.is_main:
            step = self.latest()
        if step is None:
            return model, tx, generator, 0
        state = torch.load(os.path.join(self.dir, str(step), "state.pt"),
                           map_location="cpu", weights_only=True)
        model.load_state_dict(state["model"])
        tx.opt.load_state_dict(state["optimizer"])
        tx.count = int(state["count"])
        generator.set_state(state["generator"])
        log.info(f"Resumed training from checkpoint step {step}")
        return model, tx, generator, int(step)

    def save(self, step: int, model, tx, generator,
             force: bool = False) -> None:
        """Save at the checkpoint cadence; ``force=True`` saves regardless
        of cadence (preemption path). Forcing a step that is already
        saved is a no-op, and so is a save by a rank that is not main."""
        if not self.every or not self.is_main:
            return
        if not force and step % self.every:
            return
        if force and (step % self.every == 0 or step in self.steps()):
            return  # the cadence save already covers this step
        state = {"model": model.state_dict(),
                 "optimizer": tx.opt.state_dict(),
                 "count": tx.count,
                 "generator": generator.get_state()}
        tmp = os.path.join(self.dir, f".{step}.tmp.{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, "state.pt"))
        final = os.path.join(self.dir, str(step))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-KEEP]:
            shutil.rmtree(os.path.join(self.dir, str(old)))

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight when ``save``
        returns (kept for the JAX checkpointer's interface)."""

    def close(self) -> None:
        """Nothing to release (kept for the JAX checkpointer's interface)."""

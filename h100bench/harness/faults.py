"""Faults planted in the program under a run, to show that ``correct``
comes out false for each fault a cell can have (the benchmark's tests on
the CPU; ``control.py --fault-seeds`` reads them on the card). Never
active in a benchmark run.

Serving: ``half_batch`` answers the second half of each request with the
first half's answers; ``altered`` moves 0.1 of one tile's mean from one
class to another where the answer is produced; ``stale`` answers each
request with the previous request's answers (the state left unchanged).
Training: ``unchanged`` makes the optimizer's update a no-op;
``half_batch`` leaves the second half of each batch out of the loss (the
mean over the rest); ``altered`` moves one leaf twice as far as the
optimizer's update (an answer altered where it is produced);
``frozen_stats`` leaves every BatchNorm running statistic as it was
before each step (that state left unchanged; a model with no BatchNorm
cannot have it); ``scaled`` doubles the gradient of the leaves of one
group (``prefixes``: the group's entry in the configuration's
``leaf_groups``) before the optimizer reads it."""

from contextlib import contextmanager

import torch

from ..reference.params import param_specs, running_statistics

FAULTS = {"serve": ("half_batch", "altered", "stale"),
          "train": ("unchanged", "half_batch", "altered", "frozen_stats",
                    "scaled")}
_STATS = ("running_mean", "running_var")


def applicable(entry: str, config: dict) -> tuple:
    """The faults a cell of ``entry`` over ``config``'s model can have:
    ``frozen_stats`` only where the model keeps running statistics."""
    if running_statistics(param_specs(config)):
        return FAULTS[entry]
    return tuple(f for f in FAULTS[entry] if f != "frozen_stats")


@contextmanager
def planted(entry: str, fault: str, prefixes=()):
    if fault not in FAULTS[entry]:
        raise ValueError(f"no {entry} fault {fault!r}")
    if (fault == "scaled") != bool(prefixes):
        raise ValueError("the scaled fault, and it alone, takes prefixes")
    from biscuit_torch.train import trainer, uq

    if entry == "serve":
        target, attr = uq.UncertaintyInterface, "__call__"
        orig = uq.UncertaintyInterface.__call__
        last = []

        def patched(self, tiles, seed=None):
            mean, std = orig(self, tiles, seed)
            if fault == "half_batch":
                h = (mean.shape[0] + 1) // 2
                mean = torch.cat([mean[:h], mean[:mean.shape[0] - h]])
                std = torch.cat([std[:h], std[:std.shape[0] - h]])
            elif fault == "altered":
                mean = mean.clone()
                shift = torch.minimum(mean[0, 0], torch.tensor(
                    0.1, device=mean.device))
                mean[0, 0] -= shift
                mean[0, 1] += shift
            else:
                last.append((mean, std))
                mean, std = last[-2] if len(last) > 1 else (mean, std)
            return mean, std
    elif fault in ("half_batch", "frozen_stats", "scaled"):
        target, attr = trainer, "make_train_step"
        orig = trainer.make_train_step

        def patched(model, tx, *args, **kwargs):
            step = orig(model, tx, *args, **kwargs)
            if fault == "scaled":
                group = [p for n, p in model.named_parameters()
                         if n.startswith(tuple(prefixes))]
                update = tx.opt.step

                def scaled(*a, **k):
                    with torch.no_grad():
                        for p in group:
                            p.grad.mul_(2.0)
                    return update(*a, **k)
                tx.opt.step = scaled
                return step
            if fault == "frozen_stats":
                stats = [b for n, b in model.named_buffers()
                         if n.endswith(_STATS)]

                def frozen(*a, **k):
                    kept = [b.clone() for b in stats]
                    out = step(*a, **k)
                    with torch.no_grad():
                        for b, v in zip(stats, kept):
                            b.copy_(v)
                    return out
                return frozen

            def half(images, labels, mask, generator=None, stop=False):
                mask = torch.as_tensor(mask).clone()
                mask[(mask.shape[0] + 1) // 2:] = 0
                return step(images, labels, mask, generator, stop)
            return half
    else:
        target, attr = trainer, "make_optimizer"
        orig = trainer.make_optimizer

        def patched(*args, **kwargs):
            tx = orig(*args, **kwargs)
            step = tx.opt.step
            first = tx.opt.param_groups[0]["params"][0]

            def update(*a, **k):
                if fault == "unchanged":
                    return None
                before = first.detach().clone()
                out = step(*a, **k)
                with torch.no_grad():
                    first.add_(first - before)
                return out
            tx.opt.step = update
            return tx
    setattr(target, attr, patched)
    try:
        yield
    finally:
        setattr(target, attr, orig)

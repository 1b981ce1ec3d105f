"""The port's spans and counters, for an operator reading a profile.

``span(name)`` marks a stage of the port's work. While ``torch.profiler``
records on the calling thread it is ``record_function("biscuit." +
name)``: a host event on the profiler's own clock, so every device
operation can be put down to the span it was launched in (autograd's
backward thread launches inside ``train.backward`` of the main thread).
Otherwise (no profiler, a thread it was not started on, or a compiler or
``torch.export`` tracing the code) it is one shared null context, and a
span costs a check. No setting turns spans on: the profiler is the
switch (``BISCUIT_PROFILE=1`` for a training fold, ``h100bench``'s
``--trace 1``). The spans, nested as listed:

- serving, one call of ``UncertaintyInterface``: ``serve.copy`` (the
  tiles to the model's device), ``serve.preprocess``, ``serve.trunk``
  (on the fused trunk ``trunk.entry``, ``trunk.middle``, ``trunk.exit``;
  with ``fuse_blocks`` entry is the stem and the strided blocks before
  the middle flow, exit the last block and the tail; on a ViT trunk,
  ``models/vit.py``, ``vit.embed`` (patch embedding, tokens, position),
  then per block ``vit.attention`` and ``vit.mlp``, each from its
  LayerNorm to its residual add, and ``vit.norm`` (the final LayerNorm
  and the class token)), ``serve.head``;
- training, one ``make_train_step`` step: ``train.copy``,
  ``train.augment`` (JPEG, preprocess, augment), ``train.forward``
  (trunk, head, loss), ``train.backward`` (with the lockstep
  reductions), ``train.optimizer`` (twice: ``zero_grad``, then the step
  and the BatchNorm statistics);
- ``batcher.wait``: the consumer's wait for the next prefetched batch.

``count(name, n)`` adds to a process-wide integer counter, read by
``counts()`` and zeroed by ``reset_counts(prefix)``, from any thread. The
counters: ``launch.<kernel>``, each hand-written kernel's launches
(``ops/_build.launch_counts``); ``vit.attention.<backend>``, the ViT's
attention calls by the SDPA backend that ran them (``cudnn_attention``,
``efficient_attention`` for f32 on the card, ``math`` on the CPU), so that
a fallback shows (``models/vit.attention_counts``, zeroed by
``reset_attention_counts``).
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter

import torch

PREFIX = "biscuit."
_OFF = contextlib.nullcontext()
_counts: Counter = Counter()
_lock = threading.Lock()


def span(name: str):
    """The context of the span ``name`` (see the module's docstring)."""
    if torch.autograd._profiler_enabled() and \
            not torch.compiler.is_compiling():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] += n


def counts() -> dict:
    with _lock:
        return dict(_counts)


def reset_counts(prefix: str = "") -> None:
    """Zero the counters whose names start with ``prefix``: all of them by
    default."""
    with _lock:
        for name in [n for n in _counts if n.startswith(prefix)]:
            del _counts[name]


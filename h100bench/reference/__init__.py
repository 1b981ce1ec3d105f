"""The plain reference: the same models and the same serving and training
steps in plain PyTorch and f32 (TF32 off), written from the published
descriptions and the configuration file alone. It imports nothing of the
program (``biscuit_torch``), of the JAX package or of JAX, and takes none
of the program's derived weights: it reads the weights the benchmark made
from the seed and the inputs the benchmark generated.

``quant='fp8'`` computes it one precision below the configuration's bf16
instead (every conv and matmul input rounded to float8 e4m3 at a
per-tensor scale, and in training every gradient entering one rounded to
e5m2): the control that the correctness limits are shown to fail."""

from contextlib import contextmanager

import torch


@contextmanager
def exact():
    """Full f32 products (TF32 off for matmuls and cuDNN) inside the
    block, the caller's settings restored after it."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev

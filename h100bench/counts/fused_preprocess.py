"""Kernel row 1, ``biscuit_torch/ops/fused_preprocess.py``, reached through
its registered op ``biscuit::fused_preprocess(x, coef)``: uint8 NHWC tiles
in, bf16 or f32 out of the same shape. Each input byte read once, each
output byte written once; 60 f32 operations a pixel (the reinhard_fast
colour transfer and the standardization), as ``chip_smoke.py``
``kernel_preprocess``."""

from .peaks import bound_s

TARGET = ("biscuit_torch.ops.library", "fused_preprocess")
F32_OPS_PER_PIXEL = 60.0


def bound(n: int, h: int, w: int, out_bytes: int = 2):
    px = n * h * w
    return bound_s(px * 3 * (1 + out_bytes), {"f32": F32_OPS_PER_PIXEL * px})


def call_bound(args, kwargs):
    n, h, w, _ = args[0].shape
    return bound(n, h, w)

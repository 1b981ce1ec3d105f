"""Kernel row 2, ``biscuit_torch/ops/fused_sepconv.py``, reached through
``biscuit::fused_middle_flow(x, dw, pw, sc, sh)``: U separable units at
constant width C over an NHWC activation. Bytes: x read once and the
output written once (2 bytes an element in bf16), each unit's f32 taps,
bf16 pointwise weights and f32 folded BN. Operations: the pointwise
GEMMs in bf16 (2 M C^2 a unit) and the depthwise in f32 (18 M C a unit).
The arithmetic of ``chip_smoke.py`` ``kernel_middle``."""

from .peaks import bound_s

TARGET = ("biscuit_torch.ops.library", "fused_middle_flow")


def bound(n: int, h: int, w: int, c: int, u: int, x_bytes: int = 2):
    m = n * h * w
    n_bytes = 2 * m * c * x_bytes + u * (9 * c * 4 + c * c * 2 + 2 * c * 4)
    return bound_s(n_bytes, {"bf16": 2.0 * m * c * c * u,
                             "f32": 18.0 * m * c * u})


def call_bound(args, kwargs):
    x, dw = args[0], args[1]
    n, h, w, c = x.shape
    return bound(n, h, w, c, dw.shape[0], x.element_size())

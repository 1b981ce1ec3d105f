"""Kernel row 6, ``biscuit_torch/ops/fused_unit_bwd.py`` ``unit_bwd_strips``,
counted at its launcher ``_launch('unit_bwd_strips', gy, r, d, p, ...)``:
the backward of one separable conv + train-mode BatchNorm unit over
M = N H W pixels, CI in and CO out channels.

Bytes, each read once and written once: gy and p (CO a pixel, bf16), r
and d (CI a pixel, bf16) read, da (CI a pixel, bf16) written. (The bound
of ``chip_smoke.py`` ``unit_bwd_bound`` also counts the BN sums' second
read of gy and p, 2 M CO bf16 elements; ``BN_REREAD_BYTES`` gives it, for
the comparison with its column.) Operations: the dgrad and wgrad GEMMs in
bf16 (2 M 2 CI CO) and the depthwise and BN work in f32 (2 M (18 CI + 6
CO))."""

from .peaks import bound_s

TARGET = ("biscuit_torch.ops.fused_unit_bwd", "_launch")
NAME = "unit_bwd_strips"


def read_once_bytes(n: int, hw: int, ci: int, co: int) -> int:
    return n * hw * hw * (2 * co + 3 * ci) * 2


def bn_reread_bytes(n: int, hw: int, co: int) -> int:
    return 2 * n * hw * hw * co * 2


def ops(n: int, hw: int, ci: int, co: int) -> dict:
    m = n * hw * hw
    return {"bf16": 2.0 * m * 2 * ci * co, "f32": 2.0 * m * (18 * ci + 6 * co)}


def bound(n: int, hw: int, ci: int, co: int):
    return bound_s(read_once_bytes(n, hw, ci, co), ops(n, hw, ci, co))


def applies(args, kwargs) -> bool:
    return bool(args) and args[0] == NAME


def call_bound(args, kwargs):
    gy, r = args[1], args[2]
    n, h, w, co = gy.shape
    if h != w:
        raise ValueError(f"square activations expected, got {h}x{w}")
    return bound(n, h, r.shape[-1], co)

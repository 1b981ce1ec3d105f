"""Rounding of the reference to the control's precision: float8 e4m3 for
the inputs of every conv and matmul, e5m2 for the gradients entering
them, each at a per-tensor scale that maps its largest magnitude to the
format's largest value. ``identity`` is the f32 reference."""

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x, dtype, fmax):
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = fmax / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def identity(x):
    return x


def fp8(x):
    return _Fp8.apply(x)


def quantizer(mode):
    if mode is None:
        return identity
    if mode == "fp8":
        return fp8
    raise ValueError(f"unknown reference precision {mode!r}")

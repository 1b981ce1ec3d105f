"""Standalone depthwise 3x3 convolution (``csrc/depthwise3x3.cu``).

Counterpart of ``biscuit_tpu/ops/depthwise_pallas.py``:

    out[n, h, w, c] = sum_{dy, dx} x[n, h+dy-1, w+dx-1, c] * k[dy, dx, c]

stride 1, SAME, NHWC in bf16 or f32, output in x's dtype, nine f32 taps
in (dy, dx) order. ``depthwise_conv3x3`` is a ``torch.autograd.Function``
with the JAX custom VJP's backward: the input gradient is the same kernel
with the taps flipped in space, on the output gradient cast to x's dtype;
the filter gradient is nine f32 reductions in plain torch (the JAX
package leaves them to XLA). The filter takes the JAX layout, (3, 3, 1, C)
or (3, 3, C). Nothing else in the package calls it.

On a CPU tensor the forward computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

NAME = "depthwise3x3"
DTYPES = (torch.bfloat16, torch.float32)


def _taps9(kernel):
    """(3, 3, 1, C) or (3, 3, C) filter -> (9, C) f32 taps."""
    if kernel.shape[:2] != (3, 3) or kernel.ndim not in (3, 4) or (
            kernel.ndim == 4 and kernel.shape[2] != 1):
        raise ValueError(f"filter must be (3, 3, 1, C) or (3, 3, C), got "
                         f"{tuple(kernel.shape)}")
    return kernel.reshape(9, kernel.shape[-1]).float()


def depthwise_conv3x3_reference(x, kernel):
    """Plain version: nine f32 taps from zeros, each product and sum
    rounded on its own, output in x's dtype. Differentiable by autograd."""
    taps = _taps9(kernel)
    n, h, w, _ = x.shape
    pad = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + pad[:, dy:dy + h, dx:dx + w, :] * taps[dy * 3 + dx]
    return acc.to(x.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])


def _forward(x, taps):
    """The op on (9, C) f32 taps: the kernel on a CUDA tensor, the plain
    version on a CPU one."""
    if not x.is_cuda:
        return depthwise_conv3x3_reference(x, taps.reshape(3, 3, -1))
    if x.dtype not in DTYPES:
        raise TypeError(f"{NAME} takes bf16 or f32 on the card, got {x.dtype}")
    if x.ndim != 4 or tuple(taps.shape) != (9, x.shape[-1]):
        raise ValueError(f"{NAME}: x must be NHWC with C = {taps.shape[-1]}, "
                         f"got {tuple(x.shape)}")
    taps = taps.contiguous()
    for name, t in (("x", x), ("taps", taps)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{NAME}: {name} must start on a 16-byte "
                             f"boundary (a view at an offset does not)")
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    rc = _build.bound(NAME, "depthwise3x3_launch", _ARGTYPES)(
        _build.ptr(x), _build.ptr(taps), _build.ptr(out), n, h, w, c,
        int(x.dtype == torch.float32), x.device.index or 0,
        _build.stream_ptr(x))
    _build.check(rc, NAME)
    _build.count_launch(NAME)
    return out


class _Depthwise3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return _forward(x, _taps9(kernel))

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        taps = _taps9(kernel)
        # dL/dx: g correlated with the taps flipped in space (the same op).
        dx = _forward(g.to(x.dtype).contiguous(), taps.flip(0))
        # dL/dk[dy, dx, c] = sum_{n, h, w} x_pad[n, h+dy, w+dx, c] g[n, h, w, c]
        n, h, w, c = x.shape
        xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
        gf = g.float()
        dk = torch.stack([(xp[:, dy:dy + h, dxi:dxi + w, :] * gf).sum((0, 1, 2))
                          for dy in range(3) for dxi in range(3)])
        return dx, dk.reshape(kernel.shape).to(kernel.dtype)


def depthwise_conv3x3(x, kernel):
    """Depthwise 3x3, stride 1, SAME on NHWC ``x`` (bf16 or f32) with a
    (3, 3, 1, C) or (3, 3, C) filter; returns x's dtype."""
    return _Depthwise3x3.apply(x, kernel)

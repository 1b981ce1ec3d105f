"""Fused strided Xception block (``csrc/fused_block.cu``).

Counterpart of ``biscuit_tpu/ops/fused_block.py``: one whole strided
block of the trunk at inference (entry0, entry1, entry2, the exit block),

    [relu] -> sepconv -> BN -> relu -> sepconv -> BN
    -> maxpool 3x3 stride 2 SAME (+) residual 1x1 stride-2 conv + BN,

from one NHWC read to one write at half the resolution, in x's dtype:
bf16 (the bf16 trunk) or f32 (a ``compute_dtype="float32"`` model's), as
the TPU kernel takes either. The numerics are the TPU kernel's, not the
Flax block's: nine f32 taps rounded to bf16 before each pointwise
product, the first sepconv's output kept in f32, the second's rounded to
bf16 before the pool, and the residual 1x1 conv on the raw x, in f32
for f32 x (the kernel splits x into two bf16 terms; ``csrc/
fused_block.cu`` says why).

Weights come from ``stack_block_weights`` as the TPU kernel takes them:
depthwise taps (9, C) f32 in (dy, dx) row-major order, pointwise and
residual weights (in, out) bf16, the BatchNorms folded to f32 (C,)
scale and shift. On a CPU tensor ``fused_strided_block`` computes the
plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .depthwise import depthwise_conv3x3_reference
from .fused_sepconv import fold_bn

NAME = "fused_block"


def stack_block_weights(block, eps: float = 1e-5):
    """An ``XceptionBlock`` module's weights as the kernel takes them:
    (dw0, pw0, s0, h0, dw1, pw1, s1, h1, rw, rs, rh)."""
    out = []
    for j in (0, 1):
        sep = getattr(block, f"sep{j}")
        k = sep.depthwise.weight.detach()              # (C, 1, 3, 3)
        out.append(k.reshape(k.shape[0], 9).t().float().contiguous())
        p = sep.pointwise.weight.detach()              # (out, in, 1, 1)
        out.append(p[:, :, 0, 0].t().to(torch.bfloat16).contiguous())
        out.extend(t.contiguous() for t in fold_bn(getattr(block, f"bn{j}"),
                                                   eps))
    rw = block.res_conv.weight.detach()
    out.append(rw[:, :, 0, 0].t().to(torch.bfloat16).contiguous())
    out.extend(t.contiguous() for t in fold_bn(block.res_bn, eps))
    return tuple(out)


def trunk_blocks(backbone):
    """The strided blocks the fused trunk runs: the entry blocks, then the
    exit block."""
    n = len(backbone.cfg["entry_blocks"])
    return [getattr(backbone, f"entry{i}") for i in range(n)] + [
        backbone.exit_block]


def _bf(t):
    """t rounded to bf16, in f32."""
    return t.to(torch.bfloat16).float()


def fused_strided_block_reference(x, weights, relu_first: bool):
    """Plain version of the kernel at its rounding points. Returns
    (N, ceil(H/2), ceil(W/2), F1) in x's dtype."""
    from ..models.xception import max_pool_same

    dw0, pw0, s0, h0, dw1, pw1, s1, h1, rw, rs, rh = weights
    n, h, w, cin = x.shape
    f0, f1 = pw0.shape[1], pw1.shape[1]
    inp = (torch.relu(x) if relu_first else x).float()
    a0 = depthwise_conv3x3_reference(inp, dw0.reshape(3, 3, cin))
    y0 = a0.to(torch.bfloat16).float().reshape(-1, cin) @ _bf(pw0)
    y0 = torch.relu(y0 * s0 + h0).reshape(n, h, w, f0)
    a1 = depthwise_conv3x3_reference(y0, dw1.reshape(3, 3, f0))
    y1 = (a1.to(torch.bfloat16).float().reshape(-1, f0) @ _bf(pw1)) * s1
    y1 = (y1 + h1).reshape(n, h, w, f1).to(torch.bfloat16).float()
    # -inf padding; SAME's window of output j is [2j-1, 2j+1] on an odd
    # size and [2j, 2j+2] on an even one.
    pooled = max_pool_same(y1.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    xr = x[:, ::2, ::2, :].float()
    r = (xr.reshape(-1, cin) @ _bf(rw)) * rs + rh
    return (pooled + r.reshape(pooled.shape)).to(x.dtype)


# The activations the kernel takes.
X_DTYPES = (torch.bfloat16, torch.float32)


def _check(x, weights):
    """Shapes, types, devices, contiguity and 16-byte alignment the kernel
    needs: x bf16 or f32 (X_DTYPES), the weights as
    ``stack_block_weights`` gives them; returns (Cin, F0, F1)."""
    if x.dtype not in X_DTYPES:
        raise TypeError(f"{NAME} takes bf16 or f32 on the card, got "
                        f"{x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"{NAME}: x must be NHWC, got shape {tuple(x.shape)}")
    if len(weights) != 11:
        raise ValueError(f"{NAME}: expected 11 weights (stack_block_weights), "
                         f"got {len(weights)}")
    cin = x.shape[-1]
    f0, f1 = weights[1].shape[-1], weights[5].shape[-1]
    if cin % 8 or f0 % 8 or f1 % 8:
        raise ValueError(f"{NAME}: needs Cin, F0, F1 % 8 == 0, got {cin}, "
                         f"{f0}, {f1}")
    f32, bf = torch.float32, torch.bfloat16
    want = (("dw0", (9, cin), f32), ("pw0", (cin, f0), bf), ("s0", (f0,), f32),
            ("h0", (f0,), f32), ("dw1", (9, f0), f32), ("pw1", (f0, f1), bf),
            ("s1", (f1,), f32), ("h1", (f1,), f32), ("rw", (cin, f1), bf),
            ("rs", (f1,), f32), ("rh", (f1,), f32))
    for (name, shape, dtype), t in zip(want, weights):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{NAME}: {name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    # The kernel reads activations and weights in 8- and 16-byte vectors.
    for name, t in (("x", x),) + tuple(zip((w[0] for w in want), weights)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous on "
                             f"{x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{NAME}: {name} must start on a 16-byte "
                             f"boundary (a view at an offset does not)")
    return cin, f0, f1


def fused_strided_block(x_nhwc, weights, relu_first: bool = True):
    """One strided Xception block on a bf16 or f32 NHWC activation;
    ``weights`` from ``stack_block_weights``. Returns (N, ceil(H/2),
    ceil(W/2), F1) in x's dtype."""
    if not x_nhwc.is_cuda:
        return fused_strided_block_reference(x_nhwc, weights, relu_first)
    cin, f0, f1 = _check(x_nhwc, weights)
    n, h, w, _ = x_nhwc.shape
    h2, w2 = -(-h // 2), -(-w // 2)
    dev, bf = x_nhwc.device, torch.bfloat16
    x_f32 = x_nhwc.dtype == torch.float32
    out = torch.empty((n, h2, w2, f1), dtype=x_nhwc.dtype, device=dev)
    a0 = torch.empty((n, h, w, cin), dtype=bf, device=dev)
    y0 = torch.empty((n, h, w, f0), dtype=torch.float32, device=dev)
    a1 = torch.empty((n, h, w, f0), dtype=bf, device=dev)
    y1 = torch.empty((n, h, w, f1), dtype=bf, device=dev)
    # f32 x: the residual GEMM's [hi | lo] rows and [rw; rw]. The launcher
    # fills [rw; rw] from rw on every call rather than keeping it with the
    # weights, so the eleven weights stay the one layout that the bf16
    # path, the plain version and stack_block_weights share; the copy
    # reads and writes 4·Cin·F1 bytes each (6 MB at the exit block), under
    # 3% of x's read at 256 tiles of 299 px.
    xs = (torch.empty((n, h2, w2, 2 * cin), dtype=bf, device=dev)
          if x_f32 else None)
    rw2 = torch.empty((2 * cin, f1), dtype=bf, device=dev) if x_f32 else None
    fn = _build.bound(NAME, "fused_block_launch",
                      [ctypes.c_void_p] * 19 + [ctypes.c_int] * 9
                      + [ctypes.c_void_p])
    rc = fn(*(_build.ptr(t) for t in (x_nhwc, *weights, out, a0, y0, a1, y1)),
            *(ctypes.c_void_p(None if t is None else t.data_ptr())
              for t in (xs, rw2)),
            n, h, w, cin, f0, f1, int(bool(relu_first)), int(x_f32),
            dev.index or 0, _build.stream_ptr(x_nhwc))
    _build.check(rc, NAME)
    _build.count_launch(NAME)
    return out

"""Fused Xception middle flow (``csrc/fused_middle_flow.cu``) and the
trunk compositions around it.

Counterpart of ``biscuit_tpu/ops/fused_sepconv.py``: ``fold_bn``,
``stack_middle_weights``, ``fused_middle_flow`` and
``trunk_features_fused`` in both its compositions: the default
(library-conv entry flow -> fused middle flow -> library-conv exit flow)
and, with ``fuse_blocks=True``, the fully fused trunk (library stem ->
fused entry blocks -> fused middle flow -> fused exit block -> library
exit sepconvs and pool), whose strided blocks are ``ops/fused_block.py``.

On a CPU tensor ``fused_middle_flow`` computes its plain version; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "fused_middle_flow"


def fold_bn(bn, eps: float = 1e-5):
    """Fold inference BatchNorm to per-channel f32 (scale, shift):
    scale = gamma / sqrt(var + eps), shift = beta - mean * scale."""
    scale = bn.weight.detach().float() / torch.sqrt(
        bn.running_var.detach().float() + eps)
    shift = bn.bias.detach().float() - bn.running_mean.detach().float() * scale
    return scale, shift


def stack_middle_weights(backbone, n_blocks: int, eps: float = 1e-5):
    """The middle flow's weights as the kernel takes them: dw (U, 9, C)
    f32 taps in (dy, dx) row-major order, pw (U, C, C) bf16 (in, out), and
    the folded BN sc, sh (U, C) f32, U = 3 * n_blocks."""
    dw, pw, sc, sh = [], [], [], []
    for i in range(n_blocks):
        blk = getattr(backbone, f"middle{i}")
        for j in range(3):
            sep = getattr(blk, f"sep{j}")
            k = sep.depthwise.weight.detach()          # (C, 1, 3, 3)
            dw.append(k.reshape(k.shape[0], 9).t())
            p = sep.pointwise.weight.detach()          # (out, in, 1, 1)
            pw.append(p[:, :, 0, 0].t())
            scale, shift = fold_bn(getattr(blk, f"bn{j}"), eps)
            sc.append(scale)
            sh.append(shift)
    return (
        torch.stack(dw).float().contiguous(),
        torch.stack(pw).to(torch.bfloat16).contiguous(),
        torch.stack(sc).float().contiguous(),
        torch.stack(sh).float().contiguous(),
    )


def fused_middle_flow_reference(x_nhwc, dw, pw, sc, sh):
    """Plain version: 24 units of relu -> depthwise 3x3 SAME (nine f32
    taps, in the kernel's order) -> bf16 -> f32 matmul of the bf16-rounded
    operands -> scale/shift, identity residual every 3 units, f32 carry,
    output in x's dtype."""
    n, h, w, c = x_nhwc.shape
    x = x_nhwc.float()
    pwf = pw.to(torch.bfloat16).float()
    for b in range(dw.shape[0] // 3):
        res = x
        for u in range(3):
            uid = b * 3 + u
            pad = torch.nn.functional.pad(torch.relu(x), (0, 0, 1, 1, 1, 1))
            acc = torch.zeros_like(x)
            for dy in range(3):
                for dx in range(3):
                    acc = acc + pad[:, dy:dy + h, dx:dx + w, :] * dw[uid, dy * 3 + dx]
            a = acc.to(torch.bfloat16).float().reshape(-1, c)
            y = (a @ pwf[uid]) * sc[uid] + sh[uid]
            x = y.reshape(n, h, w, c)
        x = x + res
    return x.to(x_nhwc.dtype)


_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _aligned(t):
    """t, or a copy of it that starts on a 16-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_middle_flow(x_nhwc, dw, pw, sc, sh):
    """Run the full middle flow on an NHWC activation.

    Args:
        x_nhwc: (N, H, W, C) activation entering the middle flow (bf16 on
            the card).
        dw: (U, 9, C) f32 depthwise taps, U = 3 * n_blocks.
        pw: (U, C, C) bf16 pointwise weights (in-ch, out-ch).
        sc, sh: (U, C) f32 folded inference-BatchNorm scale/shift.

    Returns (N, H, W, C) in x's dtype.
    """
    if not x_nhwc.is_cuda:
        return fused_middle_flow_reference(x_nhwc, dw, pw, sc, sh)
    n, h, w, c = x_nhwc.shape
    u = dw.shape[0]
    if x_nhwc.dtype != torch.bfloat16:
        raise TypeError(f"fused_middle_flow takes bf16 on the card, got "
                        f"{x_nhwc.dtype}")
    if u % 3 or c % 8:
        raise ValueError(f"need U % 3 == 0 and C % 8 == 0, got U={u}, C={c}")
    want = {"dw": ((u, 9, c), torch.float32, dw),
            "pw": ((u, c, c), torch.bfloat16, pw),
            "sc": ((u, c), torch.float32, sc),
            "sh": ((u, c), torch.float32, sh)}
    for name, (shape, dtype, t) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_cuda:
            raise ValueError(f"{name}: expected {shape} {dtype} on the card, "
                             f"got {tuple(t.shape)} {t.dtype} {t.device}")
        if t.device != x_nhwc.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x_nhwc.device}")
    # The kernel reads every operand through 16-byte vectors and tensor
    # maps; a tensor that starts off such a boundary is copied first.
    x, dw, pw, sc, sh = (_aligned(t.contiguous()) for t in (x_nhwc, dw, pw,
                                                             sc, sh))
    out = torch.empty_like(x)
    carry = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    tmp = torch.empty_like(carry)
    a = torch.empty_like(x)
    rc = _build.bound(NAME, "fused_middle_flow_launch", _ARGTYPES)(
        *(_build.ptr(t) for t in (x, dw, pw, sc, sh, out, carry, tmp, a)),
        n, h, w, c, u, x.device.index or 0, _build.stream_ptr(x))
    _build.check(rc, NAME)
    _build.count_launch(NAME)
    return out


def trunk_features_fused(model, x, mid_wts=None, fuse_blocks: bool = False,
                         block_wts=None):
    """Inference trunk features with the fused middle flow. By default
    the entry and exit flows are library convs; ``fuse_blocks=True`` runs
    the stem, then each strided block (entry blocks and exit block)
    through ``fused_strided_block``, then the exit sepconvs and pool.
    ``mid_wts`` and ``block_wts`` are ``stack_middle_weights``'s result
    and the list of ``stack_block_weights`` results of
    ``fused_block.trunk_blocks``, computed here when None. The kernels
    run through their registered ops (``ops/library.py``), so that this
    composition traces into an exported program as it runs live."""
    from ..models.xception import ARCHS
    from . import library

    if mid_wts is None:
        mid_wts = stack_middle_weights(
            model.backbone, ARCHS[model.arch]["middle_repeats"])
    if not fuse_blocks:
        h = model.trunk_entry(x)
        h = library.fused_middle_flow(h, *mid_wts)
        return model.trunk_exit(h)

    from .fused_block import stack_block_weights, trunk_blocks

    blocks = trunk_blocks(model.backbone)
    if block_wts is None:
        block_wts = [stack_block_weights(b) for b in blocks]
    h = model.trunk_stem(x).contiguous()
    for blk, wts in zip(blocks[:-1], block_wts[:-1]):
        h = library.fused_strided_block(h, list(wts), int(blk.relu_first))
    h = library.fused_middle_flow(h, *mid_wts)
    h = library.fused_strided_block(h, list(block_wts[-1]),
                                    int(blocks[-1].relu_first))
    return model.trunk_exit_tail(h)

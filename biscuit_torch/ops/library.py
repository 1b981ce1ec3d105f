"""The serving kernels as registered PyTorch operators (``biscuit::*``).

``torch.export`` traces with fake tensors, so it cannot see through a
kernel wrapper that hands ``data_ptr()``s to ``ctypes``. Registered as
``torch.library.custom_op``s, the four kernels of the serving path enter
an exported program as one node each, and a loaded program calls them
back through the dispatcher:

- ``biscuit::fused_preprocess(x, coef)``: uint8 (N, H, W, 3) tiles and
  the 42 coefficients (``fused_preprocess.coefficients``) -> bf16
  (N, H, W, 3);
- ``biscuit::fused_middle_flow(x, dw, pw, sc, sh)``: the middle flow,
  weights from ``fused_sepconv.stack_middle_weights`` -> x's shape;
- ``biscuit::fused_strided_block(x, weights, relu_first)``: one strided
  block, ``weights`` from ``fused_block.stack_block_weights`` ->
  (N, ceil(H/2), ceil(W/2), F1);
- ``biscuit::mcd_head(feats, weights, seed, k, dropout)``: the K-pass MC
  head, ``weights`` from ``mcd_head.head_weights``, ``seed`` a 0-d int64
  CPU tensor (``mcd_head.seed_tensor``) -> (mean, std), each (N, C) f32.

Each op's one implementation is the kernel's wrapper: on a CPU tensor it
computes the plain version, on a CUDA tensor it launches the kernel (and
counts the launch) or raises. ``register_fake`` gives each output's
shape and dtype for tracing. A process must import this module before
``torch.export.load`` of a program that holds these ops; importing it
twice registers nothing twice.
"""

from __future__ import annotations

from typing import List

import torch
from torch import Tensor

from .fused_block import fused_strided_block as _block
from .fused_preprocess import fused_preprocess as _preprocess
from .fused_sepconv import fused_middle_flow as _middle
from .mcd_head import mcd_head as _head


@torch.library.custom_op("biscuit::fused_preprocess", mutates_args=())
def fused_preprocess(x: Tensor, coef: Tensor) -> Tensor:
    return _preprocess(x, coef=coef).contiguous()


@fused_preprocess.register_fake
def _(x, coef):
    return x.new_empty(x.shape, dtype=torch.bfloat16)


@torch.library.custom_op("biscuit::fused_middle_flow", mutates_args=())
def fused_middle_flow(x: Tensor, dw: Tensor, pw: Tensor, sc: Tensor,
                      sh: Tensor) -> Tensor:
    return _middle(x, dw, pw, sc, sh).contiguous()


@fused_middle_flow.register_fake
def _(x, dw, pw, sc, sh):
    return x.new_empty(x.shape)


@torch.library.custom_op("biscuit::fused_strided_block", mutates_args=())
def fused_strided_block(x: Tensor, weights: List[Tensor],
                        relu_first: int) -> Tensor:
    return _block(x, tuple(weights), bool(relu_first)).contiguous()


@fused_strided_block.register_fake
def _(x, weights, relu_first):
    n, h, w, _ = x.shape
    return x.new_empty((n, (h + 1) // 2, (w + 1) // 2, weights[5].shape[-1]))


@torch.library.custom_op("biscuit::mcd_head", mutates_args=())
def mcd_head(feats: Tensor, weights: List[Tensor], seed: Tensor, k: int,
             dropout: float) -> tuple[Tensor, Tensor]:
    if seed.device.type != "cpu" or seed.dtype != torch.int64 or seed.ndim:
        raise ValueError("seed must be a 0-d int64 CPU tensor "
                         "(mcd_head.seed_tensor)")
    mean, std = _head(feats, *weights, k=k, dropout=dropout, seed=seed)
    return mean.contiguous(), std.contiguous()


@mcd_head.register_fake
def _(feats, weights, seed, k, dropout):
    shape = (feats.shape[0], weights[4].shape[-1])
    return (feats.new_empty(shape, dtype=torch.float32),
            feats.new_empty(shape, dtype=torch.float32))

"""Train-mode Xception trunk with the fused unit backwards.

Counterpart of ``biscuit_tpu/train/fused_train.py``: the same trunk as
``models/xception.py`` in train mode, written as a function over the
backbone module's parameters, with every separable conv + BatchNorm pair
sent through ``ops/fused_unit_bwd.sep_bn_unit`` (whose backward is the
hand-written kernel on the card). The stem convs, the residual 1x1 convs
and the max-pools stay on library ops, as the JAX twin keeps them on XLA,
and their BatchNorms are ``ops/bn_train.bn_train``, whose two passes
each way give the port what XLA's fusion gives the JAX twin. Activations
are NHWC; the library ops see NCHW views with channels-last strides.

The forward is the module path's arithmetic; the gradients differ from
autograd's only by the fused backward's f32 handling of gd
(``ops/fused_unit_bwd.py``). Running statistics are returned as updates,
not written, as the JAX twin returns them; ``apply_stat_updates`` writes
them into the module. Inside ``models/xception.bn_group(group)`` every
BatchNorm takes the statistics of that group (``parallel/lockstep``), as
the module path's do.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.xception import (
    ARCHS,
    _nchw,
    _nhwc,
    current_bn_group,
    max_pool_same,
    running_update,
)
from ..ops.bn_train import bn_train
from ..ops.fused_unit_bwd import sep_bn_unit

Updates = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _record(updates: Updates, path: str, bn, mu, var) -> None:
    updates[path] = (running_update(bn.running_mean, mu),
                     running_update(bn.running_var, var))


def _bn(x, bn, updates: Updates, path: str):
    """Train-mode BatchNorm on NHWC x (``ops/bn_train``)."""
    y, mu, var = bn_train(x, bn.weight, bn.bias, bn.eps, current_bn_group())
    _record(updates, path, bn, mu, var)
    return y


def _unit(x, sep, bn, updates: Updates, path: str, relu_first: bool,
          backend: str):
    """One separable conv + BatchNorm through the fused op."""
    ci = sep.depthwise.weight.shape[0]
    taps = sep.depthwise.weight.reshape(ci, 9).t()        # (9, CI)
    wpw = sep.pointwise.weight[:, :, 0, 0].t()            # (CI, CO)
    y, mu, var = sep_bn_unit(x, taps, wpw, bn.weight, bn.bias, bn.eps,
                             relu_first, backend, current_bn_group())
    _record(updates, path, bn, mu, var)
    return y


def _block(x, blk, updates: Updates, name: str, relu_first: bool,
           backend: str):
    """XceptionBlock twin: units through the fused op, residual conv,
    its BatchNorm and the pool on library ops."""
    if blk.has_res:
        res = _nhwc(blk.res_conv(_nchw(x)))
        res = _bn(res, blk.res_bn, updates, f"{name}.res_bn")
    else:
        res = x
    h = x
    for i in range(blk.n):
        h = _unit(h, getattr(blk, f"sep{i}"), getattr(blk, f"bn{i}"),
                  updates, f"{name}.bn{i}", relu_first or i > 0, backend)
    if blk.strides != 1:
        h = _nhwc(max_pool_same(_nchw(h)))
    return h + res


def trunk_train_apply(backbone, x, backend: str = "auto"):
    """Train-mode trunk forward of NHWC tiles -> (pooled f32 features,
    running-statistics updates ``{module path: (mean, var)}``).

    Gradients reach the backbone's parameters through the fused unit
    backwards; the updates are the momentum blend of the batch statistics
    and carry no gradient."""
    cfg = ARCHS[backbone.arch]
    updates: Updates = {}
    h = _nhwc(backbone.conv1(_nchw(x.to(backbone.compute_dtype))))
    h = torch.relu(_bn(h, backbone.conv1_bn, updates, "conv1_bn"))
    h = _nhwc(backbone.conv2(_nchw(h)))
    h = torch.relu(_bn(h, backbone.conv2_bn, updates, "conv2_bn"))
    for i in range(len(cfg["entry_blocks"])):
        h = _block(h, getattr(backbone, f"entry{i}"), updates, f"entry{i}",
                   i != 0, backend)
    for i in range(cfg["middle_repeats"]):
        h = _block(h, getattr(backbone, f"middle{i}"), updates,
                   f"middle{i}", True, backend)
    h = _block(h, backbone.exit_block, updates, "exit_block", True, backend)
    # Flax: sep0 -> bn0 -> relu -> sep1 -> bn1 -> relu. The relu between
    # the two is unit 1's leading relu; only the last one is explicit.
    for i in range(len(cfg["exit_convs"])):
        h = _unit(h, getattr(backbone, f"exit_sep{i}"),
                  getattr(backbone, f"exit_bn{i}"), updates, f"exit_bn{i}",
                  i != 0, backend)
    h = torch.relu(h)
    feats = h.float().mean(dim=(1, 2)).to(h.dtype).float()
    return feats, updates


@torch.no_grad()
def apply_stat_updates(backbone, updates: Updates) -> None:
    """Write ``trunk_train_apply``'s updates into the running statistics."""
    for path, (mean, var) in updates.items():
        bn = backbone.get_submodule(path)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)


def fused_train_applicable(model) -> bool:
    """The fused trunk serves the Xception family in bf16 (the published
    configuration); f32 models keep the module path."""
    return (getattr(model, "arch", None) in ARCHS
            and getattr(model, "compute_dtype", None) == torch.bfloat16)

"""The classifiers' forward pass in plain f32 torch over a weight dict
(names of ``params.py``), NCHW inside: Xception (Chollet 2017, the
keras.applications layout: VALID stem, SAME elsewhere, the stride-2
SAME max-pool) and ResNet-v1.5 (He et al. 2016, SAME padding as Flax
pads it), BatchNorm in eval mode (running statistics) or train mode (the
batch's biased statistics, which Flax's BatchNorm blends into its running
statistics as ``MOMENTUM`` * old + (1 - ``MOMENTUM``) * batch), the
global average pool, and the f32 head.
``q`` rounds what the configuration computes in its compute dtype: the
weights and inputs of every conv and matmul and every activation of the
trunk (``quant.py``); the identity in the f32 reference."""

import math

import torch
import torch.nn.functional as F

from .params import resnet_blocks, xception_blocks

EPS = 1e-5
MOMENTUM = 0.99


def _same(size: int, k: int, stride: int):
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride=1, padding="SAME", q=None, groups=1):
    k = w.shape[-1]
    if padding == "SAME":
        t, b = _same(x.shape[2], k, stride)
        lft, r = _same(x.shape[3], k, stride)
        if t or b or lft or r:
            x = F.pad(x, (lft, r, t, b))
    return q(F.conv2d(q(x), q(w), None, stride, 0, 1, groups))


def max_pool_same(x):
    t, b = _same(x.shape[2], 3, 2)
    lft, r = _same(x.shape[3], 3, 2)
    return F.max_pool2d(F.pad(x, (lft, r, t, b), value=-math.inf), 3, 2)


def batch_norm(x, p, name, train: bool, q, stats=None):
    """``stats``, in train mode: {name: (batch mean, biased variance)}."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), correction=0)
        if stats is not None:
            stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    scale = p[f"{name}.weight"] * torch.rsqrt(var + EPS)
    return q((x - mean[:, None, None]) * scale[:, None, None]
             + p[f"{name}.bias"][:, None, None])


def _sep(x, p, name, q):
    x = conv(x, p[f"{name}.depthwise.weight"], q=q, groups=x.shape[1])
    return conv(x, p[f"{name}.pointwise.weight"], q=q)


def xception_trunk(x, p, arch, bn, q):
    for i, stride in ((1, 2), (2, 1)):
        x = torch.relu(bn(conv(x, p[f"backbone.conv{i}.weight"], stride,
                               "VALID", q), f"backbone.conv{i}_bn"))
    for name, cin, feats, strides, relu_first in xception_blocks(arch):
        pre = f"backbone.{name}"
        if strides != 1 or cin != feats[-1]:
            res = bn(conv(x, p[f"{pre}.res_conv.weight"], strides, q=q),
                     f"{pre}.res_bn")
        else:
            res = x
        h = x
        for i in range(len(feats)):
            if i > 0 or relu_first:
                h = torch.relu(h)
            h = bn(_sep(h, p, f"{pre}.sep{i}", q), f"{pre}.bn{i}")
        if strides != 1:
            h = max_pool_same(h)
        x = q(h + res)
    for i in range(len(arch["exit_convs"])):
        x = torch.relu(bn(_sep(x, p, f"backbone.exit_sep{i}", q),
                          f"backbone.exit_bn{i}"))
    return q(x.mean(dim=(2, 3)))


def resnet_trunk(x, p, arch, bn, q):
    x = torch.relu(bn(conv(x, p["backbone.stem.weight"], 2, q=q),
                      "backbone.stem_bn"))
    x = max_pool_same(x)
    bottleneck = arch["block"] == "bottleneck"
    blocks, _ = resnet_blocks(arch)
    for name, cin, f, s in blocks:
        pre = f"backbone.{name}"
        mult = 4 if bottleneck else 1
        if s != 1 or cin != f * mult:
            res = bn(conv(x, p[f"{pre}.proj.weight"], s, q=q),
                     f"{pre}.proj_bn")
        else:
            res = x
        strides = (1, s, 1) if bottleneck else (s, 1)
        h = x
        for i, st in enumerate(strides, 1):
            h = bn(conv(h, p[f"{pre}.conv{i}.weight"], st, q=q),
                   f"{pre}.bn{i}")
            if i < len(strides):
                h = torch.relu(h)
        x = torch.relu(q(h + res))
    return q(x.mean(dim=(2, 3)))


def features(x_nhwc, p, config, train=False, q=None, stats=None):
    """Pooled f32 features of standardized NHWC f32 tiles; in train mode
    each BatchNorm's batch statistics go into ``stats`` when given."""
    from .quant import identity

    q = q or identity
    x = x_nhwc.permute(0, 3, 1, 2)
    arch = config["arch"]
    trunk = xception_trunk if arch["family"] == "xception" else resnet_trunk

    def bn(h, name):
        return batch_norm(h, p, name, train, q, stats)

    return trunk(x, p, arch, bn, q)


def dense(x, p, name, q):
    return q(x) @ q(p[f"{name}.weight"]).t() + p[f"{name}.bias"]

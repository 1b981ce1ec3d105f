"""The classifiers' forward pass in plain f32 torch over a weight dict
(names of ``params.py``), NCHW inside: the trunk of the configuration's
family (``families/<family>.py``) over the shared pieces here (SAME or
VALID convs, the stride-2 SAME max-pool), BatchNorm in eval mode
(running statistics) or train mode (the batch's biased statistics, which
Flax's BatchNorm blends into its running statistics as ``MOMENTUM`` * old
+ (1 - ``MOMENTUM``) * batch), and the f32 head.
``q`` rounds what the configuration computes in its compute dtype: the
weights and inputs of every conv and matmul and every activation of the
trunk (``quant.py``); the identity in the f32 reference."""

import math

import torch
import torch.nn.functional as F

from . import families

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


def features(x_nhwc, p, config, train=False, q=None, stats=None):
    """Pooled f32 features of standardized NHWC f32 tiles; in train mode
    each BatchNorm's batch statistics go into ``stats`` when given."""
    from .quant import identity

    q = q or identity
    x = x_nhwc.permute(0, 3, 1, 2)

    def bn(h, name):
        return batch_norm(h, p, name, train, q, stats)

    return families.of(config).features(x, p, config["arch"], bn, q)


def dense(x, p, name, q):
    return q(x) @ q(p[f"{name}.weight"]).t() + p[f"{name}.bias"]

"""Xception tile classifier as torch ``nn.Module``s.

Counterpart of ``biscuit_tpu/models/xception.py``: the same architecture
presets, module names and stage seams, so a Flax parameter tree maps onto
this module's ``state_dict`` name for name (``models/convert.py``).
``build_model`` is the ``hp.model`` registry: these presets, the ResNet
family of ``models/resnet.py`` and the ViT family of ``models/vit.py``
(the classifier's backbone), and an unknown name falls back to
'xception' with a warning.

Public functions and stage seams take and return NHWC tensors, as the
JAX package does; inside, activations are NCHW views with channels-last
strides, which is the layout cuDNN runs NHWC kernels on.

Numerics follow the Flax model: convolutions compute in
``compute_dtype`` (bf16 by default) with f32 parameters cast at the call,
BatchNorm normalizes in f32 and rounds back to the compute dtype (Flax
promotes bf16 activations against f32 statistics), the global average
pool rounds to the compute dtype before the f32 features, and the head
runs in f32. In train mode (``model.train()``) BatchNorm normalizes with
the batch's own statistics and updates the running ones as Flax does
(``batch_norm_train``), and the head samples dropout from an explicit
``torch.Generator``. Under lockstep data parallelism the batch is the
group's: inside ``bn_group(group)`` a train-mode BatchNorm takes its
statistics over every rank's rows (``parallel/lockstep.py``), and the
head draws its dropout masks at the group's batch shape and keeps this
rank's rows (``rows``). Padding: the two stem convs are VALID, every other
conv is SAME, and the stride-2 SAME max-pool pads asymmetrically on even
sizes (explicit -inf pad, never ``MaxPool2d(padding=1)``).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bn_train import bn_train

# Architecture presets (copied from biscuit_tpu/models/xception.py).
ARCHS = {
    "xception": {
        "entry_convs": (32, 64),
        "entry_blocks": (128, 256, 728),
        "middle_repeats": 8,
        "middle_width": 728,
        "exit_block": (728, 1024),
        "exit_convs": (1536, 2048),
    },
    # Reduced variant for CPU tests.
    "xception_tiny": {
        "entry_convs": (8, 16),
        "entry_blocks": (16, 32, 48),
        "middle_repeats": 2,
        "middle_width": 48,
        "exit_block": (48, 64),
        "exit_convs": (96, 128),
    },
}


def _nchw(x_nhwc):
    return x_nhwc.permute(0, 3, 1, 2)


def _nhwc(x_nchw):
    return x_nchw.permute(0, 2, 3, 1)


class Conv(nn.Conv2d):
    """Bias-free conv whose f32 weight is cast to the activation dtype."""

    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         groups=groups, bias=False)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                        self.padding, 1, self.groups)


MOMENTUM = 0.99     # Flax BatchNorm's running-statistics momentum

_BN_GROUP = threading.local()   # each rank of a group is its own thread


@contextmanager
def bn_group(group):
    """Train-mode ``BatchNorm`` modules called in this thread inside the
    block take their statistics over ``group`` (a ``parallel/lockstep.
    Group``; None is this rank alone)."""
    prev = getattr(_BN_GROUP, "group", None)
    _BN_GROUP.group = group
    try:
        yield
    finally:
        _BN_GROUP.group = prev


def current_bn_group():
    """The group of the innermost ``bn_group`` block of this thread, or
    None."""
    return getattr(_BN_GROUP, "group", None)


def batch_norm_train(x, weight, bias, eps: float, dims, group=None):
    """Train-mode BatchNorm as Flax computes it: statistics over ``dims``
    in f32, the biased fast variance ``max(0, E[x^2] - E[x]^2)``, and the
    output rounded once to x's dtype. The one dimension not in ``dims``
    holds the channels, which ``weight`` and ``bias`` (C,) scale and
    shift. Returns (y, mean, var), mean and var of shape (C,).

    The op is ``ops/bn_train.bn_train`` on the channels-last view of x
    (its kernels on the card, its plain versions on the CPU), with its
    closed-form backward. With a ``group`` of several ranks, each holding
    as many rows as the others, the statistics are over every rank's
    rows, so that the input's gradient sees the whole group's batch while
    gamma's and beta's stay this rank's share."""
    (cdim,) = (d for d in range(x.ndim) if d not in dims)
    y, mu, var = bn_train(x.movedim(cdim, -1), weight, bias, eps, group)
    return y.movedim(-1, cdim), mu, var


def running_update(old, batch):
    """Flax's running-statistics blend ``0.99 * old + 0.01 * batch``."""
    return MOMENTUM * old + (1.0 - MOMENTUM) * batch.detach()


class BatchNorm(nn.BatchNorm2d):
    """Flax ``BatchNorm`` (eps 1e-5, momentum 0.99 = torch 0.01).

    At inference a bf16 activation with the f32 statistics normalizes in
    f32 and rounds once to bf16, as Flax's promotion does, without an f32
    copy of the activation. In train mode it normalizes with the batch's
    statistics (``batch_norm_train``) and blends the batch's biased
    variance into ``running_var``; ``F.batch_norm(training=True)`` would
    blend the unbiased one."""

    def __init__(self, c):
        super().__init__(c, eps=1e-5, momentum=0.01)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y, mu, var = batch_norm_train(x, self.weight, self.bias, self.eps,
                                      (0, 2, 3), current_bn_group())
        with torch.no_grad():
            self.running_mean.copy_(running_update(self.running_mean, mu))
            self.running_var.copy_(running_update(self.running_var, var))
        return y


def max_pool_same(x):
    """3x3 stride-2 max-pool with TF/Flax SAME padding, whose total pad
    max((ceil(H/2)-1)*2 + 3 - H, 0) puts the smaller half before: 1 and 1
    on odd sizes, but 0 before and 1 after on even sizes, which
    ``padding=1`` gets wrong. ``ceil_mode`` supplies the one trailing
    (ignored) position, so no padded copy is made."""
    h, w = x.shape[-2:]
    return F.max_pool2d(x, 3, 2, padding=(h % 2, w % 2), ceil_mode=True)


class SeparableConv(nn.Module):
    """Depthwise 3x3 + pointwise 1x1, no bias (Keras SeparableConv2D)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.depthwise = Conv(cin, cin, 3, padding=1, groups=cin)
        self.pointwise = Conv(cin, features, 1)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class XceptionBlock(nn.Module):
    """Residual block of separable convs, optional strided maxpool exit."""

    def __init__(self, cin: int, features: Sequence[int], strides: int = 2,
                 relu_first: bool = True):
        super().__init__()
        self.strides = strides          # 1 or 2 (the pool is stride 2)
        self.relu_first = relu_first
        self.has_res = strides != 1 or cin != features[-1]
        if self.has_res:
            # 1x1 stride-2 SAME pads nothing at any size.
            self.res_conv = Conv(cin, features[-1], 1, stride=strides)
            self.res_bn = BatchNorm(features[-1])
        c = cin
        for i, feat in enumerate(features):
            setattr(self, f"sep{i}", SeparableConv(c, feat))
            setattr(self, f"bn{i}", BatchNorm(feat))
            c = feat
        self.n = len(features)

    def forward(self, x):
        residual = self.res_bn(self.res_conv(x)) if self.has_res else x
        h = x
        for i in range(self.n):
            if i > 0 or self.relu_first:
                h = F.relu(h)
            h = getattr(self, f"bn{i}")(getattr(self, f"sep{i}")(h))
        if self.strides != 1:
            h = max_pool_same(h)
        return h + residual


class XceptionBackbone(nn.Module):
    """Convolutional trunk -> pooled f32 feature vector."""

    def __init__(self, arch: str = "xception",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.arch = arch
        self.compute_dtype = compute_dtype
        cfg = ARCHS[arch]
        c0, c1 = cfg["entry_convs"]
        self.conv1 = Conv(3, c0, 3, stride=2)        # VALID, as Keras
        self.conv1_bn = BatchNorm(c0)
        self.conv2 = Conv(c0, c1, 3)                 # VALID
        self.conv2_bn = BatchNorm(c1)
        c = c1
        for i, feat in enumerate(cfg["entry_blocks"]):
            setattr(self, f"entry{i}",
                    XceptionBlock(c, (feat, feat), 2, relu_first=(i != 0)))
            c = feat
        w = cfg["middle_width"]
        for i in range(cfg["middle_repeats"]):
            setattr(self, f"middle{i}", XceptionBlock(c, (w, w, w), 1))
            c = w
        self.exit_block = XceptionBlock(c, cfg["exit_block"], 2)
        c = cfg["exit_block"][-1]
        for i, feat in enumerate(cfg["exit_convs"]):
            setattr(self, f"exit_sep{i}", SeparableConv(c, feat))
            setattr(self, f"exit_bn{i}", BatchNorm(feat))
            c = feat
        self.cfg = cfg

    # Each stage takes and returns NCHW (channels-last) tensors.
    def stem(self, x):
        x = x.to(self.compute_dtype)
        x = F.relu(self.conv1_bn(self.conv1(x)))
        return F.relu(self.conv2_bn(self.conv2(x)))

    def entry(self, x):
        x = self.stem(x)
        for i in range(len(self.cfg["entry_blocks"])):
            x = getattr(self, f"entry{i}")(x)
        return x

    def middle(self, x):
        x = x.to(self.compute_dtype)
        for i in range(self.cfg["middle_repeats"]):
            x = getattr(self, f"middle{i}")(x)
        return x

    def exit_tail(self, x):
        x = x.to(self.compute_dtype)
        for i in range(len(self.cfg["exit_convs"])):
            x = getattr(self, f"exit_sep{i}")(x)
            x = F.relu(getattr(self, f"exit_bn{i}")(x))
        # Flax means in f32 and rounds to the compute dtype before .f32.
        return x.float().mean(dim=(2, 3)).to(x.dtype).float()

    def exit(self, x):
        return self.exit_tail(self.exit_block(x.to(self.compute_dtype)))

    def forward(self, x):
        return self.exit(self.middle(self.entry(x)))


class Head(nn.Module):
    """Hidden head: N x Linear(width)+ReLU+Dropout, then a linear
    classifier, in f32. All the model's dropout lives here."""

    def __init__(self, feature_dim: int, num_classes: int = 2,
                 hidden_layers: int = 2, hidden_width: int = 1024,
                 dropout: float = 0.1):
        super().__init__()
        self.hidden_layers = hidden_layers
        self.dropout = dropout
        c = feature_dim
        for i in range(hidden_layers):
            setattr(self, f"hidden{i}", nn.Linear(c, hidden_width))
            c = hidden_width
        self.logits = nn.Linear(c, num_classes)

    def forward(self, feats, mc_dropout: bool = False, generator=None,
                rows: Optional[Tuple[int, int]] = None):
        """``mc_dropout``, or train mode, samples inverted dropout (keep
        with 1-rate, divide by 1-rate, as Flax ``Dropout``) from
        ``generator``. ``rows`` (start, total): the masks are drawn for a
        batch of ``total`` rows, of which these features are the rows
        from ``start`` (a rank's share of a group's batch)."""
        h = feats.float()
        keep = 1.0 - self.dropout
        use_dropout = mc_dropout or self.training
        start, total = rows if rows is not None else (0, h.shape[0])
        for i in range(self.hidden_layers):
            h = F.relu(getattr(self, f"hidden{i}")(h))
            if use_dropout and self.dropout > 0:
                u = torch.rand((total,) + h.shape[1:], generator=generator,
                               device=h.device)[start:start + h.shape[0]]
                h = torch.where(u < keep, h / keep, torch.zeros_like(h))
        return self.logits(h)


class XceptionClassifier(nn.Module):
    """Backbone + head, with the Flax model's stage seams as methods."""

    def __init__(self, arch: str = "xception", num_classes: int = 2,
                 hidden_layers: int = 2, hidden_width: int = 1024,
                 dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        from .resnet import RESNET_ARCHS, ResNetBackbone
        from .vit import VIT_ARCHS, ViTBackbone

        if arch in ARCHS:
            backbone = XceptionBackbone(arch, compute_dtype)
        elif arch in RESNET_ARCHS:
            backbone = ResNetBackbone(arch, compute_dtype)
        elif arch in VIT_ARCHS:
            backbone = ViTBackbone(arch, compute_dtype)
        else:
            raise ValueError(f"Unknown architecture {arch!r}; the port has "
                             f"{available_models()}")
        self.arch = arch
        self.num_classes = num_classes
        self.hidden_layers = hidden_layers
        self.hidden_width = hidden_width
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.backbone = backbone
        self.head = Head(_feature_width(arch), num_classes, hidden_layers,
                         hidden_width, dropout)

    def forward(self, x, mc_dropout: bool = False, generator=None,
                rows: Optional[Tuple[int, int]] = None):
        return self.head(self.features(x), mc_dropout, generator, rows)

    def features(self, x):
        """Deterministic pooled f32 features of NHWC tiles."""
        return self.backbone(_nchw(x))

    # The stage seams below are the Xception trunk's (its fused kernels'
    # composition points); a ResNet or ViT backbone has none of them.
    def trunk_stem(self, x):
        """Entry convs only: tiles -> first entry-block input (NHWC)."""
        return _nhwc(self.backbone.stem(_nchw(x)))

    def trunk_entry(self, x):
        """Entry flow: tiles -> middle-flow input (NHWC)."""
        return _nhwc(self.backbone.entry(_nchw(x)))

    def trunk_middle(self, x):
        """Middle flow with library convs (NHWC -> NHWC)."""
        return _nhwc(self.backbone.middle(_nchw(x)))

    def trunk_exit(self, x):
        """Exit flow: middle-flow output -> pooled features."""
        return self.backbone.exit(_nchw(x))

    def trunk_exit_tail(self, x):
        """Exit sepconvs + pool: exit-block output -> pooled features."""
        return self.backbone.exit_tail(_nchw(x))

    def head_logits(self, feats, mc_dropout: bool = False, generator=None):
        """Head-only forward over precomputed features."""
        return self.head(feats, mc_dropout, generator)


def available_models():
    """All registered backbone names (the hp.model selection surface)."""
    from .resnet import RESNET_ARCHS
    from .vit import VIT_ARCHS

    return sorted(ARCHS) + sorted(RESNET_ARCHS) + sorted(VIT_ARCHS)


def _feature_width(arch: str) -> int:
    if arch in ARCHS:
        return ARCHS[arch]["exit_convs"][-1]
    from .vit import VIT_ARCHS

    if arch in VIT_ARCHS:
        return VIT_ARCHS[arch]["width"]
    from .resnet import resnet_feature_dim

    return resnet_feature_dim(arch)


def build_model(hp) -> XceptionClassifier:
    """Model factory from a ModelParams: ``hp.model`` selects the backbone,
    and an unknown name falls back to the published 'xception' with a
    warning, as in the JAX package."""
    if hp.model in available_models():
        arch = hp.model
    else:
        from ..utils_log import log

        log.warning(
            f"Unknown model {hp.model!r}; falling back to 'xception'. "
            f"Registered backbones: {available_models()}"
        )
        arch = "xception"
    return XceptionClassifier(
        arch=arch,
        num_classes=2,
        hidden_layers=hp.hidden_layers,
        hidden_width=hp.hidden_layer_width,
        dropout=hp.dropout,
        compute_dtype=torch.bfloat16 if hp.compute_dtype == "bfloat16"
        else torch.float32,
    )


def feature_dim(hp) -> int:
    """Penultimate (backbone) feature width for the configured arch (the
    fallback's, 'xception', for an unknown name)."""
    return _feature_width(hp.model if hp.model in available_models()
                          else "xception")

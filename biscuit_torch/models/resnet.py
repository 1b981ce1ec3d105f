"""ResNet-v1.5 backbones as torch ``nn.Module``s.

Counterpart of ``biscuit_tpu/models/resnet.py``: the ResNet-50/18 family
that ``hp.model`` selects beside the published Xception, with the same
pooled-features contract, so the MC-dropout head (and its kernel, where
its shape fits) serves every backbone. The module names are the Flax
ones (``stem``, ``stem_bn``, ``stage{s}_block{b}.conv1/bn1/.../proj/
proj_bn``), so ``models/convert.from_flax`` carries a Flax ResNet tree
across unchanged.

Numerics follow the port's Xception (``models/xception.py``): convs in
the compute dtype with f32 weights cast at the call, Flax BatchNorm, the
pool rounded to the compute dtype before the f32 features. Padding is
Flax's ``SAME``, computed per conv from its input size: it puts the
smaller half of an odd total pad before, so a 3x3 stride-2 conv on an
even size pads 0 before and 1 after (ResNet-50 at 299 px: stage 2's
38 -> 19), which a fixed ``padding=1`` gets wrong. The stem's max-pool is
``max_pool_same``. The last BatchNorm of each block starts at scale 0
(``train/trainer.init_model``), as Flax's ``scale_init=zeros``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .xception import BatchNorm, Conv, max_pool_same

# name -> (block type, stage repeats, stem width)
RESNET_ARCHS = {
    "resnet50": ("bottleneck", (3, 4, 6, 3), 64),
    "resnet18": ("basic", (2, 2, 2, 2), 64),
    # Reduced preset for CPU tests.
    "resnet_tiny": ("basic", (1, 1, 1, 1), 8),
}


def same_pads(size: int, k: int, stride: int):
    """Flax/TF ``SAME`` padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class SameConv(Conv):
    """Bias-free conv with Flax ``SAME`` padding worked out from the input
    size: symmetric pads go to the conv, an asymmetric one to ``F.pad``."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__(cin, cout, k, stride=stride)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        (t, b), (lft, r) = (same_pads(n, k, s) for n in x.shape[-2:])
        if t == b and lft == r:
            return F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                            (t, lft))
        return F.conv2d(F.pad(x, (lft, r, t, b)), self.weight.to(x.dtype),
                        None, self.stride)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (v1.5: the stride here) -> 1x1 (x4), with a projection
    shortcut where the shape changes."""

    def __init__(self, cin: int, features: int, strides: int = 1):
        super().__init__()
        self.needs_proj = strides != 1 or cin != features * 4
        if self.needs_proj:
            self.proj = SameConv(cin, features * 4, 1, strides)
            self.proj_bn = BatchNorm(features * 4)
        self.conv1 = SameConv(cin, features, 1)
        self.bn1 = BatchNorm(features)
        self.conv2 = SameConv(features, features, 3, strides)
        self.bn2 = BatchNorm(features)
        self.conv3 = SameConv(features, features * 4, 1)
        self.bn3 = BatchNorm(features * 4)

    @property
    def last_bn(self):
        return self.bn3

    def forward(self, x):
        residual = self.proj_bn(self.proj(x)) if self.needs_proj else x
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        return F.relu(self.bn3(self.conv3(h)) + residual)


class BasicBlock(nn.Module):
    """3x3 (strided) -> 3x3, with a projection shortcut where the shape
    changes."""

    def __init__(self, cin: int, features: int, strides: int = 1):
        super().__init__()
        self.needs_proj = strides != 1 or cin != features
        if self.needs_proj:
            self.proj = SameConv(cin, features, 1, strides)
            self.proj_bn = BatchNorm(features)
        self.conv1 = SameConv(cin, features, 3, strides)
        self.bn1 = BatchNorm(features)
        self.conv2 = SameConv(features, features, 3)
        self.bn2 = BatchNorm(features)

    @property
    def last_bn(self):
        return self.bn2

    def forward(self, x):
        residual = self.proj_bn(self.proj(x)) if self.needs_proj else x
        h = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(h)) + residual)


class ResNetBackbone(nn.Module):
    """Stem + 4 stages + global average pool -> f32 features. Takes and
    returns NCHW views of NHWC tensors, as ``XceptionBackbone``."""

    def __init__(self, arch: str = "resnet50",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.arch = arch
        self.compute_dtype = compute_dtype
        block_kind, repeats, stem = RESNET_ARCHS[arch]
        block_cls = (BottleneckBlock if block_kind == "bottleneck"
                     else BasicBlock)
        mult = 4 if block_kind == "bottleneck" else 1
        self.stem = SameConv(3, stem, 7, 2)
        self.stem_bn = BatchNorm(stem)
        self.blocks = []
        c = stem
        for stage, n_blocks in enumerate(repeats):
            feats = stem * (2 ** stage)
            for b in range(n_blocks):
                name = f"stage{stage}_block{b}"
                setattr(self, name, block_cls(
                    c, feats, 2 if (b == 0 and stage > 0) else 1))
                self.blocks.append(name)
                c = feats * mult

    def forward(self, x):
        x = x.to(self.compute_dtype)
        x = max_pool_same(F.relu(self.stem_bn(self.stem(x))))
        for name in self.blocks:
            x = getattr(self, name)(x)
        # Flax means in f32 and rounds to the compute dtype before .f32.
        return x.float().mean(dim=(2, 3)).to(x.dtype).float()


def resnet_feature_dim(arch: str) -> int:
    block_kind, repeats, stem = RESNET_ARCHS[arch]
    mult = 4 if block_kind == "bottleneck" else 1
    return stem * (2 ** (len(repeats) - 1)) * mult

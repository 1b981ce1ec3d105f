"""Analytic FLOPs model for the Xception and ViT tile classifiers, and the
H100's published peaks that a kernel's bound is computed from.

The port's copy of ``biscuit_tpu/models/flops.py``. Counts 2*MACs for
convs/matmuls, walking the same ARCHS config the model is built from
(models/xception.py ARCHS; Chollet 2017 arch), and for a ViT
(models/vit.py VIT_ARCHS) the patch conv, every Linear and the two
attention products.

Spatial sizes follow SAME padding (out = ceil(in / stride)) everywhere
except the two stem convs, which are VALID to match keras.applications
Xception exactly (models/xception.py conv1/conv2).
"""

from __future__ import annotations

import math

from .vit import VIT_ARCHS
from .xception import ARCHS, _feature_width


def _conv(h, w, cin, cout, k=3, stride=1, groups=1, padding="SAME"):
    if padding == "VALID":
        ho, wo = (h - k) // stride + 1, (w - k) // stride + 1
    else:
        ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    return 2 * ho * wo * cout * (k * k * cin // groups), ho, wo


def vit_trunk_flops(arch: str = "uni2_h", tile_px: int = 224) -> int:
    """Forward FLOPs of one ViT pass: the patch conv, per block the qkv,
    proj, fc1 and fc2 Linears over every token and Q K^T and A V
    (LayerNorm, softmax, the gate and LayerScale omitted, as
    bandwidth-bound)."""
    cfg = VIT_ARCHS[arch]
    d, p = cfg["width"], cfg["patch"]
    patches = (tile_px // p) ** 2
    t = 1 + cfg["reg_tokens"] + patches
    f = 2 * patches * d * 3 * p * p
    per_block = 2 * t * d * (3 * d + d + cfg["mlp_hidden"]
                             + cfg["mlp_hidden"] // 2)
    per_block += 2 * 2 * t * t * d          # Q K^T and A V, every head
    return f + cfg["depth"] * per_block


def trunk_flops(arch: str = "xception", tile_px: int = 299) -> int:
    """Forward FLOPs of one backbone pass (conv + sepconv + residual convs;
    BN/ReLU/pool omitted — they are bandwidth-, not FLOP-bound); a ViT's
    by ``vit_trunk_flops``."""
    if arch in VIT_ARCHS:
        return vit_trunk_flops(arch, tile_px)
    cfg = ARCHS[arch]
    f = 0
    h = w = tile_px
    # Entry convs: stride-2 then stride-1 (VALID, Keras-exact stem).
    c_in = 3
    for i, c_out in enumerate(cfg["entry_convs"]):
        df, h, w = _conv(h, w, c_in, c_out, k=3, stride=2 if i == 0 else 1,
                         padding="VALID")
        f += df
        c_in = c_out

    def sepconv(h, w, cin, cout):
        dw, _, _ = _conv(h, w, cin, cin, k=3, groups=cin)
        pw, _, _ = _conv(h, w, cin, cout, k=1)
        return dw + pw

    # Entry blocks: two sepconvs at incoming resolution, then stride-2
    # maxpool; the residual 1x1 conv runs at the pooled resolution's MACs
    # (stride-2 1x1).
    for c_out in cfg["entry_blocks"]:
        f += sepconv(h, w, c_in, c_out) + sepconv(h, w, c_out, c_out)
        rf, h, w = _conv(h, w, c_in, c_out, k=1, stride=2)
        f += rf
        c_in = c_out

    # Middle flow: 3 sepconvs per repeat at constant width/resolution.
    wmid = cfg["middle_width"]
    for _ in range(cfg["middle_repeats"]):
        f += 3 * sepconv(h, w, wmid, wmid)

    # Exit block: sepconv(c_in->a), sepconv(a->b), strided residual.
    a, b = cfg["exit_block"]
    f += sepconv(h, w, c_in, a) + sepconv(h, w, a, b)
    rf, h, w = _conv(h, w, c_in, b, k=1, stride=2)
    f += rf
    c_in = b

    # Exit sepconvs at pooled resolution.
    for c_out in cfg["exit_convs"]:
        f += sepconv(h, w, c_in, c_out)
        c_in = c_out
    return f


def head_flops(feature_dim: int = 2048, hidden: int = 1024,
               hidden_layers: int = 2, num_classes: int = 2) -> int:
    """One stochastic head pass (the K=30 MC-dropout unit)."""
    f = 2 * feature_dim * hidden
    f += 2 * hidden * hidden * (hidden_layers - 1)
    f += 2 * hidden * num_classes
    return f


def uq_flops_per_tile(arch: str = "xception", tile_px: int = 299,
                      k: int = 30) -> int:
    """Fast MC-dropout inference: one trunk pass + K head passes
    (train/uq.py's trunk-once decomposition)."""
    return trunk_flops(arch, tile_px) + k * head_flops(
        feature_dim=_feature_width(arch)
    )


def train_flops_per_tile(arch: str = "xception", tile_px: int = 299,
                         hidden: int = 1024, hidden_layers: int = 2,
                         num_classes: int = 2) -> int:
    """One training step's FLOPs per tile: the forward of the trunk and
    the head once, and the backward at twice the forward (a data gradient
    and a weight gradient of every conv and matmul)."""
    fwd = trunk_flops(arch, tile_px) + head_flops(
        _feature_width(arch), hidden, hidden_layers, num_classes)
    return 3 * fwd


# Published dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
# data sheet): tensor-core bf16, CUDA-core f32, and HBM3 bandwidth. A card
# set to a lower power limit runs below them.
H100_PEAK_BF16 = 989e12
H100_PEAK_F32 = 67e12
H100_HBM_BYTES_PER_S = 3.35e12

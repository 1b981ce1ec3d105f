"""Vision Transformer trunks as torch ``nn.Module``s: UNI2-h's ViT-H/14
(MahmoodLab/UNI2-h; Chen et al., Nature Medicine 2024) behind the
MC-dropout head, registered in ``hp.model`` beside the Xception and
ResNet families. The JAX package has no such trunk.

The layer equations are those of ``timm``'s ``VisionTransformer`` with the
model card's arguments: a patch conv with bias; a position embedding added
to the patch tokens alone (``no_embed_class``); the class token and the
register tokens in front, in that order; pre-norm blocks ``x + ls1 *
proj(attn(norm1(x)))`` and ``x + ls2 * fc2(silu(a) * b)`` with ``[a, b] =
fc1(norm2(x))`` (the packed SwiGLU, the gate on the first half); a final
LayerNorm and the class token as the feature. Parameter names:
``patch``, ``cls_token``, ``reg_token``, ``pos_embed``, ``block{i}.{norm1,
qkv, proj, ls1, norm2, fc1, fc2, ls2}``, ``norm``; the token tables keep
timm's shapes.

Numerics are those of timm under bf16 autocast: the patch conv, every
Linear and the attention run in ``compute_dtype`` with the f32 parameters
cast at the call; LayerNorm normalizes the f32 stream in f32; the f32
position embedding and LayerScale keep the residual stream in f32; the
features are f32.

Attention and the MLP are the module-level functions ``attention`` and
``swiglu_mlp``, called through this module's globals, so that a caller can
wrap them (the benchmark counts their calls). On the card ``attention``
runs one fused kernel alone, ``ATTENTION_BACKEND`` (f32: the
memory-efficient one): ``scaled_dot_product_attention`` raises where that
kernel cannot run, and never falls back to the math path. Each
call counts one ``vit.attention.<backend>`` (``tracing``). Spans of a
forward: ``vit.embed``, per block ``vit.attention`` and ``vit.mlp`` (each
from its LayerNorm to its residual add), ``vit.norm``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from .. import tracing
from ..tracing import span

# name -> architecture (UNI2-h: the model card's timm_kwargs).
VIT_ARCHS = {
    "uni2_h": {"img_size": 224, "patch": 14, "width": 1536, "depth": 24,
               "heads": 24, "mlp_hidden": 8192, "reg_tokens": 8,
               "norm_eps": 1e-6},
    # Reduced preset for CPU tests: every mechanism, tiny widths.
    "vit_tiny": {"img_size": 32, "patch": 8, "width": 32, "depth": 2,
                 "heads": 2, "mlp_hidden": 96, "reg_tokens": 2,
                 "norm_eps": 1e-6},
}
INIT_VALUES = 1e-5          # LayerScale's initial value (init_values)
# The fused kernel attention runs on the card: cuDNN's, 0.69-0.72 ms a call
# against flash's 0.96-0.97 at 256 tiles of 265 tokens, 24 heads of 64, on
# the H100 (PERF.md).
ATTENTION_BACKEND = SDPBackend.CUDNN_ATTENTION
COUNTER = "vit.attention."


def attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v over (B, H, T, d) in the inputs' dtype:
    on the card by ``ATTENTION_BACKEND`` alone (f32, which it does not
    take, by the memory-efficient kernel), on the CPU by the math path.
    Counts the call under ``vit.attention.<backend>``."""
    if not q.is_cuda:
        backend = SDPBackend.MATH
    elif q.dtype == torch.float32:
        backend = SDPBackend.EFFICIENT_ATTENTION
    else:
        backend = ATTENTION_BACKEND
    with sdpa_kernel(backend):
        out = F.scaled_dot_product_attention(q, k, v)
    tracing.count(COUNTER + backend.name.lower())
    return out


def swiglu_mlp(x, fc1_w, fc1_b, fc2_w, fc2_b):
    """timm's ``SwiGLUPacked``: ``fc2(silu(a) * b)``, where ``a`` is the
    first half of ``fc1(x)``'s columns and ``b`` the second."""
    a, b = F.linear(x, fc1_w, fc1_b).chunk(2, dim=-1)
    return F.linear(F.silu(a) * b, fc2_w, fc2_b)


def attention_counts() -> dict:
    """Attention calls by the backend that ran them, since the last
    ``reset_attention_counts``."""
    return {name[len(COUNTER):]: n for name, n in tracing.counts().items()
            if name.startswith(COUNTER)}


def reset_attention_counts() -> None:
    tracing.reset_counts(COUNTER)


class LayerScale(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((width,), INIT_VALUES))


def _linear(x, layer):
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class ViTBlock(nn.Module):
    """One pre-norm block over the f32 residual stream (B, T, D)."""

    def __init__(self, width: int, heads: int, mlp_hidden: int, eps: float):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(width, eps=eps)
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)
        self.ls1 = LayerScale(width)
        self.norm2 = nn.LayerNorm(width, eps=eps)
        self.fc1 = nn.Linear(width, mlp_hidden)
        self.fc2 = nn.Linear(mlp_hidden // 2, width)
        self.ls2 = LayerScale(width)

    def forward(self, x, dtype):
        b, t, d = x.shape
        with span("vit.attention"):
            y = self.norm1(x).to(dtype)
            q, k, v = _linear(y, self.qkv).view(
                b, t, 3, self.heads, d // self.heads).permute(
                2, 0, 3, 1, 4).unbind(0)
            o = attention(q, k, v).transpose(1, 2).reshape(b, t, d)
            x = torch.addcmul(x, _linear(o, self.proj), self.ls1.gamma)
        with span("vit.mlp"):
            y = self.norm2(x).to(dtype)
            o = swiglu_mlp(y, self.fc1.weight.to(dtype),
                           self.fc1.bias.to(dtype), self.fc2.weight.to(dtype),
                           self.fc2.bias.to(dtype))
            return torch.addcmul(x, o, self.ls2.gamma)


class ViTBackbone(nn.Module):
    """Patch embedding, prefix tokens, blocks, final LayerNorm -> the
    class token's f32 features. Takes the NCHW view of NHWC tiles of
    ``img_size`` pixels, as the other backbones do."""

    def __init__(self, arch: str = "uni2_h",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        a = VIT_ARCHS[arch]
        self.arch = arch
        self.compute_dtype = compute_dtype
        self.cfg = a
        d, p = a["width"], a["patch"]
        grid = a["img_size"] // p
        self.patch = nn.Conv2d(3, d, p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.reg_token = nn.Parameter(torch.zeros(1, a["reg_tokens"], d))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid, d))
        for i in range(a["depth"]):
            setattr(self, f"block{i}", ViTBlock(d, a["heads"],
                                                a["mlp_hidden"],
                                                a["norm_eps"]))
        self.norm = nn.LayerNorm(d, eps=a["norm_eps"])
        with torch.no_grad():       # timm's initial draws
            nn.init.trunc_normal_(self.pos_embed, std=0.02)
            nn.init.normal_(self.cls_token, std=1e-6)
            nn.init.normal_(self.reg_token, std=1e-6)

    def embed(self, x):
        """(B, 3, S, S) tiles -> the f32 token sequence [cls, reg, patches]
        with the position embedding on the patches."""
        size = self.cfg["img_size"]
        if tuple(x.shape[-2:]) != (size, size):
            raise ValueError(f"{self.arch} takes {size}-px tiles (its "
                             f"position embedding's grid), not "
                             f"{tuple(x.shape[-2:])}")
        dt = self.compute_dtype
        h = F.conv2d(x.to(dt), self.patch.weight.to(dt),
                     self.patch.bias.to(dt), stride=self.patch.stride)
        h = h.flatten(2).transpose(1, 2).float() + self.pos_embed
        prefix = torch.cat([self.cls_token, self.reg_token], dim=1)
        return torch.cat([prefix.expand(h.shape[0], -1, -1), h], dim=1)

    def forward(self, x):
        with span("vit.embed"):
            x = self.embed(x)
        for i in range(self.cfg["depth"]):
            x = getattr(self, f"block{i}")(x, self.compute_dtype)
        with span("vit.norm"):
            # The final LayerNorm is per token: the class token's alone.
            return self.norm(x[:, 0])

"""Vision Transformer, as UNI2-h's model card gives it to ``timm``'s
``VisionTransformer`` (MahmoodLab/UNI2-h; Chen et al., Nature Medicine
2024): a patch conv with bias, the position embedding added to the patch
tokens alone (``no_embed_class``), ``[cls, reg..., patches]``, pre-norm
blocks with LayerScale on both branches, multi-head attention written out
as ``softmax(q k^T / sqrt(d)) v``, the packed SwiGLU MLP (``fc1`` to twice
the gated width, ``silu`` of its first half times its second, ``fc2``), a
final LayerNorm and the class token as the feature. No BatchNorm: ``bn``
is never called. Parameters under the port's ``state_dict`` names."""

import torch
import torch.nn.functional as F

from ..nets import conv, dense

# The roles this family adds to the weight maker's table: (draw, scale,
# shift, fan-in scaled). LayerNorm as the BatchNorm scale and shift are
# drawn. The token tables and the position embedding at unit scale, as
# the patch tokens come out of the LeCun patch conv, so that each of
# them moves the class token (timm starts them at 1e-6 and 0.02).
# LayerScale U(0.5, 1.5), not UNI's initial 1e-5: at that scale a block
# left out or computed wrongly would not move the features at all; at
# this one each of the 48 branches moves them by 14% or more.
ROLES = {"ln_weight": ("uniform", 0.4, 0.8, False),
         "ln_bias": ("gauss", 0.05, 0.0, False),
         "layer_scale": ("uniform", 1.0, 0.5, False),
         "pos_embed": ("gauss", 1.0, 0.0, False),
         "cls_token": ("gauss", 1.0, 0.0, False),
         "reg_token": ("gauss", 1.0, 0.0, False)}


def _ln(out, name, d):
    out += [(f"{name}.weight", (d,), "ln_weight"),
            (f"{name}.bias", (d,), "ln_bias")]


def param_specs(arch: dict):
    d, k = arch["width"], arch["patch"]
    grid = arch["img_size"] // k
    hidden = arch["mlp_hidden"]
    out = [("backbone.cls_token", (1, 1, d), "cls_token"),
           ("backbone.reg_token", (1, arch["reg_tokens"], d), "reg_token"),
           ("backbone.pos_embed", (1, grid * grid, d), "pos_embed"),
           ("backbone.patch.weight", (d, 3, k, k), "conv"),
           ("backbone.patch.bias", (d,), "bias")]
    for i in range(arch["depth"]):
        pre = f"backbone.block{i}"
        _ln(out, f"{pre}.norm1", d)
        out += [(f"{pre}.qkv.weight", (3 * d, d), "dense"),
                (f"{pre}.qkv.bias", (3 * d,), "bias"),
                (f"{pre}.proj.weight", (d, d), "dense"),
                (f"{pre}.proj.bias", (d,), "bias"),
                (f"{pre}.ls1.gamma", (d,), "layer_scale")]
        _ln(out, f"{pre}.norm2", d)
        out += [(f"{pre}.fc1.weight", (hidden, d), "dense"),
                (f"{pre}.fc1.bias", (hidden,), "bias"),
                (f"{pre}.fc2.weight", (d, hidden // 2), "dense"),
                (f"{pre}.fc2.bias", (d,), "bias"),
                (f"{pre}.ls2.gamma", (d,), "layer_scale")]
    _ln(out, "backbone.norm", d)
    return out, d


def _layer_norm(x, p, name, arch):
    return F.layer_norm(x, (arch["width"],), p[f"{name}.weight"],
                        p[f"{name}.bias"], arch["norm_eps"])


def _attention(y, p, pre, arch, q):
    b, t, d = y.shape
    heads = arch["heads"]
    qkv = dense(y, p, f"{pre}.qkv", q).view(b, t, 3, heads, d // heads)
    qh, kh, vh = qkv.permute(2, 0, 3, 1, 4)
    scores = q(qh) @ q(kh).transpose(-1, -2) * (d // heads) ** -0.5
    o = q(torch.softmax(scores, dim=-1)) @ q(vh)
    return dense(o.transpose(1, 2).reshape(b, t, d), p, f"{pre}.proj", q)


def _mlp(y, p, pre, q):
    a, g = dense(y, p, f"{pre}.fc1", q).chunk(2, dim=-1)
    return dense(F.silu(a) * g, p, f"{pre}.fc2", q)


def features(x, p, arch, bn, q):
    h = conv(x, p["backbone.patch.weight"], arch["patch"], "VALID", q)
    h = h + p["backbone.patch.bias"][:, None, None]
    h = h.flatten(2).transpose(1, 2) + p["backbone.pos_embed"]
    prefix = torch.cat([p["backbone.cls_token"], p["backbone.reg_token"]],
                       dim=1)
    x = torch.cat([prefix.expand(h.shape[0], -1, -1), h], dim=1)
    for i in range(arch["depth"]):
        pre = f"backbone.block{i}"
        x = x + p[f"{pre}.ls1.gamma"] * _attention(
            _layer_norm(x, p, f"{pre}.norm1", arch), p, pre, arch, q)
        x = x + p[f"{pre}.ls2.gamma"] * _mlp(
            _layer_norm(x, p, f"{pre}.norm2", arch), p, pre, q)
    return _layer_norm(x[:, 0], p, "backbone.norm", arch)


def port_arch(model_name: str, port) -> dict:
    return {"family": "vit", **port("models.vit").VIT_ARCHS[model_name],
            "layer_scale": True, "pool": "token"}

"""ResNet-v1.5 (He et al. 2016): the stride on each stage's first 3x3,
SAME padding as Flax pads it, bottleneck or basic blocks; its parameters
under the Flax stage names that the port's ``state_dict`` and the JAX
package share."""

import torch

from ..nets import conv, max_pool_same
from ..params import bn_leaves


def resnet_blocks(arch: dict):
    """(module name, cin, features, strides) of every block, in order."""
    mult = 4 if arch["block"] == "bottleneck" else 1
    blocks = []
    c = arch["stem"]
    for stage, n in enumerate(arch["repeats"]):
        feats = arch["stem"] * 2 ** stage
        for b in range(n):
            blocks.append((f"stage{stage}_block{b}", c, feats,
                           2 if (b == 0 and stage > 0) else 1))
            c = feats * mult
    return blocks, c


def param_specs(arch: dict):
    out = []
    stem = arch["stem"]
    out.append(("backbone.stem.weight", (stem, 3, 7, 7), "conv"))
    bn_leaves(out, "backbone.stem_bn", stem)
    bottleneck = arch["block"] == "bottleneck"
    mult = 4 if bottleneck else 1
    blocks, c_out = resnet_blocks(arch)
    for name, cin, f, s in blocks:
        pre = f"backbone.{name}"
        if s != 1 or cin != f * mult:
            out.append((f"{pre}.proj.weight", (f * mult, cin, 1, 1), "conv"))
            bn_leaves(out, f"{pre}.proj_bn", f * mult)
        if bottleneck:
            convs = [(cin, f, 1), (f, f, 3), (f, 4 * f, 1)]
        else:
            convs = [(cin, f, 3), (f, f, 3)]
        for i, (a, b, k) in enumerate(convs, 1):
            out.append((f"{pre}.conv{i}.weight", (b, a, k, k), "conv"))
            bn_leaves(out, f"{pre}.bn{i}", b)
    return out, c_out


def features(x, p, arch, bn, q):
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


def port_arch(model_name: str, port) -> dict:
    block, repeats, stem = port("models.resnet").RESNET_ARCHS[model_name]
    return {"family": "resnet", "block": block, "repeats": list(repeats),
            "stem": stem}

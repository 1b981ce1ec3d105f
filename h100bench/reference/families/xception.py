"""Xception (Chollet 2017), the keras.applications layout: VALID stem,
SAME elsewhere, the stride-2 SAME max-pool; its parameters under the Flax
stage names that the port's ``state_dict`` and the JAX package share."""

import torch

from ..nets import conv, max_pool_same
from ..params import bn_leaves


def _sep_specs(out, name, cin, cout):
    out += [(f"{name}.depthwise.weight", (cin, 1, 3, 3), "conv"),
            (f"{name}.pointwise.weight", (cout, cin, 1, 1), "conv")]


def xception_blocks(arch: dict):
    """(module name, cin, features, strides, relu_first) of every residual
    block of the Xception trunk, in order."""
    blocks = []
    c = arch["entry_convs"][1]
    for i, f in enumerate(arch["entry_blocks"]):
        blocks.append((f"entry{i}", c, (f, f), 2, i != 0))
        c = f
    w = arch["middle_width"]
    for i in range(arch["middle_repeats"]):
        blocks.append((f"middle{i}", c, (w, w, w), 1, True))
        c = w
    blocks.append(("exit_block", c, tuple(arch["exit_block"]), 2, True))
    return blocks


def param_specs(arch: dict):
    out = []
    c0, c1 = arch["entry_convs"]
    out.append(("backbone.conv1.weight", (c0, 3, 3, 3), "conv"))
    bn_leaves(out, "backbone.conv1_bn", c0)
    out.append(("backbone.conv2.weight", (c1, c0, 3, 3), "conv"))
    bn_leaves(out, "backbone.conv2_bn", c1)
    for name, cin, feats, strides, _ in xception_blocks(arch):
        pre = f"backbone.{name}"
        if strides != 1 or cin != feats[-1]:
            out.append((f"{pre}.res_conv.weight", (feats[-1], cin, 1, 1),
                        "conv"))
            bn_leaves(out, f"{pre}.res_bn", feats[-1])
        c = cin
        for i, f in enumerate(feats):
            _sep_specs(out, f"{pre}.sep{i}", c, f)
            bn_leaves(out, f"{pre}.bn{i}", f)
            c = f
    c = arch["exit_block"][-1]
    for i, f in enumerate(arch["exit_convs"]):
        _sep_specs(out, f"backbone.exit_sep{i}", c, f)
        bn_leaves(out, f"backbone.exit_bn{i}", f)
        c = f
    return out, c


def _sep(x, p, name, q):
    x = conv(x, p[f"{name}.depthwise.weight"], q=q, groups=x.shape[1])
    return conv(x, p[f"{name}.pointwise.weight"], q=q)


def features(x, p, arch, bn, q):
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


def port_arch(model_name: str, port) -> dict:
    table = port("models.xception").ARCHS[model_name]
    return {"family": "xception",
            **{k: list(v) if isinstance(v, tuple) else v
               for k, v in table.items()}}

"""A toy trunk family, for the benchmark's tests alone: a strided patch
conv, one LayerNorm, one dense layer with GELU and the mean over the
patches; no BatchNorm, so no running statistics. The tests write this
file as ``reference/families/toy.py`` of a directory of their own, where
the harness's family lookup finds it as it would a family added to the
benchmark; no file of the benchmark names it."""

import torch.nn.functional as F

from h100bench.reference.nets import conv, dense

EPS = 1e-6

# The roles this family adds to the weight maker's table: (draw, scale,
# shift, fan-in scaled).
ROLES = {"ln_weight": ("uniform", 0.4, 0.8, False),
         "ln_bias": ("gauss", 0.05, 0.0, False)}


def param_specs(arch: dict):
    d, f, k = arch["width"], arch["features"], arch["patch"]
    return [("backbone.patch.weight", (d, 3, k, k), "conv"),
            ("backbone.patch.bias", (d,), "bias"),
            ("backbone.norm.weight", (d,), "ln_weight"),
            ("backbone.norm.bias", (d,), "ln_bias"),
            ("backbone.proj.weight", (f, d), "dense"),
            ("backbone.proj.bias", (f,), "bias")], f


def features(x, p, arch, bn, q):
    h = conv(x, p["backbone.patch.weight"], arch["patch"], "VALID", q)
    h = (h + p["backbone.patch.bias"][:, None, None]).flatten(2)
    h = q(F.layer_norm(h.transpose(1, 2), (arch["width"],),
                       p["backbone.norm.weight"], p["backbone.norm.bias"],
                       EPS))
    h = q(F.gelu(dense(h, p, "backbone.proj", q)))
    return q(h.mean(dim=1))


def port_arch(model_name: str, port) -> dict:
    return {"family": "toy", **port("models.toy").ARCHS[model_name]}

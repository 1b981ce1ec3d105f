"""The ViT's packed SwiGLU MLP, ``biscuit_torch/models/vit.py``
``swiglu_mlp(x, fc1_w, fc1_b, fc2_w, fc2_b)``: x (B, T, D), fc1 (2G, D),
fc2 (D, G), all in bf16. Operations: the two GEMMs, 2 N (D 2G + G D) over
N = B T tokens, in bf16 (the gate left out). Bytes: x, the weights and
biases read once and the output (N, D) written once. A program with no
ViT has nothing here to count (no ``TARGET``)."""

import importlib.util

from .peaks import bound_s

if importlib.util.find_spec("biscuit_torch.models.vit") is not None:
    TARGET = ("biscuit_torch.models.vit", "swiglu_mlp")


def bound(n: int, d: int, hidden: int, elem_bytes: int = 2):
    g = hidden // 2
    n_bytes = (2 * n * d + hidden * d + g * d + hidden + d) * elem_bytes
    return bound_s(n_bytes, {"bf16": 2.0 * n * (d * hidden + g * d)})


def call_bound(args, kwargs):
    x, fc1_w = args[0], args[1]
    return bound(x.numel() // x.shape[-1], x.shape[-1], fc1_w.shape[0],
                 x.element_size())

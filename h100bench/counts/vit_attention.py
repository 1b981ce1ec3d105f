"""The ViT's attention, ``biscuit_torch/models/vit.py`` ``attention(q, k,
v)``: q, k, v (B, H, T, d) in bf16, o of the same shape out. Operations:
Q K^T and A V, 4 B H T^2 d in bf16 (the softmax left out). Bytes: q, k, v
read once and o written once. A program with no ViT has nothing here to
count (no ``TARGET``)."""

import importlib.util

from .peaks import bound_s

if importlib.util.find_spec("biscuit_torch.models.vit") is not None:
    TARGET = ("biscuit_torch.models.vit", "attention")


def bound(b: int, h: int, t: int, d: int, elem_bytes: int = 2):
    return bound_s(4 * b * h * t * d * elem_bytes,
                   {"bf16": 4.0 * b * h * t * t * d})


def call_bound(args, kwargs):
    q = args[0]
    b, h, t, d = q.shape
    return bound(b, h, t, d, q.element_size())

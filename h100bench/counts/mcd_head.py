"""Kernel row 3, ``biscuit_torch/ops/mcd_head.py``, reached through
``biscuit::mcd_head(feats, weights, seed, k, dropout)``: f32 features
(N, F), bf16 weights W1 (F, H), W2 (H, H), W3 (H, C), f32 biases, mean
and std (N, C) f32 out. Operations: the first layer once a tile, the
second and the logits K times, in bf16. The arithmetic of
``chip_smoke.py`` ``head_case``."""

from .peaks import bound_s

TARGET = ("biscuit_torch.ops.library", "mcd_head")


def bound(n: int, f: int, h: int, c: int, k: int):
    n_bytes = (n * f * 4 + (f * h + h * h + h * c) * 2 + (2 * h + c) * 4
               + 2 * n * c * 4)
    ops = 2.0 * n * (f * h + k * (h * h + h * c))
    return bound_s(n_bytes, {"bf16": ops})


def call_bound(args, kwargs):
    feats, weights, _seed, k = args[:4]
    n, f = feats.shape
    return bound(n, f, weights[0].shape[1], weights[4].shape[1], int(k))

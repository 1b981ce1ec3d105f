"""The MC head's dropout stream, Philox4x32-10 keyed by (seed & 0xFFFFFFFF,
seed >> 32) with counter (column // 4, row, pass, layer), word column % 4:
element (row, column) of hidden layer L in pass k is dropped when its
32-bit draw is below rate * 2**32. Written from the Philox4x32-10
definition (Salmon et al., SC 2011) in int64 torch ops; the stream is the
one ``biscuit_torch/csrc/mcd_head.cu`` draws, so the reference applies
the masks the served passes applied."""

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b):
    p1 = a * (b & 0xFFFF)
    p2 = a * (b >> 16)
    t = (p1 & _MASK32) + ((p2 & 0xFFFF) << 16)
    return (p1 >> 32) + (p2 >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_masks(seed: int, k: int, layer: int, rows: range, h: int,
               rate: float, device) -> torch.Tensor:
    """(K, len(rows), H) bool: True where the element is kept."""
    seed = int(seed) & ((1 << 64) - 1)
    kk = torch.arange(k, device=device).view(k, 1, 1)
    rr = torch.arange(rows.start, rows.stop, device=device).view(1, -1, 1)
    cc = torch.arange((h + 3) // 4, device=device).view(1, 1, -1)
    shape = (k, len(rows), (h + 3) // 4)
    words = philox4x32_10(cc.expand(shape), rr.expand(shape),
                          kk.expand(shape),
                          torch.full(shape, layer, dtype=torch.int64,
                                     device=device),
                          seed & _MASK32, seed >> 32)
    bits = torch.stack(words, dim=-1).reshape(k, len(rows), -1)[..., :h]
    return bits >= min(int(rate * (1 << 32)), (1 << 32) - 1)


def keep_scale(rate: float) -> float:
    return float(np.float32(1.0 / (1.0 - rate)))

"""K-pass MC-dropout head with in-kernel dropout and on-chip mean/std
(``csrc/mcd_head.cu``).

Counterpart of ``biscuit_tpu/ops/mcd_head.py``. Per pass:

    h1 = dropout(relu(feats @ W1 + b1))
    h2 = dropout(relu(h1 @ W2 + b2))
    p  = softmax(h2 @ W3 + b3)

with bf16 matmul inputs and f32 accumulation, inverted dropout scaled by
1/(1-rate) and h rounded to bf16 after the mask; out mean = sum(p)/K and
std = sqrt(max(sum(p^2)/K - mean^2, 0)).

Dropout draws are Philox4x32-10 keyed by (seed, pass, layer, row,
column), generated inside the kernel; ``philox_dropout_bits`` writes the
same stream out in int64 torch ops, so the plain version reproduces the
kernel's masks exactly. Element (row, col) of layer L in pass k is dropped
when its 32-bit draw is below rate * 2**32.

The kernel takes 0 < C <= ``MAX_CLASSES`` (128, the TPU kernel's one
lane tile): the logits are a third tensor-core product with C padded to
16, 32, 64 or 128 and the padded logits masked before the softmax. The
plain version is the same for every C.

On a CPU tensor ``mcd_head`` computes its plain version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

NAME = "mcd_head"
MAX_CLASSES = 128

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for a < 2**32 and int64 b < 2**32,
    without overflowing int64 (the product is split at 16 bits of b)."""
    p1 = a * (b & 0xFFFF)
    p2 = a * (b >> 16)
    t = (p1 & _MASK32) + ((p2 & 0xFFFF) << 16)
    return (p1 >> 32) + (p2 >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 counters; the key
    words are ints or 0-d int64 tensors."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_tensor(seed: int) -> torch.Tensor:
    """A 64-bit dropout seed as the 0-d int64 CPU tensor the registered
    head op and the exported programs take: the bit pattern, wrapped to
    signed where the top bit is set (``key_halves`` masks it back)."""
    seed = int(seed) & ((1 << 64) - 1)
    return torch.tensor(seed - (1 << 64) if seed >> 63 else seed,
                        dtype=torch.int64)


def key_halves(seed):
    """(low, high) 32-bit halves of a seed given as an int or as a 0-d
    int64 tensor holding its bit pattern (ints or 0-d tensors out)."""
    return seed & _MASK32, (seed >> 32) & _MASK32


def philox_dropout_bits(seed, k: int, layer: int, n: int, h: int,
                        device=None) -> torch.Tensor:
    """(K, N, H) int64 draws in [0, 2**32) of the kernel's dropout stream:
    counter (col // 4, row, pass, layer), key (seed & 0xFFFFFFFF, seed >>
    32), word col % 4. ``seed`` is an int or a 0-d int64 tensor
    (``seed_tensor``) on the CPU, so that an exported program takes it as
    an input."""
    dev = torch.device("cpu") if device is None else device
    kk = torch.arange(k, device=dev).view(k, 1, 1)
    rr = torch.arange(n, device=dev).view(1, n, 1)
    cc = torch.arange((h + 3) // 4, device=dev).view(1, 1, -1)
    shape = (k, n, (h + 3) // 4)
    words = philox4x32_10(cc.expand(shape), rr.expand(shape),
                          kk.expand(shape),
                          torch.full(shape, layer, dtype=torch.int64,
                                     device=dev),
                          *key_halves(seed))
    return torch.stack(words, dim=-1).reshape(k, n, -1)[..., :h]


def _threshold(dropout: float) -> int:
    return min(int(dropout * (1 << 32)), (1 << 32) - 1)


def _keep_scale(dropout: float) -> float:
    # f32(1 / (1 - rate)), the TPU kernel's weakly typed constant (numpy,
    # not a tensor, so that tracing it for an export reads no tensor).
    return float(np.float32(1.0 / (1.0 - dropout)))


def head_weights(head):
    """A two-hidden-layer ``models.xception.Head`` as the kernel takes it:
    (w1, b1, w2, b2, w3, b3), weights bf16 (in, out), biases f32."""
    if head.hidden_layers != 2:
        raise ValueError("the MC head kernel takes exactly two hidden layers")
    out = []
    for lin in (head.hidden0, head.hidden1, head.logits):
        out.append(lin.weight.detach().t().to(torch.bfloat16).contiguous())
        out.append(lin.bias.detach().float().contiguous())
    return tuple(out)


def mcd_head_reference(feats, w1, b1, w2, b2, w3, b3, k: int = 30,
                       dropout: float = 0.1, seed=0,
                       keep1=None, keep2=None):
    """Plain version. Masks: explicit boolean keep-masks ``keep1``/``keep2``
    of shape (K, N, H) when given, else the kernel's Philox stream from
    ``seed`` (an int or a 0-d int64 tensor); at dropout 0 nothing is
    dropped."""
    n = feats.shape[0]
    hdim = w1.shape[1]
    f = feats.float().to(torch.bfloat16).float()
    w1f, w2f, w3f = (w.to(torch.bfloat16).float() for w in (w1, w2, w3))
    h1 = torch.relu(f @ w1f + b1.float())
    scale = _keep_scale(dropout)
    thresh = _threshold(dropout)

    def keep(explicit, layer):
        if explicit is not None:
            return explicit.to(device=feats.device, dtype=torch.bool)
        if dropout == 0.0:
            return None
        if seed is None:
            raise ValueError("give a seed or explicit keep-masks")
        return philox_dropout_bits(seed, k, layer, n, hdim,
                                   feats.device) >= thresh

    m1, m2 = keep(keep1, 0), keep(keep2, 1)
    s = torch.zeros(n, w3.shape[1], device=feats.device)
    q = torch.zeros_like(s)
    zero = torch.zeros((), device=feats.device)
    for i in range(k):
        h = h1 * scale if m1 is None else torch.where(m1[i], h1 * scale, zero)
        h = h.to(torch.bfloat16).float()
        h = torch.relu(h @ w2f + b2.float())
        h = h * scale if m2 is None else torch.where(m2[i], h * scale, zero)
        h = h.to(torch.bfloat16).float()
        p = torch.softmax(h @ w3f + b3.float(), dim=-1)
        s = s + p
        q = q + p * p
    mean = s / k
    return mean, torch.sqrt(torch.clamp_min(q / k - mean * mean, 0.0))


_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
             + [ctypes.c_uint] * 3 + [ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p])


def mcd_head(feats, w1, b1, w2, b2, w3, b3, k: int = 30,
             dropout: float = 0.1, seed=0):
    """K-pass MC-dropout head over pooled features.

    Args:
        feats: (N, F) f32 pooled backbone features.
        w1 (F, H), w2 (H, H), w3 (H, C): bf16 weights, (in, out) layout.
        b1, b2 (H,), b3 (C,): f32 biases.
        seed: 64-bit key of the Philox dropout stream, an int or a 0-d
            int64 CPU tensor (``seed_tensor``; read on the host, which
            does not wait for the card).
    Returns:
        (mean (N, C), std (N, C)) of the softmax over k samples, f32.
    """
    if not feats.is_cuda:
        return mcd_head_reference(feats, w1, b1, w2, b2, w3, b3, k, dropout,
                                  seed)
    n, f = feats.shape
    hdim = w1.shape[1]
    c = w3.shape[1]
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout must be in [0, 1), got {dropout}")
    if f % 8 or hdim % 8 or not 0 < c <= MAX_CLASSES or k < 1:
        raise ValueError(f"need F % 8 == H % 8 == 0, 0 < C <= {MAX_CLASSES} "
                         f"and K >= 1; got F={f}, H={hdim}, C={c}, K={k}")
    want = {"feats": ((n, f), torch.float32, feats),
            "w1": ((f, hdim), torch.bfloat16, w1),
            "b1": ((hdim,), torch.float32, b1),
            "w2": ((hdim, hdim), torch.bfloat16, w2),
            "b2": ((hdim,), torch.float32, b2),
            "w3": ((hdim, c), torch.bfloat16, w3),
            "b3": ((c,), torch.float32, b3)}
    for name, (shape, dtype, t) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != feats.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {feats.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    dev = feats.device
    # Two allocations, so that neither output is a view of the other.
    mean = torch.empty((n, c), dtype=torch.float32, device=dev)
    std = torch.empty_like(mean)
    scratch = torch.empty(_build.bound(
        NAME, "mcd_head_scratch_bytes", [ctypes.c_int] * 3,
        ctypes.c_size_t)(n, hdim, c), dtype=torch.uint8, device=dev)
    rc = _build.bound(NAME, "mcd_head_launch", _ARGTYPES)(
        *(_build.ptr(x) for x in (feats, w1, b1, w2, b2, w3, b3)),
        mean.data_ptr(), std.data_ptr(), scratch.data_ptr(), n, f,
        hdim, c, k, *(int(h) for h in key_halves(seed)),
        _threshold(dropout), _keep_scale(dropout), dev.index or 0,
        _build.stream_ptr(feats))
    _build.check(rc, NAME)
    _build.count_launch(NAME)
    return mean, std

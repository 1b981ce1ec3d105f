"""Fused tile preprocessing: uint8 RGB -> reinhard_fast -> per-image
standardization in one kernel (``csrc/fused_preprocess.cu``).

Counterpart of ``biscuit_tpu/ops/fused_preprocess.py``. The kernel is CUDA
C++ rather than Triton: it splits each image over a thread-block cluster
whose CTAs hold the image's lab values in shared memory and exchange their
partial sums through distributed shared memory, which Triton has no model
for. The source note says what bounds it on the H100 and how it is laid
out; ``launch_plan`` says how one batch is launched.

On a CPU tensor ``fused_preprocess`` computes its plain version; on a CUDA
tensor it launches the kernel or raises. A call makes no host-to-device
copy and does not synchronize: the 42 coefficients are made once for each
(targets, device) and kept (``coefficients``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..data.normalize import (
    _LAB2LOGLMS,
    _LMS2RGB,
    _LOGLMS2LAB,
    _RGB2LMS,
    DEFAULT_TARGET_MEANS,
    DEFAULT_TARGET_STDS,
    per_image_standardization,
)
from . import _build

NAME = "fused_preprocess"
CLUSTERS = (1, 2, 4, 8, 16)     # cluster sizes; above 8 non-portable
SMEM_LIMIT = 232_448            # dynamic shared memory a block can use
SM_SMEM = 233_472               # shared memory of an SM
CTA_RESERVE = 1_024 + 512       # the runtime's reserve and the static arrays
# Threads a CTA: 1,024 alone on an SM (64 registers a thread), 256 where
# CTAs share one (at 299 px, clusters of 16, against 192 and 320:
# chip_smoke.py --preprocess, PERF.md).
MAX_THREADS = 1_024
SHARED_THREADS = 256
# The plan takes the smallest cluster whose CTAs fit three to an SM, else
# the smallest whose CTAs fit at all.
TARGET_SMEM = SMEM_LIMIT // 3
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def smem_bytes(chunk: int) -> int:
    """Dynamic shared memory of a CTA of ``chunk`` pixels: 12 bytes a
    pixel (f32 lab, then rgb', written over the uint8 staging), a float4
    of shift and the staging's rounding. As ``smem_bytes`` in the
    source."""
    return (12 * chunk + 32 + 15) // 16 * 16


@dataclass(frozen=True)
class Plan:
    """How one batch of ``n`` images of ``hw`` pixels launches: one
    cluster of ``cluster`` CTAs an image (``grid`` CTAs), CTA r owning
    the image's pixels ``ranges[r]``, each with ``threads`` threads and
    ``smem`` bytes of dynamic shared memory."""

    n: int
    hw: int
    cluster: int
    chunk: int
    threads: int
    smem: int

    @property
    def grid(self) -> int:
        return self.n * self.cluster

    @property
    def ranges(self) -> tuple:
        return tuple((min(r * self.chunk, self.hw),
                      min((r + 1) * self.chunk, self.hw))
                     for r in range(self.cluster))


@functools.lru_cache(maxsize=64)
def launch_plan(n: int, h: int, w: int, cluster=None) -> Plan:
    """The launch of ``fused_preprocess`` on ``n`` images of ``h`` x
    ``w``: the smallest cluster in CLUSTERS whose CTAs (the image's pixels
    split evenly) take at most TARGET_SMEM, else the smallest that fits
    SMEM_LIMIT; a tiny image takes a cluster of 1. ``cluster`` forces a
    size. Threads: MAX_THREADS for a CTA alone on an SM, else
    SHARED_THREADS, and no more than a pixel each, in warps."""
    hw = h * w
    if hw < 1:
        raise ValueError(f"fused_preprocess: empty {h} x {w} images")

    def chunk_of(c):
        return -(-hw // c)

    if cluster is None:
        fits = [c for c in CLUSTERS if smem_bytes(chunk_of(c)) <= SMEM_LIMIT]
        if not fits:
            raise ValueError(
                f"fused_preprocess: a {h} x {w} image does not fit the "
                f"shared memory of a cluster of {CLUSTERS[-1]} CTAs")
        cluster = next((c for c in fits
                        if smem_bytes(chunk_of(c)) <= TARGET_SMEM), fits[0])
    if cluster not in CLUSTERS:
        raise ValueError(f"fused_preprocess: cluster size {cluster} not in "
                         f"{CLUSTERS}")
    chunk = chunk_of(cluster)
    smem = smem_bytes(chunk)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_preprocess: {chunk} pixels a CTA need "
                         f"{smem} bytes of shared memory")
    alone = SM_SMEM // (smem + CTA_RESERVE) == 1
    threads = min(MAX_THREADS if alone else SHARED_THREADS,
                  -(-chunk // 32) * 32)
    return Plan(n, hw, cluster, chunk, threads, smem)


def _targets(normalizer):
    """The target means and stds as tuples of floats (read on the host:
    the normalizer keeps them there)."""
    if normalizer is None:
        tm, ts = DEFAULT_TARGET_MEANS, DEFAULT_TARGET_STDS
    else:
        tm, ts = normalizer.target_means, normalizer.target_stds
    return tuple(tm.tolist()), tuple(ts.tolist())


def fused_preprocess_reference(x_u8: torch.Tensor, normalizer=None,
                               out_dtype=torch.float32) -> torch.Tensor:
    """The plain f32 chain: per_image_standardization(reinhard_fast(x))."""
    from ..data.normalize import ReinhardFastNormalizer

    tm, ts = _targets(normalizer)
    norm = ReinhardFastNormalizer(tm, ts)
    return per_image_standardization(norm(x_u8.float())).to(out_dtype)


@functools.lru_cache(maxsize=16)
def _coefficient_tensor(tm: tuple, ts: tuple,
                        device: torch.device) -> torch.Tensor:
    flat = np.concatenate([_RGB2LMS.ravel(), _LOGLMS2LAB.ravel(),
                           _LAB2LOGLMS.ravel(), _LMS2RGB.ravel(),
                           np.asarray(tm, np.float32),
                           np.asarray(ts, np.float32)]).astype(np.float32)
    host = torch.from_numpy(flat)
    if device.type == "cuda":
        # Pinned and asynchronous: even the first call does not wait for
        # the stream.
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def coefficients(normalizer, device) -> torch.Tensor:
    """The kernel's 42 coefficients (the four colour matrices, the target
    means and stds) on ``device``: one tensor for each (targets, device),
    made once and kept, so a normalizer refitted to new targets gets a
    new one."""
    tm, ts = _targets(normalizer)
    return _coefficient_tensor(tm, ts, torch.device(device))


def _launch(x: torch.Tensor, out: torch.Tensor, coef: torch.Tensor,
            plan: Plan) -> None:
    """Launch the kernel on contiguous uint8 ``x`` into bf16 ``out`` as
    ``plan`` says, and count the launch."""
    fn = _build.bound(NAME, "fused_preprocess_launch", _ARGTYPES)
    rc = fn(_build.ptr(x), _build.ptr(out), _build.ptr(coef), plan.n,
            plan.hw, plan.cluster, plan.chunk, plan.threads, plan.smem,
            x.device.index or 0, _build.stream_ptr(x))
    _build.check(rc, NAME)
    _build.count_launch(NAME)


def max_active_clusters(plan: Plan, device=None) -> int:
    """How many clusters of ``plan`` the card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    fit = ctypes.c_int(0)
    fn = _build.bound(NAME, "fused_preprocess_max_clusters",
                      [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])
    _build.check(fn(plan.hw, plan.cluster, plan.chunk, plan.threads,
                    plan.smem, dev.index or 0, ctypes.byref(fit)), NAME)
    return fit.value


def _normalizer_of(coef: torch.Tensor):
    """The normalizer whose targets ``coef`` (``coefficients``) holds."""
    from ..data.normalize import ReinhardFastNormalizer

    tail = coef[-6:].tolist()
    return ReinhardFastNormalizer(tail[:3], tail[3:])


def fused_preprocess(x_u8: torch.Tensor, normalizer=None,
                     out_dtype=torch.bfloat16, coef=None) -> torch.Tensor:
    """uint8 (N, H, W, 3) tiles -> stain-normalized, standardized
    (N, H, W, 3) activations. ``normalizer`` supplies the target lαβ
    statistics (default targets when None), or ``coef`` gives them as
    ``coefficients``' tensor on the tiles' device (the registered op's
    form). On the card the output is bf16; on the CPU the plain version
    returns ``out_dtype``."""
    if x_u8.ndim != 4 or x_u8.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) tiles, got {tuple(x_u8.shape)}")
    if not x_u8.is_cuda:
        if coef is not None:
            normalizer = _normalizer_of(coef)
        return fused_preprocess_reference(x_u8, normalizer, out_dtype)
    if x_u8.dtype != torch.uint8:
        raise TypeError(f"fused_preprocess takes uint8 tiles, got {x_u8.dtype}")
    if out_dtype != torch.bfloat16:
        raise ValueError("the fused_preprocess kernel writes bf16 only")
    x = x_u8.contiguous()
    n, h, w, _ = x.shape
    plan = launch_plan(n, h, w)
    if coef is None:
        coef = coefficients(normalizer, x.device)
    elif (coef.device != x.device or coef.shape != (42,)
          or coef.dtype != torch.float32 or not coef.is_contiguous()):
        raise ValueError(f"coef must be the 42 f32 coefficients on "
                         f"{x.device}, got {tuple(coef.shape)} {coef.dtype} "
                         f"on {coef.device}")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    _launch(x, out, coef, plan)
    return out

"""Stain normalization and image standardization on torch tensors.

Counterpart of ``biscuit_tpu/data/normalize.py``: Reinhard colour transfer
in Ruderman lαβ space without the brightness step (``reinhard_fast``),
the full Reinhard variant, and ``tf.image.per_image_standardization``.
The 3x3 colour matrices are kept in f32 and applied as explicit linear
combinations of the channel planes, so the products are full f32 whatever
the matmul precision settings (the JAX package pins them to HIGHEST).
"""

from __future__ import annotations

import numpy as np
import torch

# RGB -> LMS (Ruderman et al. 1998, as used by Reinhard et al. 2001).
_RGB2LMS = np.array(
    [
        [0.3811, 0.5783, 0.0402],
        [0.1967, 0.7244, 0.0782],
        [0.0241, 0.1288, 0.8444],
    ],
    np.float32,
)
_LMS2RGB = np.linalg.inv(_RGB2LMS).astype(np.float32)

_B = np.array([[1, 1, 1], [1, 1, -2], [1, -1, 0]], np.float32)
_W = np.diag([1 / np.sqrt(3), 1 / np.sqrt(6), 1 / np.sqrt(2)]).astype(np.float32)
_LOGLMS2LAB = (_W @ _B).astype(np.float32)
_LAB2LOGLMS = np.linalg.inv(_LOGLMS2LAB).astype(np.float32)

# Default target lαβ means/stds (a canonical synthetic H&E tile).
DEFAULT_TARGET_MEANS = np.array([388.44858, -3.4721153, 1.3899297], np.float32)
DEFAULT_TARGET_STDS = np.array([23.563368, 7.703939, 1.0439132], np.float32)


def _mix(mat: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """``x @ mat.T`` over the last axis (size 3), in f32 elementwise ops."""
    m = torch.as_tensor(mat, dtype=torch.float32, device=x.device)
    c = [x[..., j] for j in range(3)]
    return torch.stack(
        [m[i, 0] * c[0] + m[i, 1] * c[1] + m[i, 2] * c[2] for i in range(3)],
        dim=-1,
    )


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """RGB [0,255] float -> Ruderman lαβ. Shape (..., 3)."""
    rgb = torch.clamp_min(rgb.float(), 1.0)
    lms = _mix(_RGB2LMS, rgb)
    log_lms = torch.log10(torch.clamp_min(lms, 1e-8))
    return _mix(_LOGLMS2LAB, log_lms) * 100.0


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """Ruderman lαβ -> RGB [0,255] float."""
    log_lms = _mix(_LAB2LOGLMS, lab / 100.0)
    lms = torch.pow(10.0, log_lms)
    return torch.clamp(_mix(_LMS2RGB, lms), 0.0, 255.0)


class ReinhardFastNormalizer:
    """Reinhard colour-transfer stain normalizer (fast variant, no
    brightness standardization), with per-image statistics."""

    def __init__(self, target_means=None, target_stds=None):
        self.target_means = torch.from_numpy(np.array(
            DEFAULT_TARGET_MEANS if target_means is None else target_means,
            np.float32))
        self.target_stds = torch.from_numpy(np.array(
            DEFAULT_TARGET_STDS if target_stds is None else target_stds,
            np.float32))

    def fit(self, target_rgb) -> "ReinhardFastNormalizer":
        """Set targets from a reference RGB uint8/float image."""
        lab = rgb_to_lab(torch.as_tensor(target_rgb).float())
        flat = lab.reshape(-1, 3)
        self.target_means = flat.mean(dim=0).cpu()
        self.target_stds = flat.std(dim=0, correction=0).cpu()
        return self

    def _lab_transfer(self, rgb: torch.Tensor) -> torch.Tensor:
        lab = rgb_to_lab(rgb)
        mean = lab.mean(dim=(1, 2), keepdim=True)
        std = lab.std(dim=(1, 2), keepdim=True, correction=0)
        tm = self.target_means.to(lab.device)
        ts = self.target_stds.to(lab.device)
        lab = (lab - mean) / torch.clamp_min(std, 1e-6) * ts + tm
        return lab_to_rgb(lab)

    def __call__(self, rgb: torch.Tensor) -> torch.Tensor:
        """Normalize RGB [0,255] image(s), (H, W, 3) or (N, H, W, 3);
        float32 out, range [0,255]."""
        single = rgb.ndim == 3
        out = self._lab_transfer((rgb[None] if single else rgb).float())
        return out[0] if single else out

    def rgb_to_rgb(self, rgb: torch.Tensor) -> torch.Tensor:
        """slideflow's name for the call (the UncertaintyInterface of
        results.py:251-254 calls it)."""
        return self(rgb)


class ReinhardNormalizer(ReinhardFastNormalizer):
    """Full Reinhard: brightness-standardize (scale so the 95th percentile
    of luminance maps to 240) before the lαβ transfer."""

    def __call__(self, rgb: torch.Tensor) -> torch.Tensor:
        single = rgb.ndim == 3
        rgb = (rgb[None] if single else rgb).float()
        lum = rgb.amax(dim=-1).reshape(rgb.shape[0], -1)
        # numpy's default 'linear' percentile, written out (torch.quantile
        # refuses inputs above 2**24 elements).
        s = torch.sort(lum, dim=1).values
        pos = 0.95 * (s.shape[1] - 1)
        lo, frac = int(np.floor(pos)), pos - np.floor(pos)
        hi = min(lo + 1, s.shape[1] - 1)
        p95 = s[:, lo] + (s[:, hi] - s[:, lo]) * frac
        scale = 240.0 / torch.clamp_min(p95, 1.0)
        rgb = torch.clamp(rgb * scale[:, None, None, None], 0, 255)
        out = self._lab_transfer(rgb)
        return out[0] if single else out


def per_image_standardization(x: torch.Tensor) -> torch.Tensor:
    """tf.image.per_image_standardization: (x - mean) / max(std,
    1/sqrt(num_elements)) per image over all axes but the batch (4D) or
    over the whole image (3D)."""
    x = x.float()
    dims = tuple(range(x.ndim)) if x.ndim == 3 else tuple(range(1, x.ndim))
    n = float(np.prod([x.shape[d] for d in dims]))
    mean = x.mean(dim=dims, keepdim=True)
    std = x.std(dim=dims, keepdim=True, correction=0)
    return (x - mean) / torch.clamp_min(std, 1.0 / np.sqrt(n))


def inference_preprocess(images_u8: torch.Tensor, normalizer):
    """uint8 tile batch -> model input for the inference paths. A uint8
    CUDA batch with the reinhard_fast normalizer goes through the fused
    kernel (``ops/fused_preprocess.py``, through its registered op, bf16
    out); everything else takes the exact f32 chain."""
    if (images_u8.is_cuda
            and type(normalizer) is ReinhardFastNormalizer
            and images_u8.dtype == torch.uint8):
        from ..ops import library
        from ..ops.fused_preprocess import coefficients

        return library.fused_preprocess(
            images_u8, coefficients(normalizer, images_u8.device))
    x = images_u8.float()
    if normalizer is not None:
        x = normalizer(x)
    return per_image_standardization(x)


def make_normalizer(name):
    """Normalizer factory keyed on the hp.normalizer string."""
    if name is None or name == "none":
        return None
    if name in ("reinhard_fast", "reinhard-fast"):
        return ReinhardFastNormalizer()
    if name == "reinhard":
        return ReinhardNormalizer()
    raise ValueError(f"Unknown normalizer: {name}")

"""Tile preprocessing in f32: Reinhard colour transfer in Ruderman's
l-alpha-beta space without the brightness step ('reinhard_fast',
Reinhard et al. 2001), with per-image statistics and the canonical
target, then ``tf.image.per_image_standardization``."""

import numpy as np
import torch

RGB2LMS = np.array([[0.3811, 0.5783, 0.0402],
                    [0.1967, 0.7244, 0.0782],
                    [0.0241, 0.1288, 0.8444]], np.float64)
_B = np.array([[1, 1, 1], [1, 1, -2], [1, -1, 0]], np.float64)
_W = np.diag([1 / np.sqrt(3), 1 / np.sqrt(6), 1 / np.sqrt(2)])
LOGLMS2LAB = _W @ _B
TARGET_MEANS = np.array([388.44858, -3.4721153, 1.3899297])
TARGET_STDS = np.array([23.563368, 7.703939, 1.0439132])


def _mix(mat, x):
    m = torch.as_tensor(mat, dtype=torch.float32, device=x.device)
    return torch.einsum("...j,ij->...i", x, m)


def reinhard_fast(rgb):
    """(N, H, W, 3) RGB in [0, 255] -> normalized RGB in [0, 255], f32."""
    rgb = torch.clamp_min(rgb.float(), 1.0)
    lab = _mix(LOGLMS2LAB, torch.log10(torch.clamp_min(
        _mix(RGB2LMS, rgb), 1e-8))) * 100.0
    mean = lab.mean(dim=(1, 2), keepdim=True)
    std = lab.std(dim=(1, 2), keepdim=True, correction=0)
    tm = torch.as_tensor(TARGET_MEANS, dtype=torch.float32, device=rgb.device)
    ts = torch.as_tensor(TARGET_STDS, dtype=torch.float32, device=rgb.device)
    lab = (lab - mean) / torch.clamp_min(std, 1e-6) * ts + tm
    lms = torch.pow(10.0, _mix(np.linalg.inv(LOGLMS2LAB), lab / 100.0))
    return torch.clamp(_mix(np.linalg.inv(RGB2LMS), lms), 0.0, 255.0)


def standardize(x):
    """Per image: (x - mean) / max(std, 1 / sqrt(H W C))."""
    x = x.float()
    n = x[0].numel()
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    std = x.std(dim=(1, 2, 3), keepdim=True, correction=0)
    return (x - mean) / torch.clamp_min(std, 1.0 / np.sqrt(n))


def preprocess(tiles_u8, normalizer: str):
    x = tiles_u8.float()
    if normalizer in ("reinhard_fast", "reinhard-fast"):
        x = reinhard_fast(x)
    elif normalizer not in (None, "none"):
        raise ValueError(f"the reference has no normalizer {normalizer!r}")
    return standardize(x)

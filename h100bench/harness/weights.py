"""The classifier's weights, made on the device from the seed in a few
large calls: one uniform draw for every leaf, turned into a LeCun-normal
kernel truncated at two standard deviations (Flax's init, the inverse
CDF of the uniform), or a BatchNorm value in the configuration's range.
Both the program and the reference get these same tensors; neither makes
its own."""

import math

import torch

from ..reference.params import param_specs
from .seeds import derive

_TRUNC_STD = 0.87962566103423978     # std of N(0,1) truncated to [-2, 2]


def make(config: dict, seed: int, device) -> dict:
    """{name: f32 tensor} of the classifier of ``config`` on ``device``."""
    specs = param_specs(config)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    sizes = [math.prod(shape) for _, shape, _ in specs]
    u = torch.rand(sum(sizes), generator=gen, device=device,
                   dtype=torch.float32)
    u = u.clamp_(1e-7, 1 - 1e-7)
    lo, hi = (0.5 * (1 + math.erf(z / 2 ** 0.5)) for z in (-2.0, 2.0))
    normal = torch.erfinv(2 * (lo + (hi - lo) * u) - 1) * 2 ** 0.5
    gauss = torch.erfinv(2 * u - 1) * 2 ** 0.5
    gain = config.get("logits_gain", 1.0)
    scale, shift, kind = [], [], []
    for name, shape, role in specs:
        if role in ("conv", "dense", "logits"):
            fan_in = math.prod(shape[1:])
            s = fan_in ** -0.5 / _TRUNC_STD * (gain if role == "logits"
                                                else 1.0)
            scale.append(s), shift.append(0.0), kind.append(0)
        elif role in ("bn_weight", "bn_var"):
            scale.append(0.4), shift.append(0.8), kind.append(1)
        elif role in ("bn_bias", "bn_mean"):
            scale.append(0.05), shift.append(0.0), kind.append(2)
        elif role == "bias":
            scale.append(0.01), shift.append(0.0), kind.append(2)
        else:                                           # bn_count
            scale.append(0.0), shift.append(0.0), kind.append(1)
    sizes_t = torch.tensor(sizes, device=device)

    def per_element(values, dtype=torch.float32):
        return torch.repeat_interleave(
            torch.tensor(values, dtype=dtype, device=device), sizes_t)

    k = per_element(kind, torch.int8)
    base = torch.where(k == 0, normal, torch.where(k == 1, u, gauss))
    flat = base * per_element(scale) + per_element(shift)
    out = {}
    for (name, shape, role), part in zip(specs, torch.split(flat, sizes)):
        if role == "bn_count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            out[name] = part.view(shape)
    return out

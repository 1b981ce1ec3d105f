"""The classifier's weights, made on the device from the seed in a few
large calls: one uniform draw for every leaf, each leaf's part of it
turned into its role's distribution (``ROLES``): a normal truncated at
two standard deviations and rescaled to unit variance (Flax's
LeCun-normal init with the fan-in scale, the inverse CDF of the
uniform), the uniform itself, or a Gauss normal, times a scale plus a
shift. Both the program and the reference get these same tensors;
neither makes its own."""

import math
from typing import NamedTuple

import torch

from ..reference import families
from ..reference.params import param_specs
from .seeds import derive

_TRUNC_STD = 0.87962566103423978     # std of N(0,1) truncated to [-2, 2]
_KIND = {"truncated": 0, "uniform": 1, "gauss": 2, "count": 1}


class Role(NamedTuple):
    """How the leaves of one role are drawn: ``draw`` 'truncated',
    'uniform', 'gauss' or 'count' (an int64 counter at 0), times ``scale``
    (divided by the square root of the fan-in where ``fan_in``), plus
    ``shift``. A 'logits' leaf's scale is also multiplied by the
    configuration's ``logits_gain``."""
    draw: str
    scale: float
    shift: float = 0.0
    fan_in: bool = False


ROLES = {
    "conv": Role("truncated", 1.0, fan_in=True),
    "dense": Role("truncated", 1.0, fan_in=True),
    "logits": Role("truncated", 1.0, fan_in=True),
    "bias": Role("gauss", 0.01),
    "bn_weight": Role("uniform", 0.4, 0.8),
    "bn_var": Role("uniform", 0.4, 0.8),
    "bn_bias": Role("gauss", 0.05),
    "bn_mean": Role("gauss", 0.05),
    "bn_count": Role("count", 0.0),
}


def roles(config: dict) -> dict:
    """``ROLES`` and the roles that ``config``'s trunk family adds."""
    added = {r: Role(*v) for r, v in
             getattr(families.of(config), "ROLES", {}).items()}
    known = sorted(set(added) & set(ROLES))
    if known:
        raise ValueError(f"family {config['arch']['family']!r} redefines "
                         f"the weight roles {known}")
    for r, role in added.items():
        if role.draw not in _KIND:
            raise ValueError(f"weight role {r!r}: no draw {role.draw!r} "
                             f"(draws: {sorted(_KIND)})")
    return {**ROLES, **added}


def make(config: dict, seed: int, device) -> dict:
    """{name: f32 tensor} of the classifier of ``config`` on ``device``."""
    specs = param_specs(config)
    table = roles(config)
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
    for name, shape, r in specs:
        if r not in table:
            raise ValueError(f"leaf {name}: no weight role {r!r} in "
                             f"{sorted(table)}")
        role = table[r]
        s = math.prod(shape[1:]) ** -0.5 if role.fan_in else 1.0
        if role.draw == "truncated":
            s = s / _TRUNC_STD
        s = s * role.scale * (gain if r == "logits" else 1.0)
        scale.append(s)
        shift.append(role.shift)
        kind.append(_KIND[role.draw])
    sizes_t = torch.tensor(sizes, device=device)

    def per_element(values, dtype=torch.float32):
        return torch.repeat_interleave(
            torch.tensor(values, dtype=dtype, device=device), sizes_t)

    k = per_element(kind, torch.int8)
    base = torch.where(k == 0, normal, torch.where(k == 1, u, gauss))
    flat = base * per_element(scale) + per_element(shift)
    out = {}
    for (name, shape, r), part in zip(specs, torch.split(flat, sizes)):
        if table[r].draw == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            out[name] = part.view(shape)
    return out

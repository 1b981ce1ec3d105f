"""The one traffic generator. A mix (``traffic/<mix>.json``) gives its
parameters; the generator makes from the seed a pool of tissue-like
uint8 RGB tiles in host memory (what ``Heatmap``, ``score_tiles`` and the
CLIs hand the port) and the sequence of requests or steps over it: item
i is the slice of ``tiles_per_request`` (or ``batch``) tiles starting at
(i * size) mod (pool - size + 1), with its own seed. Every seed gives
the same sizes; only the content changes.

A tile is an H&E-like absorbance image: haematoxylin and eosin densities
from low-frequency fields, nuclei from a mid-frequency field, a tissue
mask, Beer-Lambert colour (Ruifrok and Johnston's stain vectors) and
pixel noise, made on the device in blocks and copied to the host."""

import numpy as np
import torch
import torch.nn.functional as F

from .seeds import derive

_OD_H = (0.650, 0.704, 0.286)
_OD_E = (0.072, 0.990, 0.105)


def tile_pool(n: int, px: int, seed: int, device, block: int = 256):
    """(n, px, px, 3) uint8 numpy tiles."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "tiles"))
    od = torch.tensor([_OD_H, _OD_E], device=device)        # (2, 3)
    out = np.empty((n, px, px, 3), np.uint8)
    for r0 in range(0, n, block):
        b = min(block, n - r0)

        def field(res, ch):
            f = torch.rand((b, ch, res, res), generator=gen, device=device)
            return F.interpolate(f, size=(px, px), mode="bilinear",
                                 align_corners=False)

        coarse = field(6, 3)
        nuclei = torch.relu(field(max(4, px // 8), 1) - 0.6) * 4.0
        h = 0.25 + 0.5 * coarse[:, :1] + nuclei
        e = 0.3 + 0.6 * coarse[:, 1:2]
        tissue = torch.sigmoid(8.0 * (coarse[:, 2:3] - 0.25))
        dens = torch.cat([h, e], dim=1) * tissue        # (b, 2, px, px)
        absorb = torch.einsum("bshw,sc->bhwc", dens, od) * 1.6
        rgb = 250.0 * torch.exp(-absorb)
        rgb = rgb + 4.0 * torch.randn(rgb.shape, generator=gen, device=device)
        out[r0:r0 + b] = rgb.clamp_(0, 255).round_().to(torch.uint8).cpu() \
            .numpy()
    return out


class Stream:
    """The items of a mix over its pool: ``slice(i)`` is item i's tiles
    (a view), ``seed(i)`` its seed; for training ``labels`` and ``mask``
    of the pool."""

    def __init__(self, traffic: dict, config: dict, seed: int, device):
        self.size = traffic.get("tiles_per_request", traffic.get("batch"))
        self.pool_n = traffic["pool_tiles"]
        if self.pool_n < self.size:
            raise ValueError("the pool is smaller than one item")
        self.pool = tile_pool(self.pool_n, config["hp"]["tile_px"], seed,
                              device)
        rng = np.random.default_rng(derive(seed, "labels"))
        self.labels = rng.integers(0, config["classes"], self.pool_n,
                                   dtype=np.int64)
        self.mask = np.ones(self.pool_n, np.float32)
        self._base = derive(seed, "item", 39) << 24

    def start(self, i: int) -> int:
        return (i * self.size) % (self.pool_n - self.size + 1)

    def slice(self, i: int):
        s = self.start(i)
        return self.pool[s:s + self.size]

    def batch(self, i: int):
        s = self.start(i)
        return (self.pool[s:s + self.size], self.labels[s:s + self.size],
                self.mask[s:s + self.size])

    def seed(self, i: int) -> int:
        return self._base | (i & 0xFFFFFF)

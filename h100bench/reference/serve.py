"""What one served request answers: the mean and the standard deviation
over K dropout passes of the head's softmax, the trunk run once a tile,
each pass's dropout masks drawn from the head's Philox stream at the
request's seed, the tile's row in the request and the pass."""

import torch

from . import nets, philox
from .preprocess import preprocess
from .quant import quantizer

BLOCK = 64      # rows a pass, to bound the f32 trunk's memory


@torch.no_grad()
def request(tiles_u8, seed: int, p: dict, config: dict, device, quant=None):
    """(mean (N, C), std (N, C)) f32 on the host of one request of uint8
    NHWC tiles (numpy), computed in blocks of ``BLOCK`` rows."""
    q = quantizer(quant)
    hp = config["hp"]
    k, rate = hp["uq_samples"], hp["dropout"]
    scale = philox.keep_scale(rate)
    means, stds = [], []
    n = tiles_u8.shape[0]
    for r0 in range(0, n, BLOCK):
        rows = range(r0, min(n, r0 + BLOCK))
        x = torch.as_tensor(tiles_u8[r0:rows.stop]).to(device)
        f = nets.features(preprocess(x, hp["normalizer"]), p, config, q=q)
        h = f
        for layer in range(hp["hidden_layers"]):
            h = torch.relu(nets.dense(h, p, f"head.hidden{layer}", q))
            keep = philox.keep_masks(seed, k, layer, rows, h.shape[-1], rate,
                                     device)
            h = torch.where(keep, h * scale, torch.zeros((), device=device))
        probs = torch.softmax(nets.dense(h, p, "head.logits", q), dim=-1)
        means.append(probs.mean(dim=0).cpu())
        stds.append(probs.std(dim=0, correction=0).cpu())
    return torch.cat(means).numpy(), torch.cat(stds).numpy()

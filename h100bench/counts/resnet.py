"""FLOPs of the ResNet-v1.5 tile classifiers (2 x MACs of every conv;
BatchNorm, ReLU, pools and the residual adds left out), at the padding
``biscuit_torch/models/resnet.py`` uses: Flax SAME on every conv, so
out = ceil(in / stride), the stem 7x7/2, the stride-2 SAME max-pool, the
stride on each stage's first 3x3 (v1.5) and its 1x1 projection. The
architecture comes from the configuration file's ``arch``: ``block``
('bottleneck' or 'basic'), ``repeats`` a stage and the ``stem`` width."""

import math


def _conv(h, cin, cout, k, stride=1):
    ho = math.ceil(h / stride)
    return 2 * ho * ho * cout * k * k * cin, ho


def trunk_flops(arch: dict, tile_px: int) -> int:
    """Forward FLOPs of one trunk pass of one (square) tile."""
    stem = arch["stem"]
    f, h = _conv(tile_px, 3, stem, 7, 2)
    h = math.ceil(h / 2)                      # the stem's max-pool
    mult = 4 if arch["block"] == "bottleneck" else 1
    c = stem
    for stage, n_blocks in enumerate(arch["repeats"]):
        feats = stem * 2 ** stage
        for b in range(n_blocks):
            s = 2 if (b == 0 and stage > 0) else 1
            if s != 1 or c != feats * mult:
                df, _ = _conv(h, c, feats * mult, 1, s)
                f += df
            if arch["block"] == "bottleneck":
                df, _ = _conv(h, c, feats, 1)
                f += df
                df, ho = _conv(h, feats, feats, 3, s)
                f += df
                df, _ = _conv(ho, feats, feats * 4, 1)
                f += df
            else:
                df, ho = _conv(h, c, feats, 3, s)
                f += df
                df, _ = _conv(ho, feats, feats, 3)
                f += df
            h = ho
            c = feats * mult
    return f


def feature_dim(arch: dict) -> int:
    mult = 4 if arch["block"] == "bottleneck" else 1
    return arch["stem"] * 2 ** (len(arch["repeats"]) - 1) * mult

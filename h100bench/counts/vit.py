"""FLOPs of the ViT tile classifiers (2 x MACs of the patch conv and of
every Linear over every token, and the two attention products Q K^T and
A V of every head; LayerNorm, softmax, the SwiGLU gate, LayerScale and the
residual adds left out, as bandwidth-bound). The architecture comes from
the configuration file's ``arch``: ``img_size``, ``patch``, ``width``,
``depth``, ``mlp_hidden`` (``fc1``'s packed width; ``fc2`` takes half of
it) and ``reg_tokens``; the tokens are the class token, the register
tokens and the patches."""


def trunk_flops(arch: dict, tile_px: int) -> int:
    """Forward FLOPs of one trunk pass of one (square) tile."""
    d, k, hidden = arch["width"], arch["patch"], arch["mlp_hidden"]
    patches = (tile_px // k) ** 2
    t = 1 + arch["reg_tokens"] + patches
    embed = 2 * patches * d * 3 * k * k
    linears = 2 * t * (d * 3 * d + d * d + d * hidden + hidden // 2 * d)
    attention = 2 * 2 * t * t * d
    return embed + arch["depth"] * (linears + attention)


def feature_dim(arch: dict) -> int:
    return arch["width"]

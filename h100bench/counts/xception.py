"""FLOPs of the Xception tile classifier (2 x MACs of every conv and
matmul; BatchNorm, ReLU and pools left out, as bandwidth-bound). A copy
of ``biscuit_torch/models/flops.py`` that walks the architecture table of
the configuration file (``arch``) instead of the program's.

Spatial sizes follow SAME padding (out = ceil(in / stride)) everywhere
but the two stem convs, which are VALID as in keras.applications
Xception."""

import math


def _conv(h, w, cin, cout, k=3, stride=1, groups=1, padding="SAME"):
    if padding == "VALID":
        ho, wo = (h - k) // stride + 1, (w - k) // stride + 1
    else:
        ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    return 2 * ho * wo * cout * (k * k * cin // groups), ho, wo


def _sepconv(h, w, cin, cout):
    dw, _, _ = _conv(h, w, cin, cin, k=3, groups=cin)
    pw, _, _ = _conv(h, w, cin, cout, k=1)
    return dw + pw


def trunk_flops(arch: dict, tile_px: int) -> int:
    """Forward FLOPs of one trunk pass of one tile."""
    f = 0
    h = w = tile_px
    c_in = 3
    for i, c_out in enumerate(arch["entry_convs"]):
        df, h, w = _conv(h, w, c_in, c_out, k=3, stride=2 if i == 0 else 1,
                         padding="VALID")
        f += df
        c_in = c_out
    for c_out in arch["entry_blocks"]:
        f += _sepconv(h, w, c_in, c_out) + _sepconv(h, w, c_out, c_out)
        rf, h, w = _conv(h, w, c_in, c_out, k=1, stride=2)
        f += rf
        c_in = c_out
    wmid = arch["middle_width"]
    f += arch["middle_repeats"] * 3 * _sepconv(h, w, wmid, wmid)
    a, b = arch["exit_block"]
    f += _sepconv(h, w, c_in, a) + _sepconv(h, w, a, b)
    rf, h, w = _conv(h, w, c_in, b, k=1, stride=2)
    f += rf
    c_in = b
    for c_out in arch["exit_convs"]:
        f += _sepconv(h, w, c_in, c_out)
        c_in = c_out
    return f


def feature_dim(arch: dict) -> int:
    return arch["exit_convs"][-1]

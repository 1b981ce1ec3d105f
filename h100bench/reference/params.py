"""The parameter list of a configuration's classifier, under the Flax stage
names that the port's ``state_dict`` and the JAX package share: (name,
shape, role) in a fixed order. Roles: 'conv' and 'dense' kernels (fan-in
scaled), 'logits' (the last dense kernel), 'bias', BatchNorm 'bn_weight',
'bn_bias', 'bn_mean', 'bn_var', 'bn_count'."""


def _bn(out, name, c):
    out += [(f"{name}.weight", (c,), "bn_weight"),
            (f"{name}.bias", (c,), "bn_bias"),
            (f"{name}.running_mean", (c,), "bn_mean"),
            (f"{name}.running_var", (c,), "bn_var"),
            (f"{name}.num_batches_tracked", (), "bn_count")]


def _sep(out, name, cin, cout):
    out += [(f"{name}.depthwise.weight", (cin, 1, 3, 3), "conv"),
            (f"{name}.pointwise.weight", (cout, cin, 1, 1), "conv")]


def xception_blocks(arch: dict):
    """(module name, cin, features, strides, relu_first) of every residual
    block of the Xception trunk, in order."""
    blocks = []
    c = arch["entry_convs"][1]
    for i, f in enumerate(arch["entry_blocks"]):
        blocks.append((f"entry{i}", c, (f, f), 2, i != 0))
        c = f
    w = arch["middle_width"]
    for i in range(arch["middle_repeats"]):
        blocks.append((f"middle{i}", c, (w, w, w), 1, True))
        c = w
    blocks.append(("exit_block", c, tuple(arch["exit_block"]), 2, True))
    return blocks


def _xception(arch: dict):
    out = []
    c0, c1 = arch["entry_convs"]
    out.append(("backbone.conv1.weight", (c0, 3, 3, 3), "conv"))
    _bn(out, "backbone.conv1_bn", c0)
    out.append(("backbone.conv2.weight", (c1, c0, 3, 3), "conv"))
    _bn(out, "backbone.conv2_bn", c1)
    for name, cin, feats, strides, _ in xception_blocks(arch):
        pre = f"backbone.{name}"
        if strides != 1 or cin != feats[-1]:
            out.append((f"{pre}.res_conv.weight", (feats[-1], cin, 1, 1),
                        "conv"))
            _bn(out, f"{pre}.res_bn", feats[-1])
        c = cin
        for i, f in enumerate(feats):
            _sep(out, f"{pre}.sep{i}", c, f)
            _bn(out, f"{pre}.bn{i}", f)
            c = f
    c = arch["exit_block"][-1]
    for i, f in enumerate(arch["exit_convs"]):
        _sep(out, f"backbone.exit_sep{i}", c, f)
        _bn(out, f"backbone.exit_bn{i}", f)
        c = f
    return out, c


def resnet_blocks(arch: dict):
    """(module name, cin, features, strides) of every block, in order."""
    mult = 4 if arch["block"] == "bottleneck" else 1
    blocks = []
    c = arch["stem"]
    for stage, n in enumerate(arch["repeats"]):
        feats = arch["stem"] * 2 ** stage
        for b in range(n):
            blocks.append((f"stage{stage}_block{b}", c, feats,
                           2 if (b == 0 and stage > 0) else 1))
            c = feats * mult
    return blocks, c


def _resnet(arch: dict):
    out = []
    stem = arch["stem"]
    out.append(("backbone.stem.weight", (stem, 3, 7, 7), "conv"))
    _bn(out, "backbone.stem_bn", stem)
    bottleneck = arch["block"] == "bottleneck"
    mult = 4 if bottleneck else 1
    blocks, c_out = resnet_blocks(arch)
    for name, cin, f, s in blocks:
        pre = f"backbone.{name}"
        if s != 1 or cin != f * mult:
            out.append((f"{pre}.proj.weight", (f * mult, cin, 1, 1), "conv"))
            _bn(out, f"{pre}.proj_bn", f * mult)
        if bottleneck:
            convs = [(cin, f, 1), (f, f, 3), (f, 4 * f, 1)]
        else:
            convs = [(cin, f, 3), (f, f, 3)]
        for i, (a, b, k) in enumerate(convs, 1):
            out.append((f"{pre}.conv{i}.weight", (b, a, k, k), "conv"))
            _bn(out, f"{pre}.bn{i}", b)
    return out, c_out


def param_specs(config: dict):
    """[(name, shape, role)] of the whole classifier of ``config``."""
    arch = config["arch"]
    trunk = _xception if arch["family"] == "xception" else _resnet
    out, f = trunk(arch)
    hp = config["hp"]
    h = hp["hidden_layer_width"]
    c = f
    for i in range(hp["hidden_layers"]):
        out += [(f"head.hidden{i}.weight", (h, c), "dense"),
                (f"head.hidden{i}.bias", (h,), "bias")]
        c = h
    out += [("head.logits.weight", (config["classes"], c), "logits"),
            ("head.logits.bias", (config["classes"],), "bias")]
    return out


def trainable(specs):
    """Names of the leaves a training step updates."""
    return [n for n, _, role in specs
            if role not in ("bn_mean", "bn_var", "bn_count")]

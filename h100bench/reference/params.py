"""The parameter list of a configuration's classifier, under the names of
the port's ``state_dict``: (name, shape, role) in a fixed order, the
trunk's from its family (``families/<family>.py``), then the head's.
Each role is a row of ``harness/weights.py``'s table, which says how its
leaves are initialised: 'conv' and 'dense' kernels (fan-in scaled),
'logits' (the last dense kernel), 'bias', BatchNorm 'bn_weight',
'bn_bias', 'bn_mean', 'bn_var', 'bn_count', and the roles a family adds.
The running statistics and the counter (``STATE_ROLES``) are state that
no gradient moves."""

from . import families

STATE_ROLES = ("bn_mean", "bn_var", "bn_count")


def bn_leaves(out, name, c):
    """The five leaves of the BatchNorm ``name`` over ``c`` channels."""
    out += [(f"{name}.weight", (c,), "bn_weight"),
            (f"{name}.bias", (c,), "bn_bias"),
            (f"{name}.running_mean", (c,), "bn_mean"),
            (f"{name}.running_var", (c,), "bn_var"),
            (f"{name}.num_batches_tracked", (), "bn_count")]


def param_specs(config: dict):
    """[(name, shape, role)] of the whole classifier of ``config``."""
    out, f = families.of(config).param_specs(config["arch"])
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
    return [n for n, _, role in specs if role not in STATE_ROLES]


def running_statistics(specs):
    """Names of the BatchNorm running means and variances: empty for a
    model with no BatchNorm."""
    return [n for n, _, role in specs if role in ("bn_mean", "bn_var")]

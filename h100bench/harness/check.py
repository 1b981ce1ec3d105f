"""The numbers that decide ``correct``, each computed from the program's
outputs and the reference's and held to its limit from the cell's
workload file; the limits say which are compared, the rest are readings
for the record (the result line's ``readings``).

Serving, over every tile of the sampled requests: the widest gap of the
mean of the K passes' softmax in units of its slope (``mean_logit_gap``:
|mean - mean_ref| over mean_ref (1 - mean_ref) - std_ref^2, the average
slope p (1 - p) of the passes, so that a tile near 0 or 1 weighs as much
as one near 0.5), and the widest gap of their standard deviation
(``std_gap``, a probability). ``mean_gap`` is the mean's widest gap as a
probability.

Training: for each leaf, the gap between the program's norm and the
reference's, measured against the reference's norm of that leaf or of the
median leaf, whichever is larger, of: the first gradient (the program's
as its Adam state holds it after one step, read with Adam's published
beta1); the parameters' change after the checked steps; Adam's second
moment after them; and each BatchNorm running mean's and variance's
change over them. Of the first gradient the median leaf's gap
(``grad1_median_gap``), and the median leaf's gap within each leaf group
the configuration names (``grad1_gap.<group>``: stem, stages, head), so
that a fault confined to one group shows; ``grad1_worst_gap`` is the
worst leaf's. Of the change the worst leaf's (``change_gap``), of the
second moment the median leaf's (``adam_v_median_gap``), of the running
statistics the worst leaf's (``running_gap``; only where the model keeps
running statistics). Leaves whose reference gradient is under a
thousandth of the median leaf's move under Adam by round-off alone and
are left out of the change. The relative gaps of the
first step's loss (``loss1_gap``) and of the checked steps'
(``loss_gap``) are readings. PERF.md gives the readings behind these
choices: the stem's gradient and the losses swing with bf16 rounding on
sound runs as far as the control does."""

import statistics

import numpy as np

from ..reference.params import param_specs, running_statistics

FLOOR_SHARE = 1e-3
SLOPE_FLOOR = 1e-4      # the slope of a softmax saturated to 1e-4
SERVE_NUMBERS = ("mean_logit_gap", "std_gap", "mean_gap")
TRAIN_NUMBERS = ("loss_gap", "loss1_gap", "grad1_median_gap",
                 "grad1_worst_gap", "change_gap", "adam_v_median_gap")


def serve_numbers(program, reference) -> dict:
    """``program``/``reference``: [(mean, std)] numpy, one a request."""
    mean = max(float(np.abs(p[0] - r[0]).max())
               for p, r in zip(program, reference))
    logit = max(float((np.abs(p[0] - r[0]) / np.maximum(
        r[0] * (1 - r[0]) - r[1] ** 2, SLOPE_FLOOR)).max())
        for p, r in zip(program, reference))
    std = max(float(np.abs(p[1] - r[1]).max())
              for p, r in zip(program, reference))
    return {"mean_logit_gap": logit, "std_gap": std, "mean_gap": mean}


def leaf_gaps(program: dict, reference: dict, leaves=None) -> dict:
    """{leaf: gap of its norms} against max(its norm, the median leaf's)."""
    leaves = list(reference) if leaves is None else list(leaves)
    median = statistics.median(reference[n] for n in reference)
    return {n: abs(program[n] - reference[n]) / max(reference[n], median,
                                                    1e-30)
            for n in leaves}


def moving_leaves(ref_grad1: dict) -> list:
    median = statistics.median(ref_grad1.values())
    return [n for n, g in ref_grad1.items() if g >= FLOOR_SHARE * median]


def group_leaves(leaves, groups: dict) -> dict:
    """{group: [leaf]}: each leaf in the group one of whose name prefixes
    it starts with; ``groups`` is the configuration's ``leaf_groups``."""
    out = {g: [] for g in groups}
    for leaf in leaves:
        hits = [g for g, prefixes in groups.items()
                if leaf.startswith(tuple(prefixes))]
        if len(hits) != 1:
            raise ValueError(f"leaf {leaf} is in groups {hits}")
        out[hits[0]].append(leaf)
    return out


def train_numbers(program: dict, reference: dict, groups: dict) -> dict:
    """Each: {'loss': [..], 'grad1', 'change', 'adam_v', 'running':
    {leaf: norm}}. The cell's limits say which of these are compared; the
    others are readings for the record."""
    loss = [abs(p - r) / abs(r)
            for p, r in zip(program["loss"], reference["loss"])]
    grad1 = leaf_gaps(program["grad1"], reference["grad1"])
    change = leaf_gaps(program["change"], reference["change"],
                       moving_leaves(reference["grad1"]))
    adam_v = leaf_gaps(program["adam_v"], reference["adam_v"])
    out = {"loss_gap": max(loss), "loss1_gap": loss[0],
           "grad1_median_gap": statistics.median(grad1.values()),
           "grad1_worst_gap": max(grad1.values()),
           "change_gap": max(change.values()),
           "adam_v_median_gap": statistics.median(adam_v.values())}
    if reference["running"]:
        out["running_gap"] = max(leaf_gaps(program["running"],
                                           reference["running"]).values())
    for group, leaves in group_leaves(grad1, groups).items():
        out[f"grad1_gap.{group}"] = statistics.median(grad1[n]
                                                      for n in leaves)
    return out


def worst_leaves(program: dict, reference: dict):
    """[(norm, leaf, gap)] of the worst leaf of each norm, for the log."""
    out = []
    for what, leaves in (("grad1", None),
                         ("change", moving_leaves(reference["grad1"])),
                         ("running", None)):
        if not reference[what]:
            continue
        gap = leaf_gaps(program[what], reference[what], leaves)
        leaf = max(gap, key=gap.get)
        out.append((what, leaf, gap[leaf]))
    return out


def givable(entry: str, config: dict) -> set:
    """The names of the numbers a cell of ``entry`` over ``config``'s model
    gives: ``running_gap`` only where the model keeps running statistics."""
    if entry == "serve":
        return set(SERVE_NUMBERS)
    out = set(TRAIN_NUMBERS) | {f"grad1_gap.{g}"
                                for g in config["leaf_groups"]}
    if running_statistics(param_specs(config)):
        out.add("running_gap")
    return out


def judge(numbers: dict, limits: dict):
    """(every number within its limit, {name: {value, limit}}); raises
    where a limit names a number that the run did not give."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise ValueError(f"the limits name {missing}, which this cell's "
                         f"model cannot give (it gives {sorted(numbers)})")
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks

"""``correct`` comes out false for each fault a cell can have, planted in
the port under a whole run (the harness's look for a card skipped: tiny
cells on the CPU); the control, the reference one precision below the
configuration's, reads far above the program."""

import time

import pytest
import torch

from h100bench import control
from h100bench.harness import check, drive, faults, spec
from h100bench.tests import tiny

CELLS = ["xception299.serve.b256", "xception299.train.b128",
         "resnet50.serve.b256", "resnet50.train.b128"]


def _faults():
    """(cell, fault, leaf group): the scaled fault once for each group
    whose first gradient the cell compares."""
    out = []
    for cell in CELLS:
        c = spec.load_cell(cell)
        out += [(cell, f, None) for f in faults.applicable(c.entry, c.config)
                if f != "scaled"]
        if c.entry == "train":
            out += [(cell, "scaled", g) for g in c.config["leaf_groups"]
                    if f"grad1_gap.{g}" in c.limits]
    return out


@pytest.mark.parametrize("cell, fault, group", _faults())
def test_each_fault_makes_the_run_incorrect(cell, fault, group, tmp_path):
    bench, names = tiny.write(tmp_path, (cell,))
    c = tiny.load(tmp_path, bench, names[cell])
    torch.set_num_threads(2)
    prefixes = c.config["leaf_groups"][group] if group else ()
    with faults.planted(c.entry, fault, prefixes):
        line, _ = drive.execute(c, 2 ** 31 + 21, 0.3, False,
                                torch.device("cpu"), time.perf_counter())
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(cell, tmp_path):
    bench, names = tiny.write(tmp_path, (cell,))
    c = tiny.load(tmp_path, bench, names[cell])
    torch.set_num_threads(2)
    low = control.control_numbers(c, 2 ** 31 + 23, torch.device("cpu"))
    ok, _ = check.judge(low, c.limits)
    assert not ok, low
    line, _ = drive.execute(c, 2 ** 31 + 23, 0.3, False,
                            torch.device("cpu"), time.perf_counter())
    prog = {k: v["value"] for k, v in line["checks"].items()}
    assert max(low[k] / max(prog[k], 1e-12) for k in prog) >= 3, (low, prog)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cells_compare_what_the_full_cells_compare(cell):
    c = spec.load_cell(cell)
    family = c.config["arch"]["family"]
    assert set(tiny.LIMITS[c.entry, family]) == set(c.limits)

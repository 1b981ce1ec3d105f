"""On the card, at each cell's own size: a short run of the cell is
correct, and the control (the reference one precision below the
configuration's, in the program's place) fails the cell's limits on
three seeds. Run on a machine with an H100:

    python -m pytest h100bench/tests/test_h100bench_cuda.py -m cuda -q
"""

import time

import pytest
import torch

from h100bench import control
from h100bench.harness import check, drive, spec

pytestmark = pytest.mark.cuda

CELLS = [c["name"] for c in spec.manifest()["workloads"]]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(cell, card):
    c = spec.load_cell(cell)
    line, _ = drive.execute(c, 2 ** 31 + 41, 2.0, False, card,
                            time.perf_counter())
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell, card):
    c = spec.load_cell(cell)
    for seed in (2 ** 31 + 43, 2 ** 31 + 45, 2 ** 31 + 47):
        ok, checks = check.judge(control.control_numbers(c, seed, card),
                                 c.limits)
        assert not ok, checks

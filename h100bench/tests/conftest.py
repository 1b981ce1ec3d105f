"""The benchmark's own tests: ``python -m pytest h100bench/tests -q``.
Tests that need the card carry the ``cuda`` marker and decide in a
fixture whether there is one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: tests of the benchmark on a CUDA card")

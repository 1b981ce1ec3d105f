"""Kernel mcd_head's share of its roofline over the traced
window, %: the sum of its calls' least times (``counts/mcd_head.py``)
over the sum of the device time of the kernels launched inside its
calls. Nothing when no call ran."""

from h100bench.harness.metric_util import roofline


def read(run):
    return roofline(run, "mcd_head")

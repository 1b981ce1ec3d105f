"""Kernel vit_mlp's share of its roofline over the traced window, %: the
sum of its calls' least times (``counts/vit_mlp.py``) over the sum of
the device time of the kernels launched inside its calls. Nothing when no
call ran (a program with no ViT)."""

from h100bench.harness.metric_util import roofline


def read(run):
    return roofline(run, "vit_mlp")

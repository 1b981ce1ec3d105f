"""Seconds from the process's start to the first timed request or step:
imports, the kernels' load (or build), weights, traffic, warm-up."""


def read(run):
    return run.setup_s

"""The 95th percentile of the latency of every request of the window, from
the client's send to its results on the host (host clock), in ms."""

import numpy as np


def read(run):
    if run.entry != "serve" or not run.latency_s:
        return None
    return float(np.percentile(run.latency_s, 95)) * 1e3

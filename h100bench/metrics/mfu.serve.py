"""Model FLOPs of the window's served tiles (one trunk pass and K head
passes a tile, the benchmark's own count) over the window, as a share of
the H100's dense bf16 peak, %."""

from h100bench.counts.model import serve_flops_per_tile
from h100bench.counts.peaks import PEAK_BF16


def read(run):
    if run.entry != "serve" or run.trace is None:
        return None
    return (100.0 * run.tiles * serve_flops_per_tile(run.cell.config)
            / run.window_s / PEAK_BF16)

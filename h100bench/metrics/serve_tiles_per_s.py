"""Tiles whose mean and uncertainty reached host memory inside the window,
over the window (host clock)."""


def read(run):
    if run.entry != "serve":
        return None
    return run.tiles / run.window_s

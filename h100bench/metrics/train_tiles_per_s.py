"""Tiles of every training step of the window over the window, which ends
in a synchronize (host clock)."""


def read(run):
    if run.entry != "train":
        return None
    return run.tiles / run.window_s

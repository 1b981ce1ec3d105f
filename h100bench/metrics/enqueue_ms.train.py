"""Median host time of one call into the train entry, from the call to its
return (the copy of the tiles to the card included), in ms."""

import statistics


def read(run):
    if run.entry != "train" or not run.call_s:
        return None
    return statistics.median(run.call_s) * 1e3

"""Operation, byte and FLOP counts of the port's kernels and models, kept
with the benchmark so that a change to the program cannot change its
yardstick. Each kernel file names the wrapper it counts (``TARGET``) and
gives the least time of one call from the call's arguments."""

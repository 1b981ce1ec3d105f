"""Device ms a serve item (request or step) of the kernels that no port
kernel wrapper launched: the library layers (cuDNN, cuBLAS, BatchNorm,
pools, elementwise passes, the optimizer), from the device trace."""


def read(run):
    if run.entry != "serve" or run.trace is None or not run.items:
        return None
    return run.trace.library_s / run.items * 1e3

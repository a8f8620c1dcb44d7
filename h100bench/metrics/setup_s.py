"""Set-up time: from the process's start to the first timed call (imports,
the CUDA context, the kernels' build or its cache, weights and inputs made
on the device from the seed, every shape of the window warmed up)."""


def read(run):
    return run.setup_s

"""From the process's start to the first timed request: imports, the CUDA
context, the kernels, the inputs and the warm requests."""


def read(run):
    return run.setup_s
